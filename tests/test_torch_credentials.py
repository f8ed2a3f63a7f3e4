"""The port's cloud credential plumbing (`deploy/credentials.py`) against
the JAX package's.

- JAX's own tests/test_credentials.py runs against the port, every case,
  its imports pointed at the port. Its three pools name a `v5e` pool of
  2x4 chips (two hosts of 4), which has no GKE machine type in the
  port's GPU table; they take an `h100` pool of 4x4 GPUs (two hosts of
  8) from the table in `kubeflow_tpu_torch/deploy/kfdef.py`. That
  changes what `test_deploy_apply_gke_end_to_end`,
  `test_deploy_apply_gke_rejects_bad_token` and
  `test_node_pool_request_against_urllib_sender` send, not what they
  check.
- Parity: the token sources, the status classification of
  `AuthTransport` and `transport_from_flags` give JAX's answers on the
  same inputs.
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.deploy import credentials as jcred
from kubeflow_tpu.deploy import gke as jgke
from kubeflow_tpu_torch.deploy import credentials as cred
from kubeflow_tpu_torch.deploy import gke

REPO = Path(__file__).resolve().parents[1]

# (JAX's text, the port's, occurrences) in tests/test_credentials.py.
EDITS = [('accelerator="v5e", topology="2x4"', 'accelerator="h100", topology="4x4"', 3)]


def _jax_tests_on_the_port(stem: str, edits=()) -> dict:
    """JAX's tests/<stem>.py with `edits` made and `kubeflow_tpu.`
    pointed at the port: its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new, count in edits:
        assert src.count(old) == count, old
        src = src.replace(old, new)
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_credentials", EDITS)
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_credentials_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 20


@pytest.mark.parametrize("status", [200, 201, 204, 400, 401, 403, 404, 409, 429, 500, 503])
def test_status_classification_equals_jax(status):
    def sender(method, url, headers, body):
        return status, {"error": "x"} if status >= 400 else {"ok": url, "auth": headers}

    def outcome(mod, gke_mod):
        t = mod.AuthTransport(mod.StaticTokenSource("tok"), sender=sender,
                              api_base="http://127.0.0.1:1/v1")
        try:
            return ("ok", t.send(gke_mod.Request("POST", gke_mod.API_BASE + "/p", {"a": 1})))
        except mod.CloudError as e:
            return (type(e).__name__, str(e))

    assert outcome(cred, gke) == outcome(jcred, jgke)


@pytest.mark.parametrize("token", [("", None), ("t", None), ("t", 100.0), ("t", 159.0),
                                   ("t", 161.0), ("t", 1000.0)])
@pytest.mark.parametrize("now", [0.0, 100.0])
def test_token_validity_equals_jax(token, now):
    assert cred.Token(*token).valid_at(now) == jcred.Token(*token).valid_at(now)


def test_refreshable_source_sequence_equals_jax():
    def run(mod):
        clock = {"t": 0.0}
        fresh = iter([mod.Token("a", 100.0), mod.Token("b", 50.0), mod.Token("c", 500.0)])
        src = mod.RefreshableTokenSource(
            "proj", checker=lambda p, t: t.access_token != "bad",
            refresh_fn=lambda: next(fresh), clock=lambda: clock["t"])
        out = []
        for t, push in [(0.0, None), (10.0, None), (41.0, None), (41.0, "bad"),
                        (41.0, "pushed"), (45.0, None)]:
            clock["t"] = t
            try:
                if push:
                    src.refresh(mod.Token(push, 1000.0))
                    out.append(("refresh", push))
                else:
                    out.append(("token", src.token().access_token))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        return out

    assert run(cred) == run(jcred)


def test_transport_from_flags_equals_jax(tmp_path):
    token = tmp_path / "token"
    token.write_text("  secret\n")
    assert cred.transport_from_flags(None, None) is None
    for flags in [(str(token), None), (None, "http://h/v1/"), (str(token), "http://h/v1")]:
        got, want = cred.transport_from_flags(*flags), jcred.transport_from_flags(*flags)
        assert got.api_base == want.api_base
        assert got.source.token() == cred.Token(want.source.token().access_token,
                                                want.source.token().expiry)
