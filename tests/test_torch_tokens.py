"""The port's bearer tokens (`api/tokens.py`) against the JAX package's.

- JAX's own tests/test_token_lifecycle.py runs against the port, every
  case, its imports pointed at the port: expiry, rotation under an
  in-flight watch, revocation when a Profile is deleted, the token file.
- The token file is one format: a registry saved by either package
  loads in the other with the same identities, expiries and
  revocations, and a seeded sequence of issue, add, rotate, revoke,
  revoke_user and revoke_namespace leaves the same answers in both.
- The revocation rides the port's Profile finalizer: a Profile deleted
  with its finalizer pending keeps its tokens until the profile
  controller clears it.
"""

import random
import re
import time
from pathlib import Path

import pytest

from kubeflow_tpu.api.tokens import TokenRegistry as JTokenRegistry
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.tokens import TokenRegistry, service_account
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str, patches=()) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_token_lifecycle")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_token_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 8


def _sequence(registry_cls, seed: int, path) -> list:
    """A seeded run of registry operations on caller-chosen tokens (the
    minted ones are random): the answers after each, then the file."""
    rng = random.Random(seed)
    reg = registry_cls()
    reg.autosave(str(path))
    users = ["alice", service_account("team", "default-editor"),
             service_account("team", "default-viewer"), service_account("prod", "x")]
    answers = []
    for i in range(25):
        op = rng.choice(["add", "add", "revoke", "revoke_user", "revoke_namespace"])
        if op == "add":
            expires = rng.choice([None, time.time() + 3600, time.time() - 1])
            reg.add(f"kt-{i}", rng.choice(users), expires_at=expires)
        elif op == "revoke":
            reg.revoke(f"kt-{rng.randrange(i + 1)}")
        elif op == "revoke_user":
            answers.append(reg.revoke_user(rng.choice(users)))
        else:
            answers.append(reg.revoke_namespace(rng.choice(["team", "prod"])))
        answers.append([reg.authenticate(f"kt-{j}") for j in range(i + 1)])
        answers.append([reg.token_for(u) for u in users])
    return answers


@pytest.mark.parametrize("seed", range(6))
def test_registry_sequence_matches_jax(seed, tmp_path):
    assert _sequence(TokenRegistry, seed, tmp_path / "port") == \
        _sequence(JTokenRegistry, seed, tmp_path / "jax")
    # Both wrote the same token file.
    strip = [line.split(",")[:2] for line in (tmp_path / "port").read_text().splitlines()]
    assert strip == [line.split(",")[:2]
                     for line in (tmp_path / "jax").read_text().splitlines()]


@pytest.mark.parametrize("writer,reader", [(TokenRegistry, JTokenRegistry),
                                           (JTokenRegistry, TokenRegistry)])
def test_token_file_is_one_format(writer, reader, tmp_path):
    reg = writer()
    admin = reg.issue("system:admin")
    bounded = reg.issue(service_account("team", "default-editor"), ttl=3600)
    gone = reg.issue("mallory")
    reg.revoke(gone)
    reg.save(str(tmp_path / "tokens"))
    loaded = reader.load(str(tmp_path / "tokens"))
    assert loaded.authenticate(admin) == "system:admin"
    assert loaded.authenticate(bounded) == service_account("team", "default-editor")
    assert loaded.authenticate(gone) is None
    assert loaded.token_for("system:admin") == admin


def test_revocation_waits_for_the_profile_finalizer():
    """The port's store holds a Profile with a finalizer until the
    profile controller clears it: its tokens die with its DELETED, not
    with the delete request."""
    api = FakeApiServer()
    tokens = TokenRegistry()
    tokens.watch_profiles(api)
    ctl = ProfileController(api)
    api.create(new_resource("Profile", "team", "default",
                            spec={"owner": {"kind": "User", "name": "o@x.co"}}))
    ctl.controller.run_until_idle()
    sa_token = tokens.issue(service_account("team", "default-editor"))
    other = tokens.issue(service_account("prod", "default-editor"))
    api.delete("Profile", "team", "default")
    api.flush()
    assert api.get("Profile", "team", "default").metadata.deletion_timestamp is not None
    assert tokens.authenticate(sa_token) is not None
    ctl.controller.run_until_idle()
    api.flush()
    assert tokens.authenticate(sa_token) is None
    assert tokens.authenticate(other) == service_account("prod", "default-editor")
    api.close()
