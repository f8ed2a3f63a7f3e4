"""The port's admission webhooks against the JAX package's: the store's
WebhookConfiguration callouts (`testing/fake_apiserver.py`) and the
standalone HTTPS mutating-admission server with its config object and
binary (`controllers/webhook.py`).

- JAX's own tests/test_webhook_admission.py runs against the port, its
  imports pointed at the port and `google.com/tpu` read as
  `nvidia.com/gpu`, every case (since PR 22 the native store's refusal
  too, on the port's `native/apiserver.NativeApiServer`).
  `test_webhook_mutates_on_create_and_update` writes into the frozen
  snapshot `create` returns, which both stores refuse
  (FrozenResourceError at tests/test_webhook_admission.py:61, one of
  the reference's known failures); on the port it takes a `.thaw()`
  copy first, and the reference test stays as it is.
- JAX's e2e tests/e2e/test_webhook_admission_e2e.py runs against the
  port: ``python -m kubeflow_tpu_torch.controllers.webhook --register``
  as its own process behind a secure facade, and the leader-elected
  pair's failover.
- The JAX store calling the port's webhook server mutates pods as it
  does calling JAX's (one protocol on both sides).
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import poddefault as j_poddefault
from kubeflow_tpu.controllers.webhook import MutatingWebhookApp as JMutatingWebhookApp
from kubeflow_tpu.controllers.webhook import make_webhook_config as j_make_webhook_config
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.controllers import poddefault
from kubeflow_tpu_torch.controllers.webhook import MutatingWebhookApp, make_webhook_config
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]
FROZEN_WRITE = '''        created.spec["containers"][0]["env"] = []  # client strips it
'''


def _jax_tests_on_the_port(rel: str, patches=()) -> dict:
    """JAX's tests/<rel>.py with `kubeflow_tpu.` pointed at the port and
    the TPU resource read as the GPU: its test functions and fixtures."""
    path = REPO / "tests" / f"{rel}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = {
    **_jax_tests_on_the_port("test_webhook_admission", patches=[(
        FROZEN_WRITE, "        created = created.thaw()\n" + FROZEN_WRITE)]),
    **_jax_tests_on_the_port("e2e/test_webhook_admission_e2e"),
}
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_webhook_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 19 + 2


def _pods_through(store_cls, new, module, app_cls, tls_paths) -> list:
    """Pods created in `store_cls` behind a webhook server of `app_cls`
    that runs the PodDefault mutator over a second store of PodDefaults."""
    source = store_cls()
    source.create(new(module.KIND, "proxy", "team", spec={
        "selector": {"matchLabels": {"inject": "yes"}},
        "env": [{"name": "HTTP_PROXY", "value": "http://proxy:80"}],
        "volumes": [{"name": "v", "emptyDir": {}}],
        "volumeMounts": [{"name": "v", "mountPath": "/v"}]}))
    server, _ = serve(app_cls(lambda obj, op: module.mutate_pod(source, obj)),
                      host="127.0.0.1", port=0, tls=tls_paths)
    try:
        api = store_cls()
        make_config = j_make_webhook_config if store_cls is JFakeApiServer \
            else make_webhook_config
        api.create(make_config("pd", f"https://127.0.0.1:{server.server_port}/mutate",
                               tls_paths.ca_cert))
        out = []
        for name, labels in (("hit", {"inject": "yes"}), ("miss", {"inject": "no"})):
            pod = api.create(new("Pod", name, "team", labels=labels,
                                 spec={"containers": [{"name": "w"}]}))
            out.append((pod.spec, dict(pod.metadata.annotations)))
        return out
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_jax_store_calls_either_webhook_alike(tls_paths, server_side):
    """The JAX store's callout protocol against the port's server, and
    the port's store against JAX's server: the same pods as JAX with
    JAX."""
    want = _pods_through(JFakeApiServer, j_new_resource, j_poddefault, JMutatingWebhookApp,
                         tls_paths)
    if server_side == "port":
        got = _pods_through(JFakeApiServer, j_new_resource, poddefault, MutatingWebhookApp,
                            tls_paths)
    else:
        from kubeflow_tpu_torch.api.objects import new_resource

        got = _pods_through(FakeApiServer, new_resource, j_poddefault, JMutatingWebhookApp,
                            tls_paths)
    assert got == want
