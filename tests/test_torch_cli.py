"""The port's kubectl-style CLI (`cli.py`, ``python -m
kubeflow_tpu_torch.cli``) against the JAX package's.

- JAX's own tests/test_cli.py runs against the port, its imports (and
  the ``-m`` module of its subprocesses) pointed at the port and
  `google.com/tpu` read as `nvidia.com/gpu`; its logs case prints the
  port's process id variable (``TPUJOB_PROCESS_ID``: the port's pods
  carry no TPU_WORKER_ID). Every case runs, `test_get_at_api_version`
  (a read at v1alpha1) and `test_apply_invalid_create_surfaces_real_error`
  (a create at an unserved version) included, on the port's conversion.
  Besides: a read at a served version renders there, one at an unserved
  version is refused, and an invalid create surfaces the store's own
  refusal, not the fallback read's NotFound.
- One script of commands (get as a table, as YAML and JSON, describe,
  apply of a multi-document file creating and configuring, delete,
  top, logs, get of a missing object) against both packages' facades:
  the same exit codes and the same output, but for ids and clocks.
"""

import io
import re
import sys
from pathlib import Path

import pytest

from kubeflow_tpu import cli as j_cli
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.testing.apiserver_http import ApiServerApp as JApiServerApp
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web.wsgi import serve as j_serve
from kubeflow_tpu_torch import cli
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers import tpujob
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]
EXCLUDED: set[str] = set()


def _jax_tests_on_the_port(stem: str, patches=()) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port and
    the TPU resource read as the GPU: its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if (k.startswith("test_") and k not in EXCLUDED)
            or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_cli", patches=[
    ("os.environ['TPU_WORKER_ID']", "os.environ['TPUJOB_PROCESS_ID']")])
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_cli_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 23 - len(EXCLUDED)


def run(module, url, *argv, stdin=None):
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdout, sys.stderr, sys.stdin
    sys.stdout, sys.stderr = out, err
    if stdin is not None:
        sys.stdin = io.StringIO(stdin)
    try:
        rc = module.main(["--server", url, *argv])
    finally:
        sys.stdout, sys.stderr, sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def port_server():
    api = FakeApiServer()
    tpujob.register_admission(api)
    httpd, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    yield api, f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    httpd.server_close()
    api.close()


def test_a_read_at_another_version_is_refused(port_server):
    """A read at another served version renders there; one at an unserved
    version is refused, naming the served ones."""
    api, url = port_server
    api.create(new_resource("Notebook", "nb2", "team", spec={"image": "x"}))
    rc, out, err = run(cli, url, "get", "notebook", "nb2", "-n", "team",
                       "--api-version", "v1alpha1")
    assert rc == 0 and "apiVersion: kubeflow-tpu.org/v1alpha1" in out
    assert "containerImage: x" in out
    rc, out, _ = run(cli, url, "get", "notebook", "nb2", "-n", "team", "--api-version", "v1")
    assert rc == 0 and "image: x" in out
    rc, out, err = run(cli, url, "get", "notebooks", "--api-version", "v2")
    assert rc == 1 and "not served" in err and "v1alpha1" in err


def test_an_invalid_create_surfaces_the_stores_refusal(port_server):
    """A create the store refuses (the TpuJob admission's 422) is
    reported as such, not masked behind the fallback read's NotFound."""
    _, url = port_server
    doc = """
apiVersion: kubeflow-tpu.org/v1
kind: TpuJob
metadata: {name: bad, namespace: team}
spec: {replicas: 0}
"""
    rc, out, err = run(cli, url, "apply", "-f", "-", stdin=doc)
    assert rc == 1
    assert "not found" not in err
    assert "replicas" in err


DOCS = """
apiVersion: kubeflow-tpu.org/v1
kind: Notebook
metadata: {name: nb, namespace: team, labels: {app: nb}}
spec: {image: first}
---
apiVersion: kubeflow-tpu.org/v1
kind: PodDefault
metadata: {name: facade-env, namespace: team}
spec:
  selector: {}
  env: [{name: KFTPU_APISERVER, value: "https://127.0.0.1:8084"}]
"""
COMMANDS = [
    ("apply", "-f", "-"),
    ("apply", "-f", "-"),
    ("get", "notebooks", "-n", "team"),
    ("get", "nb", "nb", "-n", "team", "-o", "yaml"),
    ("get", "poddefaults", "-o", "json"),
    ("get", "nodes"),
    ("get", "node", "gpu-node-0"),
    ("describe", "notebook", "nb", "-n", "team"),
    ("describe", "node", "gpu-node-0"),
    ("top",),
    ("logs", "nope", "-n", "team"),
    ("logs", "job", "-n", "team", "--job"),
    ("delete", "pd", "facade-env", "-n", "team"),
    ("delete", "poddefault", "facade-env", "-n", "team"),
    ("delete", "poddefault", "facade-env", "-n", "team"),
    ("get", "tj"),
]
# Lines that hold ids or clocks.
VOLATILE = re.compile(r"uid|creationTimestamp|resourceVersion|Created:|\"rv\"")


def _script(module, store_cls, new, app_cls, serve_fn) -> list:
    api = store_cls()
    node = new("Node", "gpu-node-0", "", spec={"pool": "gpu", "chips": 1})
    node.status = {"ready": True, "tpuDutyCycle": 0.25, "cpuUtilization": 0.5}
    node = api.create(node)
    api.record_event(node, "NodeReady", "ready")
    api.create(new("Pod", "w0", "team", spec={
        "nodeName": "gpu-node-0",
        "containers": [{"name": "w", "resources": {"limits": {"nvidia.com/gpu": 1,
                                                             "google.com/tpu": 1}}}]}))
    httpd, _ = serve_fn(app_cls(api), host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{httpd.server_port}"
    out = []
    try:
        for i, argv in enumerate(COMMANDS):
            docs = DOCS.replace("first", "second") if i == 1 else DOCS
            rc, stdout, stderr = run(module, url, *argv, stdin=docs)
            stdout = [line for line in stdout.splitlines() if not VOLATILE.search(line)]
            out.append((argv, rc, stdout, stderr))
    finally:
        httpd.shutdown()
        api.close()
    return out


def test_cli_script_matches_jax():
    port = _script(cli, FakeApiServer, new_resource, ApiServerApp, serve)
    jax = _script(j_cli, JFakeApiServer, j_new_resource, JApiServerApp, j_serve)
    for got, want in zip(port, jax):
        assert got == want, got[0]
    top = port[COMMANDS.index(("top",))][2]
    assert "1/1" in top[1] and "25%" in top[1]
