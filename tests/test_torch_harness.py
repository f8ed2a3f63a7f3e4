"""The port's readiness harness (`testing/e2e_util.py`) against the JAX
package's.

- JAX's own tests/test_harness.py runs against the port, every case, its
  imports pointed at the port.
- Parity: `kf_is_ready` and `missing_deployments` give JAX's answers on
  stores holding the same subsets of the platform, `junit_xml` writes
  JAX's bytes, `run_with_retry` and `wait_for` make JAX's calls and
  sleeps, `NotebookLoadTest` leaves JAX's objects (but the notebook
  image, the port's CPU image where JAX's is its JAX one) and
  `DeployProber` exposes JAX's metric names and values.
- One probe round over HTTP: a thread-mode `DeployServer` behind the
  port's server and a urllib client, as chip_smoke's deploy phase runs
  it against the process-mode server.
"""

import json
import re
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from kubeflow_tpu.controllers.notebook import NotebookController as JNotebookController
from kubeflow_tpu.deploy import apply as japply
from kubeflow_tpu.deploy import kfdef as jkfdef
from kubeflow_tpu.deploy import provisioner as jprov
from kubeflow_tpu.testing import e2e_util as jutil
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.deploy import apply as papply
from kubeflow_tpu_torch.deploy import kfdef as pkfdef
from kubeflow_tpu_torch.deploy import provisioner as pprov
from kubeflow_tpu_torch.deploy.server import DeployServer
from kubeflow_tpu_torch.testing import e2e_util as util
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import serve

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_harness")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_harness_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 9


@pytest.mark.parametrize("apps", [[], ["namespace", "tpujob-operator"],
                                  ["study-controller", "centraldashboard", "admission-webhook"],
                                  None])
def test_readiness_equals_jax(apps):
    api, japi = FakeApiServer(), JFakeApiServer()
    spec, jspec = pkfdef.default_spec("kf"), jkfdef.default_spec("kf")
    if apps is not None:
        spec.applications = jspec.applications = apps
    papply.apply_platform(spec, api, pprov.FakeCloud(api))
    japply.apply_platform(jspec, japi, jprov.FakeCloud(japi))
    assert util.kf_is_ready(api) == jutil.kf_is_ready(japi)
    assert util.missing_deployments(api) == jutil.missing_deployments(japi)
    assert util.missing_deployments(api, ["centraldashboard", "nope"]) == \
        jutil.missing_deployments(japi, ["centraldashboard", "nope"])


def test_junit_xml_equals_jax():
    rows = [("a", 1.5, None), ("b<&>", 0.0004, 'x "y" <z>'), ("c", 12.25, "")]
    got = util.junit_xml("suite & co", [util.TestResult(*r) for r in rows])
    assert got == jutil.junit_xml("suite & co", [jutil.TestResult(*r) for r in rows])


@pytest.mark.parametrize("fail_times,retries", [(0, 3), (2, 3), (3, 3), (5, 2)])
def test_run_with_retry_equals_jax(fail_times, retries):
    def run(mod):
        calls, slept = [], []

        def fn():
            calls.append(1)
            if len(calls) <= fail_times:
                raise KeyError(len(calls))
            return len(calls)

        try:
            out = mod.run_with_retry(fn, retries=retries, delay_seconds=0.5, backoff=3.0,
                                     exceptions=(KeyError,), sleep=slept.append)
        except KeyError as e:
            out = ("raised", e.args)
        return out, slept

    assert run(util) == run(jutil)


def test_wait_for_equals_jax():
    def run(mod):
        t, polls = {"now": 0.0}, []

        def pred():
            polls.append(t["now"])
            return t["now"] >= 7.0

        mod.wait_for(pred, timeout_seconds=30, poll_seconds=2.5, clock=lambda: t["now"],
                     sleep=lambda s: t.__setitem__("now", t["now"] + s))
        return polls

    assert run(util) == run(jutil)


def test_notebook_loadtest_equals_jax_but_the_image():
    api, japi = FakeApiServer(), JFakeApiServer()
    util.NotebookLoadTest(api).spawn(3)
    jutil.NotebookLoadTest(japi).spawn(3)
    NotebookController(api).controller.run_until_idle()
    JNotebookController(japi).controller.run_until_idle()
    got = [n.spec for n in api.list("Notebook", "loadtest")]
    want = [n.thaw().spec for n in japi.list("Notebook", "loadtest")]
    for spec in want:
        spec["template"]["spec"]["containers"][0]["image"] = \
            "kubeflow-tpu/torch-notebook:latest-cpu"
    assert got == want
    assert util.NotebookLoadTest(api).ready_count() == jutil.NotebookLoadTest(japi).ready_count()


def test_prober_metrics_equal_jax():
    class Down:
        def post(self, path, body=None):
            raise ConnectionError("down")

        def get(self, path):
            raise ConnectionError("down")

    def run(mod):
        prober = mod.DeployProber(Down(), clock=iter([0.0, 2.5, 10.0, 11.0]).__next__,
                                  sleep=lambda s: None)
        prober.probe_once({"metadata": {"name": "x"}})
        prober.probe_once({"metadata": {"name": "x"}})
        return prober.metrics.expose_text()

    assert run(util) == run(jutil)


class UrllibClient:
    """`DeployProber`'s client over HTTP: post/get returning objects with
    `status` and `json()`."""

    class Reply:
        def __init__(self, status: int, body: bytes):
            self.status, self.body = status, body

        def json(self):
            return json.loads(self.body)

    def __init__(self, base: str):
        self.base = base

    def _call(self, method, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return self.Reply(resp.status, resp.read())
        except urllib.error.HTTPError as e:
            return self.Reply(e.code, e.read())

    def post(self, path, body=None):
        return self._call("POST", path, body)

    def get(self, path):
        return self._call("GET", path)


def test_one_probe_round_over_http():
    api = FakeApiServer()
    deploy = DeployServer(api, pprov.FakeCloud(api))
    server, _ = serve(deploy, host="127.0.0.1", port=0)
    try:
        prober = util.DeployProber(UrllibClient(f"http://127.0.0.1:{server.server_port}"),
                                   timeout_seconds=30)
        spec = pkfdef.default_spec("probe")
        spec.node_pools = [pkfdef.NodePool(name="gpu", accelerator="h100", topology="1")]
        assert prober.probe_once(spec.to_dict())
        text = prober.metrics.expose_text()
        assert "deployment_service_status 1" in text
        assert "deployment_probe_failures_total 0" in text
        assert util.kf_is_ready(api) == []
        [node] = api.list("Node", "")
        assert node.spec["capacity"] == {"nvidia.com/gpu": 1}
        assert node.metadata.labels[pprov.ACCELERATOR_LABEL] == "nvidia-h100-80gb"
    finally:
        deploy.shutdown_workers()
        server.shutdown()
        server.server_close()
