"""The port's tracing (`utils/tracing.py`, the request span in
`web/wsgi.py`, the reconcile span in `controllers/runtime.py`, the trace
header on `HttpApiClient`) against the JAX package's.

- JAX's own tests/test_tracing.py runs against the port, every case: its
  source with the imports pointed at the port.
- One scripted sequence of nested spans, errors, threads and a ring
  buffer overflow through both packages' `Tracer`s: the same names,
  attributes, errors, parent links (by position) and drop counts.
- Across threads and processes: a controller reconciling over an
  `HttpApiClient` on its worker thread, and the controller-manager
  binary in its own process, against the port's facade over HTTP: the
  facade's request spans carry each reconcile's trace id.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from kubeflow_tpu.utils import tracing as j_tracing
from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.utils import tracing
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_tracing")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_tracing_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 10


def _script(module) -> tuple[list, int]:
    """Nested spans, an error, a span per thread and an overflow of a
    ring of 5 through `module`'s Tracer: the finished spans with ids
    replaced by their order of appearance, and the drop count."""
    t = module.Tracer(capacity=5)
    with t.span("root", a=1):
        with t.span("child", b="x") as child:
            child.attributes["late"] = True
        with pytest.raises(ValueError):
            with t.span("fails"):
                raise ValueError("boom")

    def worker(i):
        with t.span("thread", i=i):
            pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
        th.join(timeout=10)
    with t.span("continued", trace_id="abc"):
        header = module.trace_header()
    spans = t.export()
    ids: dict = {}

    def norm(x):
        return None if x is None else ids.setdefault(x, len(ids))

    out = [(s["name"], s["attributes"], s["error"], norm(s["traceId"]), norm(s["parentId"]),
            s["durationMs"] >= 0) for s in sorted(spans, key=lambda s: s["name"])]
    return out + [header], t.dropped


def test_spans_match_jax():
    assert _script(tracing) == _script(j_tracing)
    assert tracing.HEADER == j_tracing.HEADER


@pytest.fixture
def facade():
    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    yield api, f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()
    api.close()


def _joined(spans) -> tuple[dict, dict]:
    """Reconcile spans of the tpujob controller by trace id, and the
    facade's request spans by trace id."""
    reconciles = {s["traceId"]: s for s in spans if s["name"] == "reconcile"
                  and s["attributes"].get("controller") == "tpujob-controller"}
    http: dict = {}
    for s in spans:
        if s["name"] == "http" and s["attributes"].get("app") == "apiserver":
            http.setdefault(s["traceId"], []).append(s)
    return reconciles, http


def test_reconcile_on_a_worker_thread_carries_its_trace_over_http(facade):
    """A controller over `HttpApiClient`, run on its own worker thread as
    the manager runs it: every reconcile's calls land in the facade as
    request spans of that reconcile's trace."""
    from kubeflow_tpu_torch.controllers.runtime import ControllerManager
    from kubeflow_tpu_torch.controllers.tpujob import TpuJobController

    api, url = facade
    client = HttpApiClient(url)
    manager = ControllerManager()
    manager.add(TpuJobController(client).controller)
    tracing.tracer.export()
    manager.start()
    try:
        api.create(make_tpujob("j", "team", replicas=2, tpu_chips_per_worker=0,
                               command=("true",)))
        deadline = time.time() + 30
        while time.time() < deadline and len(api.list("Pod", "team")) < 2:
            time.sleep(0.05)
        assert len(api.list("Pod", "team")) == 2
    finally:
        manager.stop()
        client.close()
    reconciles, http = _joined(tracing.tracer.export())
    keyed = {t: s for t, s in reconciles.items() if s["attributes"]["key"] == "team/j"}
    assert keyed
    assert all(t in http for t in keyed), "a reconcile whose calls left no request span"
    creates = [s for t in keyed for s in http[t]
               if s["attributes"]["method"] == "POST"
               and s["attributes"]["path"] == "/apis/Pod"]
    assert len(creates) == 2
    assert all(s["parentId"] is None for t in keyed for s in http[t])


def test_binary_reconciles_join_the_facade_request_spans(facade):
    """The controller-manager binary in its own process: the pod creates
    it makes for a TpuJob share their trace id with its other calls of
    the same reconcile (a request without the header starts a trace of
    its own)."""
    api, url = facade
    tracing.tracer.export()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver", url,
         "--controllers", "tpujob"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        line = proc.stdout.readline()
        assert line.startswith("manager ready"), line
        api.create(make_tpujob("j", "team", replicas=2, tpu_chips_per_worker=0,
                               command=("true",)))
        deadline = time.time() + 60
        while time.time() < deadline and len(api.list("Pod", "team")) < 2:
            time.sleep(0.05)
        assert len(api.list("Pod", "team")) == 2
    finally:
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0, out
    _, http = _joined(tracing.tracer.export())
    pod_traces = {t for t, spans in http.items() for s in spans
                  if s["attributes"]["method"] == "POST" and s["attributes"]["path"] == "/apis/Pod"}
    assert pod_traces
    assert all(len(http[t]) > 1 for t in pod_traces), \
        "a reconcile's pod create did not continue its trace"
    assert any(s["attributes"]["method"] == "GET" for t in pod_traces for s in http[t])
