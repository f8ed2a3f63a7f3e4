"""The port's small apps (`apps/probe.py`, `apps/echo.py`,
`apps/cloud_metrics.py` over `deploy/gke.py`'s transport seam) against
the JAX package's.

- JAX's own prober and echo cases (tests/test_small_components.py; its
  two static config server cases run in test_torch_jupyter_app.py) and
  every case of tests/test_cloud_metrics.py run against the port, their
  imports pointed at the port.
- Both packages' Cloud Monitoring services, on one fixed clock, send the
  same `timeSeries.list` requests through a `RecordingTransport` for
  every metric, window and cluster, and parse the same points.
- Both echo apps reflect the same seeded requests, identity included.
- Both probers give the same /metrics text over one seeded health
  script, and each app's ``python -m`` entry point starts.
"""

import random
import re
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from kubeflow_tpu.apps.cloud_metrics import CloudMonitoringMetricsService as JService
from kubeflow_tpu.apps.echo import EchoApp as JEchoApp
from kubeflow_tpu.apps.probe import AvailabilityProber as JProber
from kubeflow_tpu.apps.probe import ProberApp as JProberApp
from kubeflow_tpu.deploy.gke import RecordingTransport as JRecordingTransport
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu_torch.apps.cloud_metrics import METRIC_TYPES, CloudMonitoringMetricsService
from kubeflow_tpu_torch.apps.echo import EchoApp
from kubeflow_tpu_torch.apps.probe import AvailabilityProber, ProberApp
from kubeflow_tpu_torch.deploy.gke import RecordingTransport
from kubeflow_tpu_torch.web import TestClient

REPO = Path(__file__).resolve().parents[1]
SMALL = {"test_prober_gauges_flip_with_target_health", "test_prober_survives_raising_probe",
         "test_prober_against_live_endpoint", "test_echo_reflects_request"}


def _jax_tests_on_the_port(stem: str, only=None) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions (those in `only`, if given) and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if (k.startswith("test_") and (only is None or k in only))
            or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = {**_jax_tests_on_the_port("test_small_components", only=SMALL),
             **_jax_tests_on_the_port("test_cloud_metrics")}
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_small_app_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 4 + 4


RESPONSE = {"timeSeries": [
    {"resource": {"labels": {"node_name": f"gpu-node-{n}"}},
     "points": [{"interval": {"endTime": f"2023-11-14T22:{m:02d}:00Z"},
                 "value": {"doubleValue": 0.5 + 0.01 * m} if m % 2 else {"int64Value": m}}
                for m in (12, 11, 14)]}
    for n in (1, 0)]}


@pytest.mark.parametrize("cluster", [None, "kf-prod"])
def test_cloud_metrics_requests_equal_jax(cluster):
    now = 1_700_000_000.0
    t_tr, j_tr = RecordingTransport({"/timeSeries": RESPONSE}), \
        JRecordingTransport({"/timeSeries": RESPONSE})
    svc = CloudMonitoringMetricsService(t_tr, "proj", cluster=cluster, now=lambda: now)
    jsvc = JService(j_tr, "proj", cluster=cluster, now=lambda: now)
    for metric in METRIC_TYPES:
        for minutes in (1, 5, 15, 60, 1440):
            assert svc.query(metric, minutes) == jsvc.query(metric, minutes)
    assert len(t_tr.requests) == len(j_tr.requests) == 3 * 5
    for got, want in zip(t_tr.requests, j_tr.requests):
        assert (got.method, got.url, got.body) == (want.method, want.url, want.body)
        assert got.to_json() == want.to_json()


def test_echo_equals_jax_on_seeded_requests():
    rng = random.Random(0)
    for i in range(20):
        headers = {"x-goog-authenticated-user-email": f"accounts.google.com:u{i}@x.co",
                   "x-extra": str(rng.random())}
        port, jax = TestClient(EchoApp(), headers=headers), JTestClient(JEchoApp(),
                                                                         headers=headers)
        path = "/" + "/".join(rng.choice(["a", "b", "deep", "x"]) for _ in range(3))
        path += f"?k={rng.randint(0, 9)}"
        method = rng.choice(["get", "post", "delete"])
        args = (path,) if method in ("get", "delete") else (path, {"n": i})
        got, want = getattr(port, method)(*args), getattr(jax, method)(*args)
        assert (got.status, got.json()) == (want.status, want.json()), (method, path)


def test_prober_metrics_equal_jax_on_a_health_script():
    rng = random.Random(1)
    health = {"ok": True}
    clock = {"t": 0.0}

    def tick():
        clock["t"] += 0.25
        return clock["t"]

    probers = [cls("http://target/healthz", probe=lambda url: health["ok"], clock=tick)
               for cls in (AvailabilityProber, JProber)]
    clients = [TestClient(ProberApp(probers[0])), JTestClient(JProberApp(probers[1]))]
    for _ in range(12):
        health["ok"] = rng.random() < 0.6
        answers = [p.probe_once() for p in probers]
        assert answers[0] == answers[1] == health["ok"]
        texts = [c.get("/metrics").body.decode() for c in clients]
        assert texts[0] == texts[1]
    assert "kubeflow_probe_failures_total" in texts[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_http(url: str, proc, timeout: float = 60.0) -> bytes:
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                return resp.read()
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise
            time.sleep(0.1)


def test_entry_points_serve():
    """``python -m`` starts the echo server and the prober (probing the
    echo server), as the JAX package's do."""
    echo_port, probe_port = _free_port(), _free_port()
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.apps.echo", str(echo_port)],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        body = _wait_http(f"http://127.0.0.1:{echo_port}/hello?x=1", procs[0])
        assert b'"path": "/hello"' in body or b'"path":"/hello"' in body
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.apps.probe", "--url",
             f"http://127.0.0.1:{echo_port}/healthz", "--interval", "0.2",
             "--port", str(probe_port)],
            cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        deadline = time.monotonic() + 60
        while True:
            text = _wait_http(f"http://127.0.0.1:{probe_port}/metrics", procs[1]).decode()
            if "kubeflow_availability{" in text:
                break
            assert time.monotonic() < deadline, text
            time.sleep(0.1)
        assert f'kubeflow_availability{{url="http://127.0.0.1:{echo_port}/healthz"}} 1' in text
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
