"""The port's deploy server with one worker process per deployment
(`deploy/server.py` in process mode, `deploy/worker.py`), end to end on
this host.

- JAX's own tests/e2e/test_deploy_worker_e2e.py runs against the port,
  every case, its imports pointed at the port: a worker SIGKILLed in the
  middle of its apply is respawned and the deployment converges from
  its PlatformDeployment; killing one deployment's worker leaves the
  other's alone; a re-spec bumps the generation and is applied again; gc
  collects converged deployments. Its two pools name a `v5e` pool of
  2x2 chips and take an `h100` pool of 2x2 GPUs from the table in
  `kubeflow_tpu_torch/deploy/kfdef.py` (one host either way).
- The port's kill drill: ``KFTPU_WORKER_APPLY_DELAY`` holds a worker
  between its PLATFORM and K8S phases (JAX's worker sleeps before the
  apply), so a SIGKILL there finds the deployment Pending, the pool's
  Nodes written and no bundle object; the respawn converges with the
  same Nodes (their uids) and every bundle object.
- The server's process and its workers load no torch: the deploy tier
  runs on the CPU with the control plane, and a worker starts in well
  under a second.
- `python -m kubeflow_tpu_torch.deploy serve --worker-mode process`
  starts, takes a create over HTTP, reaches Ready and exits 0 on
  SIGTERM with its workers gone.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

from kubeflow_tpu_torch.deploy.kfdef import NodePool, PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import FakeCloud
from kubeflow_tpu_torch.deploy.server import DeployServer
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.web.wsgi import TestClient

REPO = Path(__file__).resolve().parents[1]

EDITS = [  # (JAX's text, the port's, occurrences)
    ('NodePool(name="pool-a", accelerator="v5e", topology="2x2")',
     'NodePool(name="pool-a", accelerator="h100", topology="2x2")', 1),
    ('{"name": "pool-b", "accelerator": "v5e", "topology": "2x2"}',
     '{"name": "pool-b", "accelerator": "h100", "topology": "2x2"}', 1),
]


def _jax_tests_on_the_port(relpath: str, edits=()) -> dict:
    """JAX's tests/<relpath> with `edits` made and `kubeflow_tpu.`
    pointed at the port: its test functions and fixtures."""
    path = REPO / "tests" / relpath
    src = path.read_text()
    for old, new, count in edits:
        assert src.count(old) == count, old
        src = src.replace(old, new)
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": "port_test_deploy_worker_e2e", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("e2e/test_deploy_worker_e2e.py", EDITS)
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_worker_e2e_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 4


def loads_torch(pid: int) -> bool:
    """Whether the live process `pid` has torch's shared library mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)


def test_worker_processes_load_no_torch():
    api = FakeApiServer()
    srv = DeployServer(api, FakeCloud(api), worker_mode="process")
    try:
        client = TestClient(srv)
        spec = PlatformSpec(name="kf-light", node_pools=[NodePool(name="gpu", topology="1")],
                            applications=["namespace", "tpujob-operator"]).to_dict()
        t0 = time.monotonic()
        assert client.post("/kfctl/apps/v1/create", spec).status == 200
        srv.wait_idle(timeout=60)
        took = time.monotonic() - t0
        worker = srv._workers["kf-light"]
        assert worker.alive() and not loads_torch(worker.proc.pid)
        assert api.get("PlatformDeployment", "kf-light", "").status["phase"] == "Ready"
        assert took < 30.0, took
    finally:
        srv.shutdown_workers()


def test_sigkill_between_the_phases_respawns_and_applies_once(monkeypatch):
    from kubeflow_tpu_torch.deploy.bundles import bundle_resources
    from kubeflow_tpu_torch.deploy.provisioner import PLATFORM_LABEL

    monkeypatch.setenv("KFTPU_WORKER_APPLY_DELAY", "2.0")
    api = FakeApiServer()
    srv = DeployServer(api, FakeCloud(api), worker_mode="process")
    spec = PlatformSpec(name="kf-mid", node_pools=[NodePool(name="gpu", topology="2x8")],
                        applications=["namespace", "tpujob-operator"])

    def nodes() -> dict:
        return {n.metadata.name: n.metadata.uid for n in api.list(
            "Node", "", label_selector={PLATFORM_LABEL: "kf-mid"})}

    def bundle_objects() -> int:
        count = 0
        for r in bundle_resources(spec):
            try:
                api.get(r.kind, r.metadata.name, r.metadata.namespace)
            except NotFound:
                continue
            count += 1
        return count

    try:
        assert TestClient(srv).post("/kfctl/apps/v1/create", spec.to_dict()).status == 200
        worker = srv._workers["kf-mid"]
        deadline = time.monotonic() + 30
        while not nodes() and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.5)  # the hold keeps the worker between the phases
        os.kill(worker.proc.pid, signal.SIGKILL)
        at_kill = nodes()
        assert api.get("PlatformDeployment", "kf-mid", "").status["phase"] == "Pending"
        assert sorted(at_kill) == ["kf-mid-gpu-0", "kf-mid-gpu-1"]
        assert bundle_objects() == 0
        srv.wait_idle(timeout=60)
        assert worker.respawns >= 1
        assert api.get("PlatformDeployment", "kf-mid", "").status["phase"] == "Ready"
        assert nodes() == at_kill
        assert bundle_objects() == len(bundle_resources(spec)) > 0
    finally:
        srv.shutdown_workers()


def test_serve_binary_in_process_mode(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.deploy", "serve", "--port", "0",
         "--worker-mode", "process"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("deploy-server: http://127.0.0.1:"), line
        base = line.split()[1]
        assert not loads_torch(proc.pid)
        spec = PlatformSpec(name="kf-bin", node_pools=[NodePool(name="gpu", topology="1")],
                            applications=["namespace"]).to_dict()
        req = urllib.request.Request(base + "/kfctl/apps/v1/create",
                                     data=json.dumps(spec).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
        deadline = time.monotonic() + 60
        phase = None
        while time.monotonic() < deadline and phase != "Ready":
            with urllib.request.urlopen(base + "/kfctl/apps/v1/status/kf-bin",
                                        timeout=30) as resp:
                phase = json.loads(resp.read())["status"].get("phase")
            time.sleep(0.1)
        assert phase == "Ready"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
