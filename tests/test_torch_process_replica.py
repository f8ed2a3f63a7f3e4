"""``spec.runtime: process``: the port's serving fleet as model-server
worker processes in replica mode.

A ServingDeployment with ``runtime: process`` becomes `python -m
kubeflow_tpu_torch.serving --apiserver URL --replica NAME` workers that
join over the HTTP facade (`ApiServerApp`), advertise their endpoints
through their ServingReplica objects, serve through the router as
`HttpReplica`s, load a new version themselves on a modelVersion push
(the process runtime has no roll surface), and are reaped when the CR
is deleted: tests/e2e/test_process_replica_e2e.py against the port,
with the workers put on the CPU by the caller (``device="cpu"``) and the
demo model. Then what the port adds: a SIGKILLed worker is respawned and
registered at its new endpoint only; the default spawn command asks for
no CPU, and a worker without a device on a machine without CUDA refuses
to start instead of serving from the CPU. The worker loop itself
(`sync_replica_once`, `run_replica`) runs JAX's tests in
tests/test_torch_serving_controller.py.

Each worker must be serving within 60 s; ports are taken as port 0.
The `cuda` test runs one worker on the GPU (skipped without one; no JAX
here, so on a GPU machine run it with ``--noconftest``).
"""

import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.serving import ProcessReplicaRuntime, Router
from kubeflow_tpu_torch.serving.__main__ import main as server_main
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_START_S = 60.0


def _drive(ctl, predicate, *, timeout=WORKER_START_S, what=""):
    """Reconcile-poll until the predicate holds (worker startup and
    status stamping are asynchronous; the controller converges on its
    resync)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ctl.controller.run_until_idle()
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def fleet():
    """A facade over a fresh store, a router and the process runtime,
    torn down (workers reaped) after the test."""
    made = []

    def make(device):
        api = FakeApiServer()
        server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
        url = f"http://127.0.0.1:{server.server_port}"
        router = Router()
        procs = ProcessReplicaRuntime(
            api, url, router=router, device=device, extra_env={"PYTHONPATH": REPO}
        )
        ctl = ServingDeploymentController(api, process_runtime=procs, resync_seconds=0.1)
        made.append((procs, server))
        return api, router, procs, ctl

    yield make
    for procs, server in made:
        procs.shutdown()
        server.shutdown()
        server.server_close()


def _ready(api, name, n):
    return lambda: api.get(serving_api.KIND, name, "default").status.get("readyReplicas") == n


def test_process_runtime_serves_rolls_and_reaps(fleet):
    api, router, procs, ctl = fleet("cpu")
    rname = serving_api.replica_name("pfleet", 0)
    api.create(serving_api.make_serving_deployment(
        "pfleet", model="demo", replicas=1, runtime="process"))
    _drive(ctl, _ready(api, "pfleet", 1), what="process replica ready")
    # The worker advertised a real endpoint and the runtime put it behind
    # the router as an HttpReplica.
    _drive(ctl, lambda: router.ready_names() == [rname], what="router registration")
    out = router.predict(np.zeros((2, 32, 32, 3), np.float32))
    assert np.asarray(out).shape == (2, 10)
    robj = api.get(serving_api.REPLICA_KIND, rname, "default")
    assert robj.status["pid"] == procs._procs[rname].pid
    first_pid = robj.status["pid"]

    # modelVersion bump: the controller pushes the new replica spec
    # through the object and the WORKER swaps the servable itself.
    dep = api.get(serving_api.KIND, "pfleet", "default").thaw()
    dep.spec = {**dep.spec, "modelVersion": 5}
    api.update(dep)

    def rolled():
        rows = api.get(serving_api.KIND, "pfleet", "default").status.get("replicas") or []
        return rows and rows[0]["version"] == 5 and rows[0]["ready"]

    _drive(ctl, rolled, what="worker self-roll to version 5")
    assert procs._procs[rname].pid == first_pid  # a hot swap, not a respawn
    assert np.asarray(router.predict(np.zeros((1, 32, 32, 3), np.float32))).shape == (1, 10)

    api.delete(serving_api.KIND, "pfleet", "default")
    proc = procs._procs[rname]
    _drive(ctl, lambda: procs.names() == [] and router.ready_names() == [],
           what="teardown reaps the worker")
    assert procs._procs == {}
    assert proc.wait(timeout=10) is not None


def test_killed_worker_is_respawned_at_its_new_endpoint(fleet):
    """SIGKILL a worker: its object still reads ready at the old
    endpoint, but the controller's resync finds the dead process, the
    runtime respawns it, and the router admits the new worker only once
    the new process stamped its own pid and endpoint."""
    api, router, procs, ctl = fleet("cpu")
    rname = serving_api.replica_name("kfleet", 0)
    api.create(serving_api.make_serving_deployment(
        "kfleet", model="demo", replicas=1, runtime="process"))
    _drive(ctl, lambda: router.ready_names() == [rname], what="first worker")
    old = procs._procs[rname]
    old_endpoint = api.get(serving_api.REPLICA_KIND, rname, "default").status["endpoint"]
    os.kill(old.pid, signal.SIGKILL)
    old.wait(timeout=10)

    def respawned():
        status = api.get(serving_api.REPLICA_KIND, rname, "default").status
        proc = procs._procs.get(rname)
        return (proc is not None and proc.pid != old.pid and status.get("pid") == proc.pid
                and router.ready_names() == [rname])

    _drive(ctl, respawned, what="the respawned worker")
    new = router.replica(rname)
    assert f"{new._host}:{new._port}" != old_endpoint
    assert np.asarray(router.predict(np.zeros((1, 32, 32, 3), np.float32))).shape == (1, 10)


def test_default_spawn_command_asks_for_no_cpu():
    """Workers run where the binary runs by default: CUDA. Only a caller
    that names a device passes one; no environment pin is added."""
    rspec = serving_api.replica_spec(serving_api.ServingDeploymentSpec(model="demo"))
    default = ProcessReplicaRuntime(None, "http://127.0.0.1:1")
    cmd = default.command("r0", rspec)
    assert cmd[:3] == [sys.executable, "-m", "kubeflow_tpu_torch.serving"]
    assert "--device" not in cmd and "cpu" not in cmd
    assert default._extra_env == {}
    cpu = ProcessReplicaRuntime(None, "http://127.0.0.1:1", device="cpu")
    assert cpu.command("r0", rspec)[-2:] == ["--device", "cpu"]


def test_spawn_command_carries_the_specs_batching():
    """A process worker batches as the CR says, like an in-process
    replica: ``maxBatch`` and ``batchTimeoutMs`` reach the binary's
    ``--max-batch`` and ``--batch-timeout-ms``."""
    spec = serving_api.ServingDeploymentSpec(model="demo", max_batch=16, batch_timeout_ms=7.5)
    cmd = ProcessReplicaRuntime(None, "http://127.0.0.1:1").command(
        "r0", serving_api.replica_spec(spec))
    flags = dict(zip(cmd[3::2], cmd[4::2]))
    assert flags["--max-batch"] == "16" and flags["--batch-timeout-ms"] == "7.5"


def test_worker_without_a_device_refuses_without_cuda(monkeypatch):
    """The binary in replica mode with no ``--device`` on a machine
    without CUDA raises when it builds its model; it does not serve from
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = FakeApiServer()
    api.create(new_resource(serving_api.REPLICA_KIND, "r0", spec={"model": "demo"}))
    server, thread = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            server_main([
                "--host", "127.0.0.1", "--port", "0", "--replica", "r0",
                "--apiserver", f"http://127.0.0.1:{server.server_port}",
            ])
        assert "ready" not in api.get(serving_api.REPLICA_KIND, "r0").status
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.cuda
def test_process_worker_on_the_gpu_serves_and_self_rolls(fleet):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the worker's default device")
    api, router, procs, ctl = fleet(None)
    rname = serving_api.replica_name("gfleet", 0)
    api.create(serving_api.make_serving_deployment(
        "gfleet", model="demo", replicas=1, runtime="process", model_version=1))
    _drive(ctl, lambda: router.ready_names() == [rname], what="GPU worker")
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    first = np.asarray(router.predict(x))
    dep = api.get(serving_api.KIND, "gfleet", "default").thaw()
    dep.spec = {**dep.spec, "modelVersion": 2}
    api.update(dep)

    def rolled():
        rows = api.get(serving_api.KIND, "gfleet", "default").status.get("replicas") or []
        return rows and rows[0]["version"] == 2 and rows[0]["ready"]

    _drive(ctl, rolled, what="GPU worker self-roll")
    again = np.asarray(router.predict(x))
    # The demo model's weights come from seed 0 at every version.
    np.testing.assert_allclose(again, first, rtol=1e-5, atol=1e-5)
    assert again.shape == (4, 10) and np.isfinite(again).all()
