"""The local pod runner hands a GPU to a new pod only after a deleted
pod's process that held one has exited, as a kubelet does.

On the one-card host of chip_smoke's preempt phase, the operator places
a preemptor as soon as it evicts the victim, and the victim takes its
step, saves and exits over some 15 s: a runner that started the
preemptor at once let both hold the card (the card's memory at the
preemptor's first step read two workers' on a fast machine). Here a
victim pod that asks for ``nvidia.com/gpu`` and lingers 1.5 s after its
SIGTERM holds back a new GPU pod until it exits, while a pod that asks
for none starts at once. Each wait has 30 s."""

import sys
import time

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.runtime import LocalPodRunner
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

LINGER = ("import signal, sys, time\n"
          "signal.signal(signal.SIGTERM, lambda *a: (time.sleep(1.5), sys.exit(0)))\n"
          "print('up', flush=True)\n"
          "time.sleep(60)\n")


def _pod(name: str, cmd: list, gpus: int):
    limits = {"nvidia.com/gpu": gpus} if gpus else {}
    return new_resource("Pod", name, "default", spec={"containers": [{
        "name": "main", "image": "x", "command": cmd, "resources": {"limits": limits}}]})


def _wait(pred, what: str, runner, timeout: float = 30.0) -> float:
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        runner.step()
        time.sleep(0.02)
    return time.monotonic() - t0


def test_a_gpu_pod_waits_for_the_deleted_holder_to_exit(tmp_path):
    api = FakeApiServer()
    runner = LocalPodRunner(api, capture_dir=str(tmp_path))
    phase = lambda name: api.get("Pod", name).status.get("phase")
    try:
        api.create(_pod("victim", [sys.executable, "-c", LINGER], gpus=1))
        _wait(lambda: phase("victim") == "Running" and "up" in (
            tmp_path / "victim.log").read_text(), "the victim", runner)
        api.delete("Pod", "victim")
        api.create(_pod("preemptor", [sys.executable, "-c", "print('ran')"], gpus=1))
        api.create(_pod("cpu", [sys.executable, "-c", "print('ran')"], gpus=0))
        # The pod without a GPU does not wait; the GPU pod does.
        _wait(lambda: phase("cpu") == "Succeeded", "the cpu pod", runner)
        (key, eviction), = runner.evictions.items()
        assert eviction["exit"] is None and phase("preemptor") is None
        _wait(lambda: phase("preemptor") == "Succeeded", "the preemptor", runner)
        assert eviction["exit"] is not None and eviction["returncode"] == 0
        assert eviction["exit"] - eviction["sigterm"] >= 1.4
    finally:
        runner.shutdown()
        api.close()
