"""JAX's gang e2e tests (tests/e2e/test_gang_e2e.py:24, :62, :136) on the
port: a TpuJob through the port's operator and local pod runner, whose
workers join one gloo process group on the CPU through the TPUJOB_*
contract. The bare gang sums over a dp mesh; the training gang trains a
tiny ResNet over dp (global batch norm, all-reduced gradients) and
rank 0's observation reaches the job through the secure facade; the
multi-slice gang agrees over a hybrid mesh of two slices. Each job has
120 s."""

import os
import sys
import time

from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.tpujob import KIND
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.runtime import LocalPodRunner
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One thread a worker: several processes share the host.
CPU_ENV = {"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _run(api, runner, ctl, name: str, timeout: float = 120.0) -> str:
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            ctl.controller.run_until_idle()
            runner.step()
            phase = api.get(KIND, name).status.get("phase")
            if phase in ("Succeeded", "Failed"):
                return phase
            time.sleep(0.2)
    finally:
        runner.shutdown()
    return api.get(KIND, name).status.get("phase")


def _worker(name: str) -> tuple:
    return (sys.executable, "-m", f"kubeflow_tpu_torch.testing.workers.{name}")


def _logs(tmp_path) -> dict:
    return {p.name: p.read_text() for p in (tmp_path / "logs").glob("*.log")}


def test_tpujob_gang_end_to_end(tmp_path):
    api = FakeApiServer()
    ctl = TpuJobController(api)
    runner = LocalPodRunner(api, cwd=REPO, extra_env=CPU_ENV,
                            capture_dir=str(tmp_path / "logs"))
    api.create(make_tpujob("e2e", replicas=2, tpu_chips_per_worker=0,
                           command=_worker("gang_worker")))
    phase = _run(api, runner, ctl, "e2e")
    logs = _logs(tmp_path)
    assert phase == "Succeeded", logs
    assert "psum ok (3.0)" in logs.get("e2e-worker-0.log", ""), logs
    assert "psum ok (3.0)" in logs.get("e2e-worker-1.log", ""), logs


def test_distributed_training_end_to_end(tmp_path, tls_paths):
    """A gang of 2 processes trains a tiny ResNet over a dp mesh, and rank
    0's observation flows back onto the job through the secure facade
    with a least-privilege worker token."""
    from kubeflow_tpu_torch.api.rbac import make_cluster_role, make_cluster_role_binding
    from kubeflow_tpu_torch.api.tokens import TokenRegistry, service_account
    from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
    from kubeflow_tpu_torch.web.wsgi import serve

    api = FakeApiServer()
    tokens = TokenRegistry()
    worker_user = service_account("default", "train-worker")
    api.create(make_cluster_role("train-worker", [
        {"verbs": ["get"], "resources": ["tpujobs"]},
        {"verbs": ["update"], "resources": ["tpujobs/status"]},
    ]))
    api.create(make_cluster_role_binding("train-worker", "train-worker", worker_user))
    server, _ = serve(ApiServerApp(api, tokens=tokens), host="127.0.0.1", port=0,
                      tls=tls_paths)
    ctl = TpuJobController(api)
    runner = LocalPodRunner(api, cwd=REPO, capture_dir=str(tmp_path / "logs"), extra_env={
        **CPU_ENV,
        "KFTPU_APISERVER": f"https://127.0.0.1:{server.server_port}",
        "KFTPU_TOKEN": tokens.issue(worker_user),
        "KFTPU_CA": tls_paths.ca_cert,
    })
    api.create(make_tpujob("train", replicas=2, tpu_chips_per_worker=0,
                           command=_worker("train_worker")))
    try:
        phase = _run(api, runner, ctl, "train")
    finally:
        server.shutdown()
    logs = _logs(tmp_path)
    job = api.get(KIND, "train")
    assert phase == "Succeeded", logs
    observation = job.status.get("observation") or {}
    assert observation.get("loss") is not None, (job.status, logs)
    assert observation["loss"] < observation["first_loss"], observation
    # Both ranks trained the one model: the same curve in both logs.
    curve = lambda log: [line.split(": ", 1)[1] for line in log.splitlines()
                         if line.startswith("rank ")]
    assert curve(logs["train-worker-0.log"]) == curve(logs["train-worker-1.log"]), logs


def test_multislice_gang_end_to_end(tmp_path):
    """A 2-slice x 2-process TpuJob: the operator injects the slice
    structure and all four processes agree over a hybrid mesh."""
    api = FakeApiServer()
    ctl = TpuJobController(api)
    runner = LocalPodRunner(api, cwd=REPO, extra_env=CPU_ENV,
                            capture_dir=str(tmp_path / "logs"))
    api.create(make_tpujob("ms", replicas=4, num_slices=2, tpu_chips_per_worker=0,
                           command=_worker("multislice_worker")))
    phase = _run(api, runner, ctl, "ms")
    logs = _logs(tmp_path)
    assert phase == "Succeeded", logs
    for rank in range(4):
        assert "hybrid psum ok (10.0)" in logs.get(f"ms-worker-{rank}.log", ""), logs


def test_lm_gang_job_survives_a_dead_rank(tmp_path):
    """The LM worker (`testing/workers/lm_job.py`, through the launcher)
    as a two-worker TpuJob at KFTPU_MESH dp = -1 on the CPU: rank 1
    SIGKILLs itself after step 2 once rank 0's save of it is committed;
    rank 0's next collective fails, the operator restarts the gang whole
    (maxRestarts 1), both ranks resume from rank 0's step 2 and the job
    ends Succeeded with restarts 1 and rank 0's observation. Both ranks
    log the same global loss at every step."""
    import json

    from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
    from kubeflow_tpu_torch.web.wsgi import serve

    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    ctl = TpuJobController(api)
    runner = LocalPodRunner(api, cwd=REPO, capture_dir=str(tmp_path / "logs"), extra_env={
        **CPU_ENV, "KFTPU_APISERVER": f"http://127.0.0.1:{server.server_port}"})
    env = {"KFTPU_CKPT_DIR": str(tmp_path / "ckpt"), "KFTPU_TOTAL_STEPS": "4",
           "KFTPU_SAVE_EVERY": "2", "KFTPU_KILL_AT_STEP": "2", "KFTPU_KILL_RANK": "1",
           "KFTPU_MESH": json.dumps({"dp": -1}),
           "KFTPU_LM_SIZE": json.dumps(dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2,
                                            head_dim=32, d_ff=128, batch=2, seq=64,
                                            dtype="float32", lr=1e-3))}
    api.create(make_tpujob(
        "lm-gang", replicas=2, tpu_chips_per_worker=0, max_restarts=1, env=tuple(env.items()),
        command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                 "kubeflow_tpu_torch.testing.workers.lm_job:main")))
    try:
        phase = _run(api, runner, ctl, "lm-gang")
    finally:
        server.shutdown()
    logs = _logs(tmp_path)
    job = api.get(KIND, "lm-gang")
    assert phase == "Succeeded", logs
    assert job.status.get("restarts") == 1, job.status
    obs = job.status["observation"]
    assert obs["resumed_from"] == 2.0 and obs["steps_done"] == 2.0, obs
    events = {r: [json.loads(line) for line in logs[f"lm-gang-worker-{r}.log"].splitlines()
                  if line.startswith('{"event"')] for r in range(2)}
    kills = [(r, e["step"]) for r in range(2) for e in events[r] if e["event"] == "kill"]
    assert kills == [(1, 2)], kills
    assert any(e["event"] == "failed" and e["incarnation"] == 0 for e in events[0]), logs
    losses = [{(e["incarnation"], e["step"]): e["loss"] for e in events[r]
               if e["event"] == "step"} for r in range(2)]
    assert sorted(losses[0]) == [(0, 1), (0, 2), (1, 3), (1, 4)], losses
    assert losses[0] == losses[1]
