"""The port's job plane end to end on the CPU: the controller-manager
binary (``python -m kubeflow_tpu_torch.controllers``) as its own
process against the apiserver facade, the local pod runner, the
launcher and the LM job worker (`testing/workers/lm_job.py`).

- The binary comes up against `ApiServerApp`, prints ``manager ready``,
  reconciles a TpuJob over HTTP into its gang, exits 0 on SIGTERM, and
  refuses an unknown controller, also beside the tenant controllers it
  now runs (profile, notebook, tensorboard).
- A TpuJob runs `lm_job` at a tiny LM (2 layers, d_model 64) on the CPU,
  one thread a worker, with the state and batch digests logged:
  SIGKILLed after step 3, once its step-2 checkpoint is committed; the
  operator restarts the gang as incarnation 1, which resumes in `fit()`
  from step 2 and finishes; the job ends Succeeded with ``restarts`` 1,
  ``resumed_from`` 2, and the first resumed step's loss bitwise equal to
  the killed run's.
- Priority preemption through the binary (``--leader-elect``, one
  replica) on a one-accelerator cluster model with a ResourceQuota of one
  GPU per tenant: a higher-priority TpuJob evicts a running LM job; the
  victim's worker honours the SIGTERM at a step boundary, saves, prints
  its ``preempted`` line and exits 0 without touching the job's
  ``status.observation``; the preemptor runs to Succeeded; the victim is
  placed again, resumes from the step its SIGTERM was honoured at, with
  ``status.restarts`` 0, and each of its steps is logged exactly once.
- The tiny LM job on an HA plane (two facade processes over one durable
  store, https, `JobPlane(ha_state_dir=...)`): the active facade is
  SIGKILLed mid-job, the standby takes over, and the job succeeds with
  ``restarts`` 0, one pod, and every step the worker saw acked in the
  final ``status.metrics``, in the live store and in a fresh store
  booted over the state directory once the plane is down.
- No module of the port's job plane imports JAX or the JAX package.

Every wait has a deadline (`JobPlane.run_until`) and every process is
reaped on every exit path.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
from kubeflow_tpu_torch.testing.job_plane import JobPlane

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32, d_ff=128,
            batch=2, seq=128, dtype="float32", lr=1e-2)


def test_binary_reconciles_over_http_and_exits_on_sigterm(tmp_path):
    with JobPlane(controllers=("tpujob", "study", "serving"),
                  capture_dir=str(tmp_path / "logs")) as plane:
        assert any(line == "manager ready tpujob,study,serving"
                   for line in plane.manager_output)
        plane.api.create(make_tpujob("hello", replicas=2, tpu_chips_per_worker=0,
                                     command=(sys.executable, "-c", "print('hi')")))
        plane.run_until(
            lambda: plane.api.get("TpuJob", "hello").status.get("phase") == "Succeeded",
            60, "the gang of two to succeed")
        assert len(plane.api.list("Pod", label_selector={LABEL_JOB: "hello"})) == 2
        assert plane.api.get("Service", "hello").spec["clusterIP"] == "None"
        assert plane.stop_manager() == 0


@pytest.mark.parametrize("names, message", [
    ("tpujob,notebook,jupyter", "unknown controllers"),
    ("tpujob,profile,nodehealth,kfam", "unknown controllers"),
    ("tpujob,bogus", "unknown controllers"),
])
def test_binary_refuses_unported_and_unknown_controllers(names, message):
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver",
         "http://127.0.0.1:9", "--controllers", names],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert message in out.stderr


def test_binary_takes_an_endpoint_list_and_a_ca(tmp_path):
    """``--apiserver https://dead,https://live --ca``: the binary's client
    pins the CA, fails over past the dead endpoint, reconciles a TpuJob
    over TLS, and on SIGTERM reports one failover."""
    import signal

    from kubeflow_tpu_torch.controllers.tpujob import register_admission
    from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
    from kubeflow_tpu_torch.web import tls
    from kubeflow_tpu_torch.web.wsgi import serve

    paths = tls.ensure_tls_dir(str(tmp_path / "tls"))
    api = FakeApiServer()
    register_admission(api)
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0, tls=paths)
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    endpoints = f"https://127.0.0.1:{dead},https://127.0.0.1:{server.server_port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver", endpoints,
         "--ca", paths.ca_cert, "--controllers", "tpujob"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert proc.stdout.readline().strip() == "manager ready tpujob"
        api.create(make_tpujob("over-tls", replicas=1, tpu_chips_per_worker=0,
                               command=(sys.executable, "-c", "pass")))
        import time
        deadline = time.monotonic() + 60
        while not api.list("Pod", label_selector={LABEL_JOB: "over-tls"}):
            assert time.monotonic() < deadline, "the binary never made the gang"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        server.shutdown()
        server.server_close()
    assert proc.returncode == 0, out
    client = json.loads(out.strip().splitlines()[-1].removeprefix("client "))
    assert client["failovers"] == 1 and client["handshakes"] >= 2
    assert server.tls_handshakes >= 1


def test_binary_refuses_https_without_a_ca():
    env = {k: v for k, v in os.environ.items() if k != "KFTPU_CA"}
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver",
         "https://127.0.0.1:9,https://127.0.0.1:10", "--controllers", "tpujob"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "KFTPU_CA" in out.stderr


def test_binary_builds_its_client_from_the_flags(monkeypatch, capsys):
    import threading
    import types

    from kubeflow_tpu_torch.controllers import __main__ as binary
    from kubeflow_tpu_torch.testing import apiserver_http
    from kubeflow_tpu_torch.utils import signals as sigutil

    built = []

    class Recorder(apiserver_http.HttpApiClient):
        def __init__(self, base_url, **kw):
            built.append((list(base_url), kw))
            super().__init__(base_url, **kw)

    stop = threading.Event()
    stop.set()  # a SIGTERM already delivered: start, then shut down
    monkeypatch.setattr(apiserver_http, "HttpApiClient", Recorder)
    monkeypatch.setattr(sigutil, "install_shutdown_handlers", lambda: stop)
    noop = types.SimpleNamespace(name="noop-controller", _queue=None)
    monkeypatch.setattr(binary, "CONTROLLERS", {"noop": lambda client: type(
        "C", (), {"controller": noop})()})
    monkeypatch.setattr("kubeflow_tpu_torch.controllers.runtime.ControllerManager.add",
                        lambda self, c: None)
    assert binary.main(["--apiserver", "http://127.0.0.1:1, http://127.0.0.1:2",
                        "--ca", "ca.pem", "--controllers", "noop"]) == 0
    # JAX's binary's client: its watch poll and retry, and the client
    # flags' defaults.
    defaults = {"ca": "ca.pem", "watch_poll_timeout": 2.0, "watch_retry": 0.1,
                "write_retries": 3, "breaker_cooldown": 2.0, "stream_reprobe_seconds": 60.0,
                "stream_failure_threshold": 3, "stream_degraded_seconds": 5.0}
    assert built == [(["http://127.0.0.1:1", "http://127.0.0.1:2"], defaults)]
    out = capsys.readouterr().out.splitlines()
    # Ready, the compiled tier's report at start and at exit, the client.
    assert out[0] == "manager ready noop" and out[3].startswith("client ")
    plane = {"workqueue": {"noop-controller": "custom"},
             "tpujob_gang_placements_total": {"native": 0, "python": 0, "custom": 0}}
    assert [json.loads(line[len("plane "):]) for line in out[1:3]] == [plane, plane]
    watch = {"stream_opens": 0, "stream_failures": 0, "longpoll_rounds": 0,
             "longpoll_rounds_degraded": 0, "degraded_episodes": 0,
             "streams_after_degraded": 0, "degraded_seconds": 0.0}
    assert json.loads(out[3][len("client "):]) == {"failovers": 0, "handshakes": 0,
                                                   "retries": 0, "watch": watch}
    assert binary.main(["--apiserver", "http://127.0.0.1:1", "--controllers", "noop",
                        "--write-retries", "5", "--breaker-cooldown", "0.3",
                        "--stream-reprobe", "7", "--stream-failure-threshold", "1",
                        "--stream-degraded", "1.5"]) == 0
    assert built[1] == (["http://127.0.0.1:1"], {
        **defaults, "ca": None, "write_retries": 5, "breaker_cooldown": 0.3,
        "stream_reprobe_seconds": 7.0, "stream_failure_threshold": 1,
        "stream_degraded_seconds": 1.5})


def _steps(log: str) -> list[dict]:
    out = []
    for line in log.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec["event"] in ("step", "kill", "start"):
                out.append(rec)
    return out


def test_lm_job_sigkilled_restarted_and_resumed_bitwise(tmp_path):
    env = {
        "KFTPU_DEVICE": "cpu",
        "KFTPU_CKPT_DIR": str(tmp_path / "ckpt"),
        "KFTPU_TOTAL_STEPS": "4",
        "KFTPU_SAVE_EVERY": "2",
        "KFTPU_KILL_AT_STEP": "3",
        "KFTPU_LM_SIZE": json.dumps(TINY),
        "KFTPU_DIGESTS": "1",
    }
    # One thread a worker: on a loaded host, at the default thread count,
    # the CPU kernels' parallel reductions can round a resumed step
    # differently while the restored state and the batch are bitwise
    # equal (their digests in the log); at one thread they do not.
    with JobPlane(capture_dir=str(tmp_path / "logs"),
                  extra_env={"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}) as plane:
        plane.api.create(make_tpujob(
            "lm-train", replicas=1, tpu_chips_per_worker=1, max_restarts=1,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items())))
        plane.run_until(
            lambda: plane.api.get("TpuJob", "lm-train").status.get("phase")
            in ("Succeeded", "Failed"), 100, "the LM job to finish")
        job = plane.api.get("TpuJob", "lm-train")
        assert job.status["phase"] == "Succeeded", plane.diagnostics()
        assert job.status["restarts"] == 1
        obs = job.status["observation"]
        assert obs["resumed_from"] == 2.0 and obs["steps_done"] == 2.0
        records = _steps(plane.pod_logs()["lm-train-worker-0.log"])
        by = {(r["event"], r.get("incarnation"), r.get("step")): r for r in records}
        killed = [r for r in records if r["event"] == "step" and r["incarnation"] == 0]
        resumed = [r for r in records if r["event"] == "step" and r["incarnation"] == 1]
        assert [r["step"] for r in killed] == [1, 2, 3]
        assert [r["step"] for r in resumed] == [3, 4]
        assert ("kill", 0, 3) in by
        # Step 3's loss is a forward from the restored step-2 state on the
        # repositioned stream: bitwise.
        assert resumed[0]["loss"] == killed[-1]["loss"], plane.diagnostics()
        assert obs["loss"] == resumed[-1]["loss"]
        # The curve in status holds the last report of every step.
        assert [p["step"] for p in job.status["metrics"]] == [1, 2, 3, 4]
        assert plane.stop_manager() == 0


def _records(log: str) -> list[dict]:
    return [json.loads(line) for line in log.splitlines() if line.startswith('{"event"')]


def test_lm_job_preempted_by_higher_priority_resumes_with_no_lost_step(tmp_path):
    TOTAL = 30
    def job(name, ns, priority, steps, save_every, step_sleep=0.0):
        env = {"KFTPU_CKPT_DIR": str(tmp_path / name), "KFTPU_TOTAL_STEPS": str(steps),
               "KFTPU_SAVE_EVERY": str(save_every), "KFTPU_LM_SIZE": json.dumps(TINY),
               "KFTPU_STEP_SLEEP_S": str(step_sleep)}
        return make_tpujob(
            name, namespace=ns, replicas=1, tpu_chips_per_worker=1, priority=priority,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items()))

    # lm-low is paced at >= 0.3 s a step, so the eviction lands mid-run
    # however loaded the host is; one thread a worker keeps it light.
    with JobPlane(controllers=(), capture_dir=str(tmp_path / "logs"),
                  extra_env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}) as plane:
        manager = plane.start_manager(("tpujob",), leader_elect=True, identity="m",
                                      wait_for="manager ready tpujob", timeout=60)
        plane.add_node("cpu-0", chips=1)
        for ns in ("team-a", "team-b"):
            plane.set_quota(ns, {"nvidia.com/gpu": 1})
        api = plane.api
        low_log = lambda: _records(plane.pod_logs().get("lm-low-worker-0.log", ""))  # noqa: E731
        api.create(job("lm-low", "team-a", 1, TOTAL, 10, step_sleep=0.3))
        plane.run_until(lambda: any(r["event"] == "step" and r["step"] >= 2 for r in low_log()),
                        120, "lm-low's step 2")
        api.create(job("lm-high", "team-b", 10, 4, 2))
        observed = {}

        def tick():
            for (ns, name, _), ev in plane.runner.evictions.items():
                if ns == "team-a" and ev["exit"] is not None and "at_exit" not in observed:
                    observed["at_exit"] = api.get("TpuJob", "lm-low", "team-a").status.get(
                        "observation")
                    observed["returncode"] = ev["returncode"]

        plane.run_until(
            lambda: {api.get("TpuJob", n, ns).status.get("phase")
                     for n, ns in (("lm-low", "team-a"), ("lm-high", "team-b"))}
            <= {"Succeeded", "Failed"}, 300, "both jobs to finish", tick=tick)
        low, high = api.get("TpuJob", "lm-low", "team-a"), api.get("TpuJob", "lm-high", "team-b")
        assert (low.status["phase"], high.status["phase"]) == ("Succeeded", "Succeeded"), \
            plane.diagnostics()
        assert low.status.get("restarts", 0) == 0 and high.status.get("restarts", 0) == 0
        # The victim's worker exited 0 at its preemption, and the job's
        # observation was untouched until the resumed run reported.
        assert observed == {"at_exit": None, "returncode": 0}, observed
        records = low_log()
        runs = sorted({r["pid"] for r in records}, key=lambda pid: min(
            r["time"] for r in records if r["pid"] == pid))
        assert len(runs) == 2
        preempted = [r for r in records if r["event"] == "preempted"]
        assert len(preempted) == 1 and preempted[0]["pid"] == runs[0]
        k = preempted[0]["step"]
        steps = [(r["pid"], r["step"]) for r in records if r["event"] == "step"]
        assert [s for pid, s in steps if pid == runs[0]] == list(range(1, k + 1))
        assert [s for pid, s in steps if pid == runs[1]] == list(range(k + 1, TOTAL + 1))
        obs = low.status["observation"]
        assert obs["resumed_from"] == float(k) and obs["steps_done"] == float(TOTAL - k)
        assert [p["step"] for p in low.status["metrics"]] == list(range(1, TOTAL + 1))
        # One eviction, named by the preemptor's event; lm-high never evicted.
        preempted_events = [e.spec["involvedObject"]["name"] for ns in ("team-a", "team-b")
                            for e in api.list("Event", ns) if e.spec["reason"] == "Preempted"]
        assert preempted_events == ["lm-low"]
        lowered = [e.spec["message"] for e in api.list("Event", "team-b")
                   if e.spec["reason"] == "PreemptedLowerPriority"]
        assert len(lowered) == 1 and lowered[0].endswith(": team-a/lm-low")
        assert len({uid for _, _, uid in plane.runner.evictions}) == 1
        assert manager.stop(timeout=60) == 0


def test_lm_job_rides_out_a_killed_active_facade(tmp_path):
    """The worker's step reports, the binary's watch and status writes
    and the runner's pod writes all fail over to the standby."""
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

    steps = 8
    env = {"KFTPU_CKPT_DIR": str(tmp_path / "ckpt"), "KFTPU_TOTAL_STEPS": str(steps),
           "KFTPU_SAVE_EVERY": str(steps), "KFTPU_LM_SIZE": json.dumps(TINY),
           "KFTPU_STEP_SLEEP_S": "0.3"}
    state = tmp_path / "state"
    with JobPlane(controllers=("tpujob",), capture_dir=str(tmp_path / "logs"),
                  ha_state_dir=str(state),
                  extra_env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                             "MKL_NUM_THREADS": "1"}) as plane:
        assert plane.url.count("https://") == 2 and plane.ca
        plane.api.create(make_tpujob(
            "lm-ha", replicas=1, tpu_chips_per_worker=1, max_restarts=1,
            command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                     "kubeflow_tpu_torch.testing.workers.lm_job:main"),
            env=tuple(env.items())))
        plane.run_until(lambda: len(plane.api.get("TpuJob", "lm-ha").status.get(
            "metrics", [])) >= 3, 120, "lm-ha's step 3 acked")
        killed = plane.active_facade()
        t_kill = plane.kill_active_facade()
        plane.run_until(
            lambda: plane.api.get("TpuJob", "lm-ha").status.get("phase")
            in ("Succeeded", "Failed"), 120, "lm-ha to finish")
        job = plane.api.get("TpuJob", "lm-ha")
        assert job.status["phase"] == "Succeeded", plane.diagnostics()
        assert job.status.get("restarts", 0) == 0
        assert len(plane.api.list("Pod", label_selector={LABEL_JOB: "lm-ha"})) == 1
        assert plane.active_facade() is not killed and killed.proc.returncode == -9
        records = _records(plane.pod_logs()["lm-ha-worker-0.log"])
        acked = {r["step"]: r for r in records if r["event"] == "acked"}
        losses = {r["step"]: r["loss"] for r in records if r["event"] == "step"}
        assert sorted(acked) == list(range(1, steps + 1))
        assert any(r["time"] > t_kill and r["failovers"] >= 1 for r in acked.values())
        assert {p["step"]: p["loss"] for p in job.status["metrics"]} == losses
        assert len({r["pid"] for r in records}) == 1
    # The WAL diff: every acked step is durable.
    restored = FakeApiServer(persist_dir=str(state / "store"))
    try:
        final = restored.get("TpuJob", "lm-ha")
        assert final.status["phase"] == "Succeeded"
        assert {p["step"]: p["loss"] for p in final.status["metrics"]} == losses
    finally:
        restored.close()


def test_job_plane_modules_import_no_jax():
    modules = [
        "kubeflow_tpu_torch.api.tpujob", "kubeflow_tpu_torch.api.study",
        "kubeflow_tpu_torch.native.scheduler", "kubeflow_tpu_torch.controllers.tpujob",
        "kubeflow_tpu_torch.controllers.study", "kubeflow_tpu_torch.controllers.__main__",
        "kubeflow_tpu_torch.runtime.local", "kubeflow_tpu_torch.launcher.launcher",
        "kubeflow_tpu_torch.utils.signals", "kubeflow_tpu_torch.testing.chaos",
        "kubeflow_tpu_torch.testing.job_plane",
        "kubeflow_tpu_torch.controllers.leader", "kubeflow_tpu_torch.controllers.quota",
        "kubeflow_tpu_torch.api.rbac", "kubeflow_tpu_torch.testing.workers.preempt_ha",
        "kubeflow_tpu_torch.testing.workers.lm_job",
        "kubeflow_tpu_torch.testing.workers.rl_trial",
    ]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kubeflow_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
