"""The port's launcher (`kubeflow_tpu_torch/launcher/`), local pod runner
(`runtime/local.py`) and shutdown signals (`utils/signals.py`) against
the JAX package's.

`report_observation` and `report_metrics` leave a TpuJob's status equal
to what JAX's leave, through a store that answers Conflict to the first
writes (both retry); ``--module`` starts `torch.distributed` from the
TPUJOB_* env before it calls the entry point; a command is exec'd and
its output streamed. The runner execs pods as processes, mirrors their
phases, rewrites the coordinator per gang incarnation, appends a
restarted pod's log to its predecessor's, and terminates a deleted
pod's process.
"""

import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from kubeflow_tpu.api import make_tpujob as j_make_tpujob
from kubeflow_tpu.launcher import launcher as j_launcher
from kubeflow_tpu.testing.fake_apiserver import Conflict as JConflict
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.launcher import launcher
from kubeflow_tpu_torch.runtime import LocalPodRunner
from kubeflow_tpu_torch.testing.fake_apiserver import Conflict, FakeApiServer
from kubeflow_tpu_torch.utils import signals as sigutil

REPO = Path(__file__).resolve().parents[1]


class Conflicting:
    """A store whose first `conflicts` status writes raise Conflict (a
    racing writer), then pass through."""

    def __init__(self, api, error, conflicts: int):
        self.api, self.error, self.left = api, error, conflicts
        self.attempts = 0

    def get(self, *a, **kw):
        return self.api.get(*a, **kw)

    def update_status(self, obj):
        self.attempts += 1
        if self.left:
            self.left -= 1
            raise self.error("stale resourceVersion")
        return self.api.update_status(obj)


def _plain_status(api):
    return api.get("TpuJob", "j", "team").status


@pytest.mark.parametrize("conflicts", [0, 3])
def test_reports_leave_status_equal_jax(conflicts, monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)  # the retries' backoff
    sides = []
    for mod, store, make, error in ((j_launcher, JFakeApiServer, j_make_tpujob, JConflict),
                                    (launcher, FakeApiServer, make_tpujob, Conflict)):
        api = store()
        api.create(make("j", "team", replicas=1))
        racing = Conflicting(api, error, conflicts)
        mod.report_metrics(racing, "j", "team", 2, {"loss": 1.5})
        mod.report_metrics(racing, "j", "team", 1, {"loss": 2, "accuracy": 0.25})
        mod.report_metrics(racing, "j", "team", 2, {"loss": 1.25})  # a resumed re-report
        mod.report_observation(racing, "j", "team", {"loss": 0.5, "steps": 8})
        mod.report_observation(racing, "j", "team", {"return": 3})
        sides.append((_plain_status(api), racing.attempts))
    assert sides[1] == sides[0]
    status = sides[1][0]
    assert status["metrics"] == [{"step": 1, "loss": 2.0, "accuracy": 0.25},
                                 {"step": 2, "loss": 1.25}]
    assert status["observation"] == {"loss": 0.5, "steps": 8.0, "return": 3.0}


def test_reports_give_up_after_ten_conflicts(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    api = FakeApiServer()
    api.create(make_tpujob("j", "team"))
    racing = Conflicting(api, Conflict, 10)
    with pytest.raises(Conflict):
        launcher.report_observation(racing, "j", "team", {"loss": 1})
    assert racing.attempts == 10


def test_module_entry_point_runs_after_distributed_init(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(launcher.dist, "initialize_from_env",
                        lambda device=None: calls.append(("init", device)))
    mod = tmp_path / "entry_mod.py"
    mod.write_text("CALLS = None\n\ndef go():\n    CALLS.append('entry')\n    return 3\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import entry_mod

    entry_mod.CALLS = calls
    monkeypatch.setenv("KFTPU_DEVICE", "cpu")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "1")
    assert launcher.main(["--module", "entry_mod:go"]) == 3
    assert calls == [("init", "cpu"), "entry"]


def test_module_entry_point_through_the_binary_with_a_gloo_gang_of_one(tmp_path):
    (tmp_path / "entry2.py").write_text(textwrap.dedent("""
        import torch.distributed as dist

        def main():
            print("initialized", dist.is_initialized(), flush=True)
            return 0
    """))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{REPO}", KFTPU_DEVICE="cpu",
               TPUJOB_NUM_PROCESSES="1", TPUJOB_PROCESS_ID="0")
    out = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.launcher", "--module",
                          "entry2:main"], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "initialized False" in out.stdout  # a gang of one starts no group


def test_command_is_streamed_and_its_exit_code_returned(capsys):
    code = launcher.main(["--", sys.executable, "-c",
                          "import sys; print('line one'); print('line two'); sys.exit(4)"])
    assert code == 4
    assert capsys.readouterr().out.splitlines()[-2:] == ["line one", "line two"]
    with pytest.raises(SystemExit):
        launcher.main([])


def test_bad_gang_env_is_refused(monkeypatch):
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_PROCESS_ID", "5")
    with pytest.raises(ValueError, match="out of range"):
        launcher.main(["--", "true"])


# -- the local pod runner -------------------------------------------------


def _pod(name, cmd, env=(), labels=None):
    return new_resource("Pod", name, "default", spec={"containers": [{
        "name": "worker", "command": list(cmd),
        "env": [{"name": k, "value": v} for k, v in env]}]}, labels=labels or {})


def _step_until(runner, api, name, phases, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        runner.step()
        phase = api.get("Pod", name).status.get("phase")
        if phase in phases:
            return phase
        time.sleep(0.02)
    raise AssertionError(f"pod {name} still {api.get('Pod', name).status} after {timeout}s")


def test_runner_mirrors_exit_codes_and_rewrites_the_coordinator(tmp_path):
    api = FakeApiServer()
    runner = LocalPodRunner(api, extra_env={"EXTRA": "x"}, capture_dir=str(tmp_path))
    try:
        code = "import os; print(os.environ['TPUJOB_COORDINATOR'], os.environ['EXTRA'], "\
               "os.environ['N'])"
        labels = {"kubeflow-tpu.org/job": "g", "kubeflow-tpu.org/gang-incarnation": "0"}
        api.create(_pod("ok", [sys.executable, "-c", code],
                        env=[("TPUJOB_COORDINATOR", "g-worker-0.g.default.svc:8476"),
                             ("N", 7)], labels=labels))
        api.create(_pod("bad", [sys.executable, "-c", "raise SystemExit(3)"]))
        api.create(_pod("empty", []))
        assert _step_until(runner, api, "ok", ("Succeeded", "Failed")) == "Succeeded"
        assert _step_until(runner, api, "bad", ("Succeeded", "Failed")) == "Failed"
        assert api.get("Pod", "empty").status["phase"] == "Failed"
        log = Path(api.get("Pod", "ok").status["logPath"]).read_text().splitlines()
        assert log[0] == "--- pod ok incarnation 0 ---"
        host, _, rest = log[1].partition(":")
        assert host == "localhost" and rest.split()[1:] == ["x", "7"]
        # A restarted gang's pod of the same name appends to the log.
        api.delete("Pod", "ok")
        api.create(_pod("ok", [sys.executable, "-c", "print('second')"],
                        labels={**labels, "kubeflow-tpu.org/gang-incarnation": "1"}))
        _step_until(runner, api, "ok", ("Succeeded",))
        log = Path(api.get("Pod", "ok").status["logPath"]).read_text().splitlines()
        assert log[2:] == ["--- pod ok incarnation 1 ---", "second"]
    finally:
        runner.shutdown()
        api.close()


def test_runner_ignores_a_late_delete_of_a_pod_created_again():
    """A gang restart deletes a pod and creates it again under its name,
    and the store's watch events arrive late: the old pod's DELETED can
    land after the new pod's process has started. It must leave that
    process alone (terminated and untracked, the new pod would read
    Running for ever)."""
    api = FakeApiServer()
    runner = LocalPodRunner(api)
    try:
        api.create(_pod("w", [sys.executable, "-c", "pass"]))
        _step_until(runner, api, "w", ("Succeeded",))
        old = api.get("Pod", "w")
        api.delete("Pod", "w")
        api.flush()
        api.create(_pod("w", [sys.executable, "-c", "import time; time.sleep(60)"]))
        _step_until(runner, api, "w", ("Running",))
        runner._on_pod("DELETED", old)  # the old pod's event, delivered late
        assert runner.running_count() == 1 and not runner.evictions
        api.delete("Pod", "w")
        api.flush()
        assert runner.running_count() == 0 and len(runner.evictions) == 1
    finally:
        runner.shutdown()
        api.close()


def test_runner_terminates_a_deleted_pods_process():
    api = FakeApiServer()
    runner = LocalPodRunner(api)
    try:
        api.create(_pod("sleeper", [sys.executable, "-c", "import time; time.sleep(60)"]))
        _step_until(runner, api, "sleeper", ("Running",))
        assert runner.running_count() == 1
        proc = runner._procs[("default", "sleeper")]
        api.delete("Pod", "sleeper")
        api.flush()
        assert proc.wait(timeout=20) == -signal.SIGTERM
        assert runner.running_count() == 0
    finally:
        runner.shutdown()
        api.close()


def test_shutdown_signals_set_the_event():
    stop = sigutil.install_shutdown_handlers((signal.SIGUSR1,))
    try:
        threading.Timer(0.1, os.kill, (os.getpid(), signal.SIGUSR1)).start()
        t0 = time.monotonic()
        sigutil.wait_for_shutdown(stop, poll=0.05)
        assert stop.is_set() and time.monotonic() - t0 < 10
    finally:
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
