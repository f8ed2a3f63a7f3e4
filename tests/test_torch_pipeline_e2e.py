"""The nightly LM pipeline end to end on the CPU, through the port's
controller-manager binary.

A `JobPlane` runs ``python -m kubeflow_tpu_torch.controllers
--controllers tpujob,workflow`` against the apiserver facade, with the
local pod runner and ``KFTPU_DEVICE=cpu`` for every pod (one thread
each, beside the other test workers). Two Workflows
of `testing/workers/lm_pipeline.pipeline_spec` run side by side on a
tiny LM (2 layers, d_model 64):

- "promote": ``train``, a TpuJob slice step running `lm_job`, SIGKILLed
  after step 2 once that save is committed, restarted by the operator
  and resumed to step 4 (the DAG reads Restarting as in flight: one
  attempt); ``eval`` restores step 4 read-only and reads ``promote``;
  ``serve`` answers its requests over HTTP at version 4, bitwise equal
  to the restored module's forward; ``teardown`` removes the checkpoint
  directory; Succeeded.
- "hold": the same with ``max_eval_loss`` 0, so eval reads ``hold``,
  ``serve`` is Skipped and ``teardown`` still runs, once; Succeeded.

The binary also accepts ``workflow,cronworkflow`` beside every other
ported controller, and, with every controller of the JAX binary ported,
refuses none of them as unported: ``profile`` alone, and ``tensorboard``
beside the pipeline controllers, start. No module of the pipeline
imports JAX or the JAX package.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kubeflow_tpu_torch.api import make_tpujob, new_resource
from kubeflow_tpu_torch.controllers.workflow import LABEL_ATTEMPT, LABEL_WORKFLOW
from kubeflow_tpu_torch.testing.job_plane import JobPlane
from kubeflow_tpu_torch.testing.workers.lm_pipeline import pipeline_spec

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32, d_ff=128,
            batch=2, seq=128, dtype="float32", lr=1e-2)
REQUESTS = [("json", 1, 128), ("json", 3, 128), ("binary", 2, 61)]
RUNS = {"promote": 100.0, "hold": 0.0}  # max_eval_loss


class _Timeline:
    """What a stalled setup is named by: every change of a Workflow step,
    a TpuJob or a pod's phase, and every gap of more than a second
    between two polls of the test's own loop, each at its seconds since
    the plane started. The setup's failure prints it."""

    def __init__(self, plane):
        self.plane, self.last, self.rows = plane, {}, []
        self.polled = time.monotonic()

    def __call__(self) -> None:
        api, now = self.plane.api, time.time() - self.plane.started
        gap, self.polled = time.monotonic() - self.polled, time.monotonic()
        if gap > 1.0:
            self.rows.append(f"{now:9.3f} the poll loop stalled {gap:.3f} s")
        seen = {}
        for wf in api.list("Workflow", "default"):
            for name, step in wf.status.get("steps", {}).items():
                seen[f"Workflow {wf.metadata.name} {name}"] = (step.get("state"),
                                                                step.get("attempts"))
        for job in api.list("TpuJob", "default"):
            seen[f"TpuJob {job.metadata.name}"] = (job.status.get("phase"),
                                                   job.status.get("restarts"))
        for pod in api.list("Pod", "default"):  # a restart's pod has the name, not the uid
            seen[f"Pod {pod.metadata.name} {pod.metadata.uid[:8]}"] = pod.status.get("phase")
        for key, value in seen.items():
            if self.last.get(key) != value:
                self.last[key] = value
                self.rows.append(f"{now:9.3f} {key}: {value}")

    def __str__(self) -> str:
        return "\n".join([f"--- setup timeline (s since the plane started; manager ready "
                          f"after {self.plane.manager_ready_s:.3f} s) ---", *self.rows])


def _records(log: str) -> list[dict]:
    return [json.loads(line) for line in log.splitlines() if line.startswith('{"event"')]


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """Both Workflows run to their end on one plane: {run: (workflow,
    its TpuJobs, its pods by name, the pod logs, its checkpoint dir, the
    plane's diagnostics)}."""
    root = tmp_path_factory.mktemp("pipeline")
    job = make_tpujob("train", replicas=1, tpu_chips_per_worker=1, max_restarts=1,
                      command=(sys.executable, "-m", "kubeflow_tpu_torch.launcher",
                               "--module", "kubeflow_tpu_torch.testing.workers.lm_job:main"))
    with JobPlane(controllers=("tpujob", "workflow"), capture_dir=str(root / "logs"),
                  extra_env={"KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
                             "MKL_NUM_THREADS": "1"}) as plane:
        for run, limit in RUNS.items():
            spec = pipeline_spec(job.spec, steps=4, max_eval_loss=limit,
                                 ckpt_dir=str(root / run), save_every=2, kill_at=2,
                                 lm_size=TINY, requests=REQUESTS)
            plane.api.create(new_resource("Workflow", run, "default", spec=spec))
        timeline = _Timeline(plane)
        try:
            plane.run_until(
                lambda: all(plane.api.get("Workflow", run).status.get("phase")
                            in ("Succeeded", "Failed") for run in RUNS),
                150, "both pipelines to finish", tick=timeline)
        except (TimeoutError, RuntimeError) as err:
            raise type(err)(f"{err}\n{timeline}") from None
        out = {}
        for run in RUNS:
            out[run] = (
                plane.api.get("Workflow", run),
                plane.api.list("TpuJob", label_selector={LABEL_WORKFLOW: run}),
                {p.metadata.name: p
                 for p in plane.api.list("Pod", label_selector={LABEL_WORKFLOW: run})},
                plane.pod_logs(), root / run, plane.diagnostics())
        assert plane.stop_manager() == 0
    return out


def _train_checks(wf, jobs, logs, run):
    [job] = jobs
    assert job.metadata.name == f"{run}-train-0"
    assert job.metadata.labels[LABEL_ATTEMPT] == "0"
    assert job.status["phase"] == "Succeeded" and job.status["restarts"] == 1
    obs = job.status["observation"]
    assert obs["resumed_from"] == 2.0 and obs["steps_done"] == 2.0
    train = wf.status["steps"]["train"]
    assert (train["state"], train["attempts"], train["failedAttempts"]) == ("Succeeded", 1, [])
    assert json.loads(train["output"]) == obs
    steps = [(r["incarnation"], r["step"]) for r in _records(
        logs[f"{run}-train-0-worker-0.log"]) if r["event"] == "step"]
    assert steps == [(0, 1), (0, 2), (1, 3), (1, 4)]


def test_promote_trains_through_a_kill_evaluates_serves_and_tears_down(pipelines):
    wf, jobs, pods, logs, ckpt, diagnostics = pipelines["promote"]
    assert wf.status["phase"] == "Succeeded", diagnostics
    _train_checks(wf, jobs, logs, "promote")
    steps = wf.status["steps"]
    assert steps["eval"]["output"] == "promote"
    [ev] = [r for r in _records(logs["promote-eval-0.log"]) if r["event"] == "eval"]
    assert ev["step"] == ev["want_step"] == ev["observation_step"] == 4
    assert ev["loss"] <= ev["max_eval_loss"]
    assert json.loads(steps["serve"]["output"]) == {"version": 4, "answered": len(REQUESTS)}
    [sv] = [r for r in _records(logs["promote-serve-0.log"]) if r["event"] == "serve"]
    assert all(sv["checks"].values()) and sv["versions"] == [4]
    assert [r["bitwise"] for r in sv["requests"]] == [True] * len(REQUESTS)
    assert [r["bucket"] for r in sv["requests"]] == [1, 4, 2]
    assert {k: (v["state"], v["attempts"]) for k, v in steps.items()} == {
        "train": ("Succeeded", 1), "eval": ("Succeeded", 1), "serve": ("Succeeded", 1),
        "teardown": ("Succeeded", 1)}
    assert pods["promote-teardown-0"].status["output"] == "clean"
    assert not ckpt.exists()


def test_hold_skips_serve_and_still_tears_down_once(pipelines):
    wf, jobs, pods, logs, ckpt, diagnostics = pipelines["hold"]
    assert wf.status["phase"] == "Succeeded", diagnostics
    _train_checks(wf, jobs, logs, "hold")
    steps = wf.status["steps"]
    assert steps["eval"]["output"] == "hold"
    assert steps["serve"]["state"] == "Skipped" and steps["serve"]["attempts"] == 0
    assert "hold-serve-0" not in pods and "hold-serve-0.log" not in logs
    assert (steps["teardown"]["state"], steps["teardown"]["attempts"]) == ("Succeeded", 1)
    done = [r for r in _records(logs["hold-teardown-0.log"]) if r["event"] == "done"]
    assert [r["output"] for r in done] == ["clean"]
    assert not ckpt.exists()


def test_binary_runs_the_pipeline_controllers_beside_the_rest():
    names = ("tpujob", "study", "serving", "workflow", "cronworkflow")
    with JobPlane(controllers=names, run_pods=False) as plane:
        assert f"manager ready {','.join(names)}" in plane.manager_output
        assert plane.stop_manager() == 0


@pytest.mark.parametrize("names", ["profile",
                                   "workflow,cronworkflow,tensorboard,nodehealth"])
def test_binary_still_refuses_the_unported_controllers(names):
    """No controller is left unported: the sets the binary refused
    before the tenant controllers were ported now start and exit 0."""
    with JobPlane(controllers=tuple(names.split(",")), run_pods=False) as plane:
        assert f"manager ready {names}" in plane.manager_output
        assert not any("not yet ported" in line for line in plane.manager_output)
        assert plane.stop_manager() == 0


def test_pipeline_modules_import_no_jax():
    modules = ["kubeflow_tpu_torch.api.workflow", "kubeflow_tpu_torch.api.cron",
               "kubeflow_tpu_torch.controllers.workflow",
               "kubeflow_tpu_torch.controllers.cronworkflow",
               "kubeflow_tpu_torch.testing.workers.lm_pipeline"]
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'kubeflow_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
