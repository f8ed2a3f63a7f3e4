"""Worker-pod launcher.

Counterpart of `kubeflow_tpu/launcher/launcher.py` (a module with no JAX
in it). The TpuJob operator injects the TPUJOB_* env; the launcher
validates it and either execs and streams the user command, or, with
``--module``, starts `torch.distributed` in-process
(`parallel/distributed.initialize_from_env`, on the device KFTPU_DEVICE
names, CUDA when unset; a no-op for a gang of one)
and calls a Python entry point. `report_observation` and
`report_metrics` publish a job's final metrics and its training curve
onto the TpuJob's status, where the Study controller reads them.

Usage (the TpuJob operator sets this as the container command):

    python -m kubeflow_tpu_torch.launcher -- python train.py --flags...
    python -m kubeflow_tpu_torch.launcher --module mypkg.train:main
"""

from __future__ import annotations

import argparse
import importlib
import logging
import os
import subprocess
import sys
import time

from kubeflow_tpu_torch.parallel import distributed as dist

log = logging.getLogger(__name__)


def run_and_stream(cmd: list[str]) -> int:
    """Run `cmd`, streaming combined output line-by-line to our stdout
    (reference `launcher.py:31` run_and_stream)."""
    log.info("launching: %s", " ".join(cmd))
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    assert proc.stdout is not None
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
    return proc.wait()


def report_observation(
    api,
    job_name: str,
    namespace: str,
    metrics: dict[str, float],
) -> None:
    """Publish final metrics onto the TpuJob's `status.observation`.

    This is the trial-metric contract the Study controller harvests
    (`controllers/study.py`), in place of katib's log-scraping
    metrics-collector sidecar: process 0 calls this
    once at the end of training with e.g. ``{"loss": 0.12}``. `api` is
    anything with the FakeApiServer get/update_status surface (in-cluster:
    an HttpApiClient at the apiserver facade)."""
    from kubeflow_tpu_torch.testing.fake_apiserver import Conflict

    # Read-modify-write races with the operator's own status updates;
    # retry on Conflict — losing the observation would record a trained
    # trial as Failed.
    for attempt in range(10):
        job = api.get("TpuJob", job_name, namespace).thaw()
        observation = dict(job.status.get("observation") or {})
        observation.update({k: float(v) for k, v in metrics.items()})
        job.status["observation"] = observation
        try:
            api.update_status(job)
            break
        except Conflict:
            if attempt == 9:
                raise
            time.sleep(0.05 * (attempt + 1))
    log.info("reported observation %s for %s/%s", metrics, namespace, job_name)


def report_metrics(
    api,
    job_name: str,
    namespace: str,
    step: int,
    metrics: dict[str, float],
) -> None:
    """Publish one point of the training curve onto the TpuJob's
    `status.metrics` — the per-step companion of `report_observation`.

    The Study controller reads these curves to prune hopeless trials
    mid-run (katib's early-stopping/median-stop service consumed the same
    stream from its metrics collector; the reference only asserted
    StudyJob liveness, `testing/katib_studyjob_test.py:115-120`). Process
    0 calls this every eval interval with e.g. ``step=200,
    {"loss": 0.8}``. Points are append-only and step-ordered; a
    re-reported step overwrites its previous values (restart-after-resume
    re-emits the resumed step)."""
    from kubeflow_tpu_torch.testing.fake_apiserver import Conflict

    for attempt in range(10):
        job = api.get("TpuJob", job_name, namespace).thaw()
        curve = [
            dict(p)
            for p in job.status.get("metrics") or []
            if int(p.get("step", -1)) != step
        ]
        point = {"step": int(step)}
        point.update({k: float(v) for k, v in metrics.items()})
        curve.append(point)
        curve.sort(key=lambda p: p["step"])
        job.status["metrics"] = curve
        try:
            api.update_status(job)
            return
        except Conflict:
            if attempt == 9:
                raise
            time.sleep(0.05 * (attempt + 1))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-launcher")
    parser.add_argument(
        "--module",
        help="python entrypoint 'pkg.mod:fn' to call in-process after "
        "torch.distributed init (instead of exec-ing a command)",
    )
    parser.add_argument(
        "cmd", nargs="*", help="command to run (after --)"
    )
    args = parser.parse_args(argv)

    pe = dist.ProcessEnv.from_env()
    log.info(
        "gang member %d/%d (slice %d/%d) coordinator=%s",
        pe.process_id, pe.num_processes, pe.slice_id, pe.num_slices,
        pe.coordinator,
    )

    if args.module:
        # KFTPU_DEVICE names the gang's device ("cpu" for gloo); unset,
        # CUDA on the backend `choose_backend` picks for the layout.
        dist.initialize_from_env(device=os.environ.get("KFTPU_DEVICE") or None)
        mod_name, _, fn_name = args.module.partition(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name or "main")
        result = fn()
        dist.shutdown()
        return int(result or 0)

    if not args.cmd:
        parser.error("either --module or a command is required")
    # The child inherits the TPUJOB_* env as-is; it calls
    # initialize_from_env itself (same contract as TF_CONFIG pass-through).
    return run_and_stream(args.cmd)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
