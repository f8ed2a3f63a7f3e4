"""RL's study soak: a Study of real actor–learner trials under chaos.

Counterpart of the JAX package's `_run_rl_study_soak`
(`tests/e2e/test_rl_soak_e2e.py`, which `bench.py --workload rl` runs
as its phase B for ``rl_studies_per_hour``). The whole stack is
load-bearing at once: the Study controller suggesting trials, the
TpuJob operator ganging them (both in the controller-manager binary of
a `JobPlane`), the local pod runner exec'ing each trial
(`testing/workers/rl_trial.py`), and each trial running its own policy
fleet and guarded `fit()` learner, while the seeded `RLFaultSchedule`
kills a different layer in each victim trial: a serving replica
(heal), the learner process (resume), a whole trial before it trains
(reschedule).

The gate is zero lost studies: the Study lands Succeeded with every
trial scored; `coverage()`, counted from worker-reported evidence only,
shows every fault class fired; and each trial's TpuJob restarted as its
fault plan says (once for a trial or learner kill, never otherwise).

The JAX trials set ``tpu.chipsPerWorker: 0`` (they run on the CPU); the
port's ask for one GPU each, since their learner and fleet run on the
card (``device=None``), or on the CPU when `device` is ``"cpu"``.
"""

from __future__ import annotations

import sys
import time

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.study import KIND, ParameterSpec, StudySpec
from kubeflow_tpu_torch.controllers.study import trial_name
from kubeflow_tpu_torch.testing.chaos import (
    LEARNER_KILL,
    RL_FAULT_CLASSES,
    TRIAL_KILL,
    RLFaultSchedule,
)


def run_rl_study_soak(
    plane,
    workdir: str,
    *,
    seed: int,
    trials: int = 3,
    steps: int = 12,
    publish_every: int = 4,
    deadline_s: float = 240.0,
    device: str | None = None,
    name: str = "rl-sweep",
    tick=None,
) -> dict:
    """One chaos-gated RL study end to end on `plane` (a `JobPlane`
    running the study and tpujob controllers); `tick` is called at every
    poll. Returns the soak's metrics; raises AssertionError (with the
    manager's output and the pod logs) when a gate fails."""
    schedule = RLFaultSchedule(seed, trials=trials)
    env = {
        "KFTPU_RL_CHAOS_SEED": str(seed),
        "KFTPU_RL_TRIALS": str(trials),
        "KFTPU_RL_STEPS": str(steps),
        "KFTPU_RL_PUBLISH_EVERY": str(publish_every),
        "KFTPU_RL_WORKDIR": workdir,
    }
    if device is not None:
        env["KFTPU_DEVICE"] = device
    spec = StudySpec(
        parameters=(ParameterSpec("lr", "double", min=0.02, max=0.08, grid_points=trials),),
        objective_metric="return",
        goal="maximize",
        algorithm="grid",
        parallelism=2,
        trial_template={
            "replicas": 1,
            "image": "local",
            "command": [sys.executable, "-m", "kubeflow_tpu_torch.testing.workers.rl_trial"],
            "args": ["--lr", "${trialParameters.lr}"],
            "env": [{"name": k, "value": v} for k, v in env.items()],
            "tpu": {"chipsPerWorker": 1},
            # Every fault class costs its victim trial one gang restart
            # at most (SIGKILL -> whole-gang restart).
            "maxRestarts": 2,
        },
    )
    api = plane.api
    seen: dict[str, float] = {}
    done: dict[str, float] = {}

    def poll() -> None:
        now = time.monotonic()
        for job in api.list("TpuJob"):
            key = job.metadata.name
            seen.setdefault(key, now)
            if job.status.get("phase") in ("Succeeded", "Failed"):
                done.setdefault(key, now)
        if tick is not None:
            tick()

    api.create(new_resource(KIND, name, "default", spec=spec.to_dict()))
    t0 = time.monotonic()
    plane.run_until(
        lambda: api.get(KIND, name).status.get("phase") in ("Succeeded", "Failed"),
        deadline_s, f"study {name} to finish", tick=poll)
    elapsed = time.monotonic() - t0

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(f"rl soak: {what}\n{plane.diagnostics()}")

    study = api.get(KIND, name)
    check(study.status.get("phase") == "Succeeded", f"study status {study.status}")
    rows = study.status.get("trials") or []
    check(len(rows) == trials and all("objective" in r for r in rows),
          f"trial rows {rows}")
    per_trial = []
    publish_latency = 0.0
    for idx in range(trials):
        trial = api.get("TpuJob", trial_name(name, idx), "default")
        observation = trial.status.get("observation") or {}
        publish_latency = max(publish_latency,
                              float(observation.get("publish_latency_s", 0.0)))
        for cls in RL_FAULT_CLASSES:
            if observation.get(f"fault_{cls}"):
                schedule.mark_injected(cls)
        faults = [f.cls for f in schedule.for_trial(idx)]
        want_restarts = 1 if set(faults) & {TRIAL_KILL, LEARNER_KILL} else 0
        restarts = int(trial.status.get("restarts", 0) or 0)
        check(restarts == want_restarts,
              f"trial {idx} (faults {faults}) restarted {restarts} times, "
              f"want {want_restarts}")
        key = trial.metadata.name
        per_trial.append({
            "trial": idx, "faults": faults, "restarts": restarts,
            "return": float(observation.get("return", 0.0)),
            "seconds": done.get(key, time.monotonic()) - seen.get(key, t0),
            "worker_seconds": float(observation.get("seconds", 0.0)),
            "publish_latency_s": float(observation.get("publish_latency_s", 0.0)),
            "peak_memory_mib": observation.get("peak_memory_mib"),
        })
    coverage = schedule.coverage()
    missing = [c for c in RL_FAULT_CLASSES if coverage[c] < 1]
    check(not missing, f"fault classes with no worker-reported evidence: {missing} "
                       f"(coverage={coverage}, plan={schedule.plan})")
    best = study.status["bestTrial"]["objective"]
    check(best > 0, f"best return {best}")
    return {
        "seed": seed,
        "trials": trials,
        "steps": steps,
        "publish_every": publish_every,
        "elapsed_seconds": elapsed,
        "studies_per_hour": 3600.0 / elapsed,
        "coverage": coverage,
        "plan": [[f.cls, f.trial, f.at_fraction] for f in schedule.plan],
        "per_trial": per_trial,
        "returns": [t["return"] for t in per_trial],
        "publish_latency_s": publish_latency,
        "best_return": best,
    }
