"""One RL study trial: a real actor–learner loop, chaos self-delivered.

Counterpart of the JAX package's `tests/e2e/rl_trial_worker.py`. The RL
soak runs a Study whose trials exec

    python -m kubeflow_tpu_torch.testing.workers.rl_trial --lr <lr>

Each trial stands up the whole in-process RL stack: a
ServingDeployment-materialized policy fleet of 2 replicas (batching 8 /
1 ms) behind the router, actor threads rolling out through it, a stock
guarded `fit()` learner on the replay queue, and publication by
checkpoint, modelVersion bump and drain roll. It trains with the
learning rate it was assigned and reports its mean return as the study
objective over the apiserver facade (`report_observation`). The learner
and the fleet run on CUDA; ``KFTPU_DEVICE=cpu`` runs them on the CPU
(the tests), and without a GPU and without it the worker raises.

Chaos is self-derived, never transported: with KFTPU_RL_CHAOS_SEED set,
the worker rebuilds the soak's `RLFaultSchedule` from (seed, trials)
and looks up its own trial index (its TpuJob's trial label):

- ``trial_kill``: the first incarnation SIGKILLs itself before
  training; the gang restart reschedules the trial and the second
  incarnation reports the evidence.
- ``learner_kill``: a SIGKILL mid-fit, past the first publish (whose
  checkpoint is committed by then: the learner waits for each publish's
  save); the restarted incarnation resumes from it (``resumed_from``)
  and finishes the same trial.
- ``actor_kill``: a serving replica hard-killed mid-fit and removed from
  the router; the serving controller's resync re-ensures it while the
  actors retry through the router.

Evidence rides the observation (``fault_*`` fields): the soak counts
only what a worker reported happening. Other env: KFTPU_APISERVER (the
facade: one URL or an endpoint list, KFTPU_CA pinning https ones),
KFTPU_RL_TRIALS, KFTPU_RL_STEPS (18), KFTPU_RL_PUBLISH_EVERY
(6), KFTPU_RL_WORKDIR (each trial's checkpoints under
``trial-<index>``).
"""

from __future__ import annotations

import argparse
import math
import os
import signal
import sys
import time

REPLICAS = 2


def main(argv: list[str] | None = None) -> int:
    import torch

    from kubeflow_tpu_torch._device import resolve_device
    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
    from kubeflow_tpu_torch.controllers.study import LABEL_TRIAL
    from kubeflow_tpu_torch.launcher import report_observation
    from kubeflow_tpu_torch.rl import (
        EnvConfig, PolicyCheckpointPublisher, ReplayQueue, RLConfig, build_learner,
        run_actor_learner)
    from kubeflow_tpu_torch.serving.replica import LocalReplicaRuntime
    from kubeflow_tpu_torch.serving.router import Router
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.testing.chaos import (
        ACTOR_KILL, LEARNER_KILL, TRIAL_KILL, RLFaultSchedule)
    from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
    from kubeflow_tpu_torch.train import Checkpointer, Preempted

    parser = argparse.ArgumentParser()
    parser.add_argument("--lr", type=float, required=True)
    args = parser.parse_args(argv)

    t_start = time.time()
    device = resolve_device(os.environ.get("KFTPU_DEVICE") or None)
    study_api = HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"]))
    job_name, namespace = os.environ["TPUJOB_NAME"], os.environ["TPUJOB_NAMESPACE"]
    job = study_api.get("TpuJob", job_name, namespace)
    trial = int(job.metadata.labels[LABEL_TRIAL])
    restarts = int(job.status.get("restarts", 0) or 0)
    total_steps = int(os.environ.get("KFTPU_RL_STEPS", "18"))
    publish_every = int(os.environ.get("KFTPU_RL_PUBLISH_EVERY", "6"))

    fault = None
    if os.environ.get("KFTPU_RL_CHAOS_SEED"):
        sched = RLFaultSchedule(int(os.environ["KFTPU_RL_CHAOS_SEED"]),
                                trials=int(os.environ["KFTPU_RL_TRIALS"]))
        faults = sched.for_trial(trial)
        fault = faults[0] if faults else None

    evidence: dict[str, float] = {}
    if fault is not None and fault.cls == TRIAL_KILL:
        if restarts == 0:
            # Die before any training: the gang restart must reschedule
            # this trial from scratch.
            os.kill(os.getpid(), signal.SIGKILL)
        evidence["fault_trial_kill"] = 1.0

    workdir = os.path.join(os.environ["KFTPU_RL_WORKDIR"], f"trial-{trial}")
    ckpt_dir = os.path.join(workdir, "ckpt")
    os.makedirs(workdir, exist_ok=True)

    cfg = RLConfig(
        env=EnvConfig(seed=1000 + trial, obs_dim=8, n_actions=4, n_envs=8, horizon=3),
        hidden=16,
        learning_rate=args.lr,
        total_steps=total_steps,
        publish_every=publish_every,
        staleness_bound=2 * publish_every,
        n_actors=2,
    )
    trainer = build_learner(cfg, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # The policy fleet's control plane is in-process (the facade is the
    # study plane; a trial owns its serving stack as each learner owns
    # its actor fleet).
    fleet_api = FakeApiServer()
    router = Router()
    publisher = PolicyCheckpointPublisher(
        ckpt_dir, trainer.abstract_state, obs_dim=cfg.env.obs_dim,
        n_actions=cfg.env.n_actions, hidden=cfg.hidden, device=device)
    ctl = ServingDeploymentController(
        fleet_api, runtime=LocalReplicaRuntime(router, publisher))
    fleet_api.create(serving_api.make_serving_deployment(
        "pol", model="policy", replicas=REPLICAS, max_batch=8, batch_timeout_ms=1.0))
    ctl.controller.run_until_idle()

    ckpt = Checkpointer(ckpt_dir, save_interval_steps=cfg.publish_every)
    resumed_from = int(ckpt.latest_step() or 0)
    queue = ReplayQueue(capacity=cfg.replay_capacity, staleness_bound=cfg.staleness_bound,
                        device=trainer.device, stall_timeout_s=60)

    kill_at = None
    if fault is not None and fault.cls == LEARNER_KILL and restarts == 0:
        # Past the first publish (its checkpoint committed before the
        # publish), short of the end.
        kill_at = min(max(publish_every + 1, math.ceil(fault.at_fraction * total_steps)),
                      total_steps - 2)
    actor_kill_at = None
    if fault is not None and fault.cls == ACTOR_KILL and restarts == 0:
        actor_kill_at = min(max(2, math.ceil(fault.at_fraction * total_steps)),
                            total_steps - 2)
    actor_killed: list[str] = []

    def fault_hook(step: int) -> None:
        if kill_at is not None and step >= kill_at:
            os.kill(os.getpid(), signal.SIGKILL)
        if actor_kill_at is not None and step >= actor_kill_at and not actor_killed:
            ready = router.ready_names()
            if ready:
                name = ready[0]
                replica = router.replica(name)
                replica.kill()  # in-flight callers fail like a SIGKILL
                router.remove(name)
                actor_killed.append(name)

    try:
        result = run_actor_learner(
            api=fleet_api, deployment="pol", router=router, trainer=trainer,
            checkpointer=ckpt, queue=queue, cfg=cfg,
            reconcile=ctl.controller.run_until_idle, fault_hook=fault_hook)
    finally:
        ckpt.close()
    if isinstance(result.fit_result, Preempted):
        return 75

    # The healed fleet is part of the actor_kill evidence: the resync
    # must have brought the fleet back to the spec's strength.
    if actor_killed:
        deadline = time.time() + 10
        while time.time() < deadline and len(router.ready_names()) < REPLICAS:
            ctl.controller.run_until_idle()
            time.sleep(0.05)
        if len(router.ready_names()) >= REPLICAS:
            evidence["fault_actor_kill"] = 1.0
            evidence["healed_replicas"] = float(len(actor_killed))
    if fault is not None and fault.cls == LEARNER_KILL and restarts > 0 and resumed_from > 0:
        evidence["fault_learner_kill"] = 1.0
        evidence["resumed_from"] = float(resumed_from)

    observation = {
        "return": result.mean_return,
        "actor_steps": float(result.actor_steps),
        "stale_dropped": float(result.stale_dropped),
        "publishes": float(len(result.publishes)),
        "seconds": time.time() - t_start,
        **evidence,
    }
    if result.publish_latencies:
        observation["publish_latency_s"] = max(result.publish_latencies)
    if device.type == "cuda":
        observation["peak_memory_mib"] = torch.cuda.max_memory_allocated() / 2**20
    for name in router.replica_names():
        replica = router.replica(name)
        router.remove(name)
        replica.close()
    fleet_api.close()
    report_observation(study_api, job_name, namespace, observation)
    study_api.close()
    print(f"rl trial {trial} done lr={args.lr} return={result.mean_return:.3f} "
          f"restarts={restarts} evidence={sorted(evidence)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
