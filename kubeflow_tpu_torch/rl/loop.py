"""Actor–learner orchestrator: the Sebulba split on platform primitives.

Counterpart of `kubeflow_tpu/rl/loop.py`, on the port's router,
serving controller, `Trainer`, `fit()` and `Checkpointer`. The learner
trains on one device (CUDA unless the caller names another) and takes
no mesh: the bench's dp = 2 mesh only says how many ways the batch of a
trajectory divides, which one device does not need.

One `run_actor_learner` call couples three existing subsystems into one
RL run — nothing here reimplements them:

- **Actors** (threads) pull claim tickets from the `ReplayQueue`, roll
  episodes out through the SERVING stack — `Router.predict` into the
  continuous batcher, retrying 429s/replica deaths the way any client
  does — and push the trajectories back. The policy version each
  trajectory was acted with is read in-band from the servable's version
  column.
- **Learner** is a stock guarded `fit()` over the queue (loss_in_model
  REINFORCE, AnomalyGuard, checkpoint-resume; the queue speaks
  the train/data resumability protocol so all of that applies
  unchanged).
- **Publication** rides the CONTROL PLANE: at each publish boundary the
  learner waits for its checkpoint to commit, then bumps the
  ServingDeployment's ``spec.modelVersion``; the serving controller's
  drain-roll walks the fleet one replica at a time and actors observe
  the new version in their responses. publish→actor latency is the
  time from the CR bump to the first tagged response.

Actor-side code paths (`_actor_loop` here, `rollout` and
`sample_actions` in rl/env.py) are numpy-only — no torch, no device
sync; `tests/test_torch_rl.py` enforces it by AST.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np

from kubeflow_tpu_torch.rl.env import EnvConfig, VectorEnv, rollout
from kubeflow_tpu_torch.rl.replay import ReplayQueue

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """One actor–learner run (one study trial, or one bench phase)."""

    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    hidden: int = 32
    learning_rate: float = 0.05
    total_steps: int = 60
    # Learner steps between weight publications (also the checkpoint
    # save interval — a publish IS a committed checkpoint).
    publish_every: int = 20
    # Off-policy bound, in learner steps (versions are checkpoint
    # steps). The learner blocks rather than exceed it: two publish
    # intervals means a wedged roll stops the learner before it is two
    # publications ahead of what the fleet is serving.
    staleness_bound: int = 40
    n_actors: int = 2
    replay_capacity: int = 8

    @property
    def batch_size(self) -> int:
        return self.env.transitions_per_trajectory


@dataclasses.dataclass
class PublishRecord:
    version: int
    bumped_at: float
    observed_at: float | None = None

    @property
    def latency_s(self) -> float | None:
        if self.observed_at is None:
            return None
        return self.observed_at - self.bumped_at


@dataclasses.dataclass
class RLResult:
    fit_result: object
    actor_steps: int
    actor_steps_per_sec: float
    learner_steps_per_sec: float
    publishes: list[PublishRecord]
    mean_return: float
    final_loss: float
    predict_retries: int
    rejected_pushes: int
    stale_dropped: int
    trajectories: int

    @property
    def publish_latencies(self) -> list[float]:
        return [
            p.latency_s for p in self.publishes if p.latency_s is not None
        ]


def build_learner(cfg: RLConfig, *, guard=None, device=None):
    """The stock Trainer, configured for the in-model REINFORCE loss, on
    `device` (CUDA unless named; without CUDA and without a device it
    raises)."""
    from kubeflow_tpu_torch._device import resolve_device
    from kubeflow_tpu_torch.rl.policy import PolicyWithLoss
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    config = TrainConfig(
        batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate,
        warmup_steps=2,
        total_steps=cfg.total_steps,
        optimizer="adamw",
        fsdp_params=False,
        train_metrics="loss",
        label_smoothing=0.0,
        loss_in_model=True,
    )
    device = resolve_device(device)
    model = PolicyWithLoss(cfg.env.obs_dim, cfg.env.n_actions, cfg.hidden,
                           device=device)
    return Trainer(model, config, input_key="obs", label_key="target",
                   device=device, guard=guard)


def bump_model_version(api, name: str, namespace: str, version: int):
    """Publish: point the ServingDeployment at the new checkpoint step.
    The controller's drain-roll takes it from here."""
    from kubeflow_tpu_torch.api import serving as serving_api
    from kubeflow_tpu_torch.controllers.runtime import retry_on_conflict

    def write():
        dep = api.get(serving_api.KIND, name, namespace).thaw()
        if int(dep.spec.get("modelVersion") or 0) >= version:
            return
        spec = dict(dep.spec)
        spec["modelVersion"] = int(version)
        dep.spec = spec
        api.update(dep)

    retry_on_conflict(write)


class _RouterPolicy:
    """predict_fn for `rollout`: obs -> (logits, served version), with
    client-side retry on shed/unready — the router already retries
    replica death internally for idempotent requests."""

    def __init__(self, router, *, timeout_s: float = 60.0, on_version=None):
        self._router = router
        self._timeout_s = timeout_s
        self._on_version = on_version
        self.retries = 0

    def __call__(self, obs: np.ndarray):
        from kubeflow_tpu_torch.rl.policy import split_predictions
        from kubeflow_tpu_torch.serving.router import NoReadyReplicas, Overloaded

        deadline = time.monotonic() + self._timeout_s
        while True:
            try:
                out = self._router.predict(obs, idempotent=True)
                logits, version = split_predictions(np.asarray(out))
                if self._on_version is not None:
                    # Per-response, not per-trajectory: publish→actor
                    # latency is "first tagged response", and it must
                    # keep ticking even when the replay queue is full.
                    self._on_version(version)
                return logits, version
            except Overloaded as e:
                wait = getattr(e, "retry_after", 0.05)
            except NoReadyReplicas:
                wait = 0.05
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"policy fleet unavailable for {self._timeout_s:.0f}s"
                )
            self.retries += 1
            time.sleep(wait)


def _actor_loop(
    env,
    queue,
    predict_fn,
    stop,
    learner_done,
    publish_lock,
    returns,
    counters,
):
    """One actor thread: claim → rollout through serving → push.
    numpy + queue + predict_fn only (test-enforced: no torch in here)."""
    while not stop.is_set():
        index, salt = queue.claim()
        try:
            traj = rollout(env, predict_fn, index, salt=salt)
        except Exception:
            queue.abandon(index, salt)
            if stop.is_set():
                return
            time.sleep(0.05)
            continue
        with publish_lock:
            counters["actor_steps"] += traj.obs.shape[0] * traj.obs.shape[1]
            counters["trajectories"] += 1
            returns.append(traj.mean_return)
            del returns[:-50]
        if learner_done.is_set():
            # Nobody will consume it, and a blocking push here would
            # freeze the actor before it can observe the final roll.
            continue
        queue.push(index, salt, traj.policy_version, traj.transitions())


def run_actor_learner(
    *,
    api,
    deployment: str,
    router,
    trainer,
    checkpointer,
    queue: ReplayQueue,
    cfg: RLConfig,
    namespace: str = "default",
    reconcile=None,
    rng=None,
    fault_hook=None,
) -> RLResult:
    """Run one coupled actor–learner session to completion.

    ``reconcile`` (optional) is polled on a background thread — pass the
    serving controller's ``run_until_idle`` so CR bumps actually
    materialize into rolls; in a full controller-manager deployment the
    controller is already running and this stays None. ``fault_hook``
    (chaos, called with the step) runs at every learner log boundary,
    after the boundary's publish. May return a `Preempted` fit result;
    the caller resumes exactly like any other trainer (same checkpointer,
    same queue protocol).
    """
    from kubeflow_tpu_torch.train import Preempted, fit

    env = VectorEnv(cfg.env)
    stop = threading.Event()
    learner_done = threading.Event()
    publish_lock = threading.Lock()
    publishes: list[PublishRecord] = []
    returns: list[float] = []
    counters = {"actor_steps": 0, "trajectories": 0}

    def observe_version(version: int) -> None:
        now = time.monotonic()
        with publish_lock:
            for rec in publishes:
                if rec.observed_at is None and version >= rec.version:
                    rec.observed_at = now

    predict_fn = _RouterPolicy(router, on_version=observe_version)

    threads = [
        threading.Thread(
            target=_actor_loop,
            args=(env, queue, predict_fn, stop, learner_done,
                  publish_lock, returns, counters),
            name=f"rl-actor-{i}",
            daemon=True,
        )
        for i in range(cfg.n_actors)
    ]

    if reconcile is not None:
        def _reconcile_loop():
            while not stop.is_set():
                try:
                    reconcile()
                except Exception:
                    log.exception("serving reconcile failed; retrying")
                time.sleep(0.02)

        threads.append(
            threading.Thread(
                target=_reconcile_loop, name="rl-reconcile", daemon=True
            )
        )

    step_times: list[tuple[int, float]] = []
    last_loss = [float("nan")]

    def on_metrics(step: int, rec: dict) -> None:
        step_times.append((step, time.monotonic()))
        last_loss[0] = rec["loss"]
        queue.note_learner_step(step)
        if (
            step % cfg.publish_every == 0
            and checkpointer is not None
        ):
            # The save for this boundary is already enqueued (fit saves
            # before it logs); make it durable, then publish.
            checkpointer.wait()
            version = checkpointer.latest_step()
            if version:
                bump_model_version(
                    api, deployment, namespace, int(version)
                )
                with publish_lock:
                    publishes.append(
                        PublishRecord(int(version), time.monotonic())
                    )
        if fault_hook is not None:
            fault_hook(step)

    t0 = time.monotonic()
    for t in threads:
        t.start()
    try:
        result = fit(
            trainer,
            queue,
            cfg.total_steps,
            rng=rng,
            checkpointer=checkpointer,
            log_every=1,
            on_metrics=on_metrics,
        )
        learner_done.set()
        queue.drain_pushers()
        # Give the final publish a chance to be observed end-to-end (it
        # needs the controller roll plus one actor round trip).
        if not isinstance(result, Preempted):
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                with publish_lock:
                    if all(
                        p.observed_at is not None for p in publishes
                    ):
                        break
                time.sleep(0.05)
    finally:
        stop.set()
        queue.close()
        for t in threads:
            t.join(timeout=10.0)
    elapsed = max(time.monotonic() - t0, 1e-9)

    done_steps = step_times[-1][0] - step_times[0][0] if len(
        step_times
    ) > 1 else 0
    learner_sps = (
        done_steps / (step_times[-1][1] - step_times[0][1])
        if done_steps > 0
        else 0.0
    )
    with publish_lock:
        mean_return = (
            float(np.mean(returns[-20:])) if returns else 0.0
        )
        actor_steps = counters["actor_steps"]
        trajectories = counters["trajectories"]
    return RLResult(
        fit_result=result,
        actor_steps=actor_steps,
        actor_steps_per_sec=actor_steps / elapsed,
        learner_steps_per_sec=learner_sps,
        publishes=list(publishes),
        mean_return=mean_return,
        final_loss=last_loss[0],
        predict_retries=predict_fn.retries,
        rejected_pushes=queue.rejected_pushes,
        stale_dropped=queue.stale_dropped,
        trajectories=trajectories,
    )
