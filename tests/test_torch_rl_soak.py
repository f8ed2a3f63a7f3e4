"""RL's study soak on the port (bench phase B), on the CPU.

- `RLFaultSchedule` plans are identical to JAX's for the same
  (seed, trials), and refuse the same too-small studies.
- `run_actor_learner(fault_hook=)` calls its hook at every learner log
  boundary, after the boundary's publish.
- `test_rl_soak_small`'s configuration (seed 7, 3 trials, 12 learner
  steps, a publish every 4) runs through the port: the controller-manager
  binary, the local pod runner and the trial worker on the CPU
  (``KFTPU_DEVICE=cpu``), with zero lost trials, every fault class
  covered by worker-reported evidence and each trial's restarts as its
  plan says.
"""

import numpy as np
import pytest

from kubeflow_tpu.rl import replay as jreplay
from kubeflow_tpu.testing import chaos as jchaos
from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.rl import (
    EnvConfig, PolicyCheckpointPublisher, ReplayQueue, RLConfig, build_learner,
    run_actor_learner)
from kubeflow_tpu_torch.serving.replica import LocalReplicaRuntime
from kubeflow_tpu_torch.serving.router import Router
from kubeflow_tpu_torch.testing import chaos
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.testing.job_plane import JobPlane
from kubeflow_tpu_torch.testing.rl_soak import run_rl_study_soak
from kubeflow_tpu_torch.train import Checkpointer


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("trials", [3, 4, 6])
def test_fault_plan_equals_jax(seed, trials):
    got = chaos.RLFaultSchedule(seed, trials=trials)
    want = jchaos.RLFaultSchedule(seed, trials=trials)
    assert [(f.cls, f.trial, f.at_fraction) for f in got.plan] == \
        [(f.cls, f.trial, f.at_fraction) for f in want.plan]
    for t in range(trials):
        assert [f.cls for f in got.for_trial(t)] == [f.cls for f in want.for_trial(t)]
    assert chaos.RL_FAULT_CLASSES == jchaos.RL_FAULT_CLASSES
    got.mark_injected(chaos.ACTOR_KILL)
    want.mark_injected(jchaos.ACTOR_KILL)
    assert got.coverage() == want.coverage()
    assert repr(got) == repr(want)


def test_fault_plan_refuses_what_jax_refuses():
    with pytest.raises(ValueError) as want:
        jchaos.RLFaultSchedule(1, trials=2)
    with pytest.raises(ValueError) as got:
        chaos.RLFaultSchedule(1, trials=2)
    assert str(got.value) == str(want.value)


def test_fault_hook_runs_at_every_log_boundary(tmp_path):
    cfg = RLConfig(env=EnvConfig(seed=3, horizon=3, n_envs=8, obs_dim=8, n_actions=4),
                   hidden=16, total_steps=6, publish_every=3, staleness_bound=6,
                   n_actors=2, learning_rate=0.05)
    trainer = build_learner(cfg, device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    publisher = PolicyCheckpointPublisher(ckpt_dir, trainer.abstract_state,
                                          obs_dim=8, n_actions=4, hidden=16, device="cpu")
    api, router = FakeApiServer(), Router()
    ctl = ServingDeploymentController(api, runtime=LocalReplicaRuntime(router, publisher))
    api.create(serving_api.make_serving_deployment(
        "pol", model="policy", replicas=2, max_batch=8, batch_timeout_ms=1.0))
    ctl.controller.run_until_idle()
    calls = []
    ckpt = Checkpointer(ckpt_dir, save_interval_steps=cfg.publish_every)
    queue = ReplayQueue(capacity=cfg.replay_capacity, staleness_bound=cfg.staleness_bound,
                        device=trainer.device, stall_timeout_s=60)

    def fault_hook(step):
        # The boundary's publish is already bumped when the hook runs.
        version = int(api.get(serving_api.KIND, "pol").spec.get("modelVersion") or 0)
        calls.append((step, version))

    try:
        result = run_actor_learner(
            api=api, deployment="pol", router=router, trainer=trainer, checkpointer=ckpt,
            queue=queue, cfg=cfg, reconcile=ctl.controller.run_until_idle,
            fault_hook=fault_hook)
    finally:
        ckpt.close()
        for name in router.replica_names():
            router.replica(name).close()
        api.close()
    assert result.fit_result.steps_done == 6
    assert [step for step, _ in calls] == list(range(1, 7))
    # At a publish boundary the spec already names the step's checkpoint.
    assert [version for step, version in calls if step % 3 == 0] == [3, 6]


def test_rl_soak_small(tmp_path):
    """bench.py's tier-1 soak configuration through the port on the CPU."""
    with JobPlane(capture_dir=str(tmp_path / "logs")) as plane:
        m = run_rl_study_soak(plane, str(tmp_path / "rl"), seed=7, trials=3, steps=12,
                              publish_every=4, deadline_s=110, device="cpu")
        assert plane.stop_manager() == 0
    assert m["best_return"] > 0, m
    assert all(v >= 1 for v in m["coverage"].values()), m
    assert sorted(t["restarts"] for t in m["per_trial"]) == [0, 1, 1]
    assert m["studies_per_hour"] > 0


def test_a_restore_to_the_same_salt_rejects_the_duplicate_push():
    """Tickets issued before a restore to the checkpoint's salt stay
    valid, and the restore issues their indices again: the port buffers
    one copy, JAX's buffers both and stalls behind the second."""
    batch = lambda v: {"obs": np.full((4, 8), v, np.float32),
                       "target": np.zeros((4, 2), np.float32)}
    outcomes = []
    for q in (ReplayQueue(capacity=4, stall_timeout_s=0.3),
              jreplay.ReplayQueue(capacity=4, stall_timeout_s=0.3)):
        early = [q.claim() for _ in range(4)]  # actors start before the restore
        q.load_state_dict({"position": 2, "salt": 0})  # fit() resumes at step 2
        q.push(*early[2], 1, batch(2.0))  # an in-flight pre-restore ticket
        again = [q.claim() for _ in range(2)]
        assert again == [(2, 0), (3, 0)]
        pushed = [q.push(*t, 1, batch(float(t[0]))) for t in again]
        q.push(*early[3], 1, batch(3.0))
        taken = []
        for _ in range(3):
            try:
                taken.append(float(next(q)["obs"][0, 0]))
            except Exception as e:  # noqa: BLE001 - ReplayStalled of either package
                taken.append(type(e).__name__)
                break
        outcomes.append((pushed, taken))
    port, jax = outcomes
    assert port == ([False, True], [2.0, 3.0, "ReplayStalled"])
    assert jax == ([True, True], [2.0, "ReplayStalled"])
