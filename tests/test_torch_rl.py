"""The port's RL package (`kubeflow_tpu_torch/rl`) against the JAX one.

First the 11 tests of tests/test_rl.py, run against the port's env,
replay queue and actor–learner loop (the end-to-end loop keeps its
publishes at [8, 16, 24] and its accounting). Then parity with the JAX
package on the same numbers: the env's observations, rewards, action
draws and rollouts, and a seeded script of replay-queue operations,
bit-equal; `PolicyMLP` and `PolicyWithLoss` (loss and gradients) against
flax on `policy_from_flax` weights, and the version-tagged servable
against JAX's, at f32 atol = rtol = 5e-5 (the reference's own flash
gate: sums taken in another order). Then what the
port does on purpose otherwise: the publisher restores the step the spec
names (JAX's the newest), a publish rolls each replica exactly once, a
fleet serving two versions says so (`servedVersions`, a `MixedVersions`
event), the acting path holds no torch, and the entry points refuse to
fall back to the CPU. Observations come from numpy with a seed.
"""

import ast
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.rl import env as jenv
from kubeflow_tpu.rl import policy as jpolicy
from kubeflow_tpu.rl import replay as jreplay
from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.models.convert import policy_from_flax
from kubeflow_tpu_torch.rl import env as env_mod
from kubeflow_tpu_torch.rl import loop as loop_mod
from kubeflow_tpu_torch.rl import policy as tpolicy
from kubeflow_tpu_torch.rl.env import EnvConfig, VectorEnv, rollout, sample_actions
from kubeflow_tpu_torch.rl.replay import ReplayQueue, ReplayStalled
from kubeflow_tpu_torch.serving.replica import LocalReplicaRuntime
from kubeflow_tpu_torch.serving.router import Router
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

TOL = dict(atol=5e-5, rtol=5e-5)


def fixed_predict(env_cfg, version=1):
    """Deterministic stand-in for the serving stack in unit tests."""

    def predict(obs):
        return obs[:, : env_cfg.n_actions].copy(), version

    return predict


# -- env ------------------------------------------------------------------


def test_rollout_is_pure_function_of_seed_salt_index():
    cfg = EnvConfig(seed=11, horizon=4, n_envs=3)
    env_a, env_b = VectorEnv(cfg), VectorEnv(cfg)
    ta = rollout(env_a, fixed_predict(cfg), 5, salt=2)
    tb = rollout(env_b, fixed_predict(cfg), 5, salt=2)
    np.testing.assert_array_equal(ta.obs, tb.obs)
    np.testing.assert_array_equal(ta.actions, tb.actions)
    np.testing.assert_array_equal(ta.rewards, tb.rewards)
    tc = rollout(env_a, fixed_predict(cfg), 5, salt=3)
    assert not np.array_equal(ta.obs, tc.obs)
    td = rollout(env_a, fixed_predict(cfg), 6, salt=2)
    assert not np.array_equal(ta.obs, td.obs)


def test_trajectory_transitions_pack_action_and_return():
    cfg = EnvConfig(seed=0, horizon=2, n_envs=2)
    env = VectorEnv(cfg)
    traj = rollout(env, fixed_predict(cfg, version=7), 0)
    assert traj.policy_version == 7
    batch = traj.transitions()
    assert batch["obs"].shape == (4, cfg.obs_dim)
    assert batch["target"].shape == (4, 2)
    np.testing.assert_array_equal(
        batch["target"][:, 0].astype(np.int32), traj.actions.reshape(-1)
    )
    np.testing.assert_array_equal(batch["target"][:, 1], traj.rewards.reshape(-1))


def test_optimal_policy_earns_full_return():
    cfg = EnvConfig(seed=3, horizon=5, n_envs=4)
    env = VectorEnv(cfg)
    obs = env.observe(0, 0)
    rewards = env.rewards(obs, env.optimal_actions(obs))
    np.testing.assert_array_equal(rewards, np.ones(cfg.n_envs))


# -- replay queue ---------------------------------------------------------


def _batch(i):
    return {"obs": np.full((4, 2), i, np.float32),
            "target": np.zeros((4, 2), np.float32)}


def test_replay_fifo_order_and_position():
    q = ReplayQueue(capacity=4, stall_timeout_s=5)
    claims = [q.claim() for _ in range(3)]
    for i in [2, 0, 1]:
        idx, salt = claims[i]
        assert q.push(idx, salt, version=1, batch=_batch(idx))
    got = [next(q)["obs"][0, 0] for _ in range(3)]
    assert got == [0, 1, 2]
    assert q.state_dict() == {"position": 3, "salt": 0}


def test_replay_resume_continues_claims_and_rejects_stale_pushes():
    q = ReplayQueue(capacity=4, stall_timeout_s=5)
    stale = q.claim()
    q.load_state_dict({"position": 7, "salt": 2})
    assert not q.push(stale[0], stale[1], version=1, batch=_batch(0))
    assert q.rejected_pushes == 1
    idx, salt = q.claim()
    assert (idx, salt) == (7, 2)
    assert q.push(idx, salt, version=1, batch=_batch(7))
    next(q)
    assert q.state_dict() == {"position": 8, "salt": 2}


def test_replay_perturb_invalidates_buffered_work():
    q = ReplayQueue(capacity=4, stall_timeout_s=5)
    idx, salt = q.claim()
    assert q.push(idx, salt, version=1, batch=_batch(idx))
    q.perturb(5)
    idx2, salt2 = q.claim()
    assert (idx2, salt2) == (0, 5)


def test_replay_abandoned_claim_is_reissued():
    q = ReplayQueue(capacity=4, stall_timeout_s=5)
    a = q.claim()
    b = q.claim()
    q.abandon(a[0], a[1])
    assert q.claim() == (a[0], a[1])
    assert q.push(a[0], a[1], version=1, batch=_batch(0))
    assert q.push(b[0], b[1], version=1, batch=_batch(1))
    next(q), next(q)


def test_replay_staleness_bound_drops_stale_and_stalls_loudly():
    q = ReplayQueue(capacity=8, staleness_bound=2, stall_timeout_s=0.3)
    for _ in range(4):
        idx, salt = q.claim()
        q.push(idx, salt, version=1, batch=_batch(idx))
    q.note_learner_step(20)
    with pytest.raises(ReplayStalled):
        next(q)
    assert q.stale_dropped == 4
    assert q.state_dict()["position"] == 4
    idx, salt = q.claim()
    q.push(idx, salt, version=20, batch=_batch(idx))
    assert next(q) is not None
    assert q.stale_dropped == 4


def test_replay_within_bound_trajectories_are_not_dropped():
    q = ReplayQueue(capacity=8, staleness_bound=5, stall_timeout_s=1)
    idx, salt = q.claim()
    q.push(idx, salt, version=6, batch=_batch(idx))
    q.note_learner_step(10)
    assert next(q) is not None
    assert q.stale_dropped == 0


def test_replay_backpressure_at_claim_never_wedges_a_held_ticket():
    q = ReplayQueue(capacity=2, stall_timeout_s=5)
    head = q.claim()
    other = q.claim()
    assert q.push(other[0], other[1], version=1, batch=_batch(1))
    assert q._next_claim == q.state_dict()["position"] + q.capacity
    assert q.push(head[0], head[1], version=1, batch=_batch(0))
    assert next(q)["obs"][0, 0] == 0
    assert next(q)["obs"][0, 0] == 1
    assert q.claim() == (2, 0)


def test_replay_moves_batches_to_the_learner_device_and_refuses_rebind():
    """The port's departure: with `device` the learner takes torch
    tensors there (JAX's `device_put` on a batch sharding); `rebind`
    (elastic resize) is not ported."""
    q = ReplayQueue(capacity=2, device="cpu", stall_timeout_s=5)
    idx, salt = q.claim()
    q.push(idx, salt, version=1, batch=_batch(3))
    got = next(q)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in got.values())
    np.testing.assert_array_equal(got["obs"].numpy(), _batch(3)["obs"])
    with pytest.raises(NotImplementedError, match="item 12"):
        q.rebind(None)


# -- the integration loop -------------------------------------------------


def _policy_fleet(ckpt_dir, trainer, cfg, name="pol", replicas=2):
    publisher = tpolicy.PolicyCheckpointPublisher(
        str(ckpt_dir), trainer.abstract_state, obs_dim=cfg.env.obs_dim,
        n_actions=cfg.env.n_actions, hidden=cfg.hidden, device="cpu",
    )
    api, router = FakeApiServer(), Router()
    ctl = ServingDeploymentController(api, runtime=LocalReplicaRuntime(router, publisher))
    api.create(serving_api.make_serving_deployment(
        name, model="policy", replicas=replicas, max_batch=8, batch_timeout_ms=1.0,
    ))
    ctl.controller.run_until_idle()
    return api, router, ctl


def _close_fleet(router):
    for name in router.replica_names():
        router.replica(name).close()


def _rolls(api, name):
    """ReplicaRolled events: replica -> the versions it rolled to."""
    out = {}
    for ev in api.list("Event", "default"):
        if ev.spec["reason"] == "ReplicaRolled" and \
                ev.spec["involvedObject"]["name"] == name:
            replica, _, _, version = ev.spec["message"].split()[:4]
            out.setdefault(replica, []).append(int(version))
    return {r: sorted(v) for r, v in out.items()}


def test_actor_learner_loop_end_to_end(tmp_path):
    """CR-materialized fleet + real fit() + publication drain-rolls."""
    from kubeflow_tpu_torch.rl.loop import RLConfig, build_learner, run_actor_learner
    from kubeflow_tpu_torch.train import Checkpointer, FitResult

    cfg = RLConfig(
        env=EnvConfig(seed=5, horizon=4, n_envs=8, obs_dim=8, n_actions=4),
        hidden=16, total_steps=24, publish_every=8, staleness_bound=16,
        n_actors=2, learning_rate=0.05,
    )
    trainer = build_learner(cfg, device="cpu")
    api, router, ctl = _policy_fleet(tmp_path / "ckpt", trainer, cfg)
    assert len(router.ready_names()) == 2
    ckpt = Checkpointer(str(tmp_path / "ckpt"), save_interval_steps=cfg.publish_every)
    queue = ReplayQueue(capacity=cfg.replay_capacity, staleness_bound=cfg.staleness_bound,
                        device=trainer.device, stall_timeout_s=60)
    try:
        result = run_actor_learner(
            api=api, deployment="pol", router=router, trainer=trainer,
            checkpointer=ckpt, queue=queue, cfg=cfg,
            reconcile=ctl.controller.run_until_idle,
        )
    finally:
        ckpt.close()
    try:
        assert isinstance(result.fit_result, FitResult)
        assert result.fit_result.steps_done == cfg.total_steps
        versions = [p.version for p in result.publishes]
        assert versions == [8, 16, 24]
        assert len(result.publish_latencies) == 3, result.publishes
        assert all(s >= 0 for s in result.publish_latencies)
        dep = api.get(serving_api.KIND, "pol", "default")
        assert int(dep.spec["modelVersion"]) == 24
        for rname in router.ready_names():
            assert router.replica(rname).version == 24
        assert dep.status["servedVersions"] == [24]
        # An in-process fleet rolls both replicas in one reconcile: no
        # mixed set was ever recorded.
        assert _mixed_recorded(api) == []
        assert result.actor_steps > 0
        assert queue.state_dict()["position"] == cfg.total_steps + result.stale_dropped
        assert router.stats()["outstanding"] == 0
        # Each replica rolled exactly once per publish.
        assert _rolls(api, "pol") == {
            serving_api.replica_name("pol", i): [8, 16, 24] for i in range(2)}
    finally:
        _close_fleet(router)


# -- parity with the JAX package ----------------------------------------------


@pytest.mark.parametrize("seed,horizon,n_envs,obs_dim,n_actions",
                         [(0, 4, 8, 8, 4), (3, 5, 4, 6, 3), (11, 2, 3, 8, 5)])
def test_env_matches_jax(seed, horizon, n_envs, obs_dim, n_actions):
    """Observations, rewards, optimal actions, the Gumbel draw and whole
    rollouts against `kubeflow_tpu.rl.env`, over trajectory indices and
    salts, with the same predict_fn: bit-equal."""
    kw = dict(seed=seed, horizon=horizon, n_envs=n_envs, obs_dim=obs_dim,
              n_actions=n_actions)
    tcfg, jcfg = EnvConfig(**kw), jenv.EnvConfig(**kw)
    assert tcfg.transitions_per_trajectory == jcfg.transitions_per_trajectory
    tenv, jaxenv = VectorEnv(tcfg), jenv.VectorEnv(jcfg)
    w = np.random.default_rng(seed + 100).standard_normal(
        (obs_dim, n_actions)).astype(np.float32)

    def predict(obs):  # a fixed linear policy; the version follows the obs
        return obs @ w, int(abs(obs[0, 0]) * 1000)

    for index, salt in ((0, 0), (5, 2), (17, 0), (17, 9)):
        for step in range(horizon):
            obs = tenv.observe(index, step, salt)
            np.testing.assert_array_equal(obs, jaxenv.observe(index, step, salt))
            np.testing.assert_array_equal(tenv.optimal_actions(obs),
                                          jaxenv.optimal_actions(obs))
            actions = np.random.default_rng((index, step)).integers(0, n_actions, n_envs)
            np.testing.assert_array_equal(tenv.rewards(obs, actions),
                                          jaxenv.rewards(obs, actions))
            np.testing.assert_array_equal(
                sample_actions(obs @ w, tcfg, index, step, salt),
                jenv.sample_actions(obs @ w, jcfg, index, step, salt))
        got = rollout(tenv, predict, index, salt=salt)
        want = jenv.rollout(jaxenv, predict, index, salt=salt)
        assert (got.index, got.policy_version) == (want.index, want.policy_version)
        for field in ("obs", "actions", "rewards"):
            assert getattr(got, field).dtype == getattr(want, field).dtype
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert got.mean_return == want.mean_return
        for key, value in want.transitions().items():
            np.testing.assert_array_equal(got.transitions()[key], value)


def _take(queue):
    """What one learner take yields: the batch's first obs value, or
    "stalled" when no admissible trajectory came in the stall timeout,
    or "stopped" once the queue is closed and empty."""
    try:
        return float(next(queue)["obs"][0, 0])
    except ReplayStalled:
        return "stalled"
    except jreplay.ReplayStalled:
        return "stalled"
    except StopIteration:
        return "stopped"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replay_queue_matches_jax(seed):
    """A seeded script of claims, pushes (out of order, at versions up to
    twice the staleness bound behind the learner), abandons, pushes of
    tickets a perturb or a restore made stale, learner steps and takes,
    through the port's queue (no device) and JAX's (no mesh): the same
    tickets, push verdicts, batches and stalls, and after every operation
    the same `state_dict()`, `stale_dropped` and `rejected_pushes`."""
    rng = np.random.default_rng(seed)
    kw = dict(capacity=int(rng.integers(2, 6)), staleness_bound=int(rng.integers(2, 8)),
              stall_timeout_s=0.01)
    port, ref = ReplayQueue(**kw), jreplay.ReplayQueue(**kw)
    held, old, step = [], [], 0  # live tickets, tickets from before a perturb/restore
    ops = ["claim", "push", "abandon", "stale", "take", "step", "perturb", "restore"]
    counts = dict.fromkeys(ops, 0)
    for _ in range(300):
        op = ops[rng.choice(len(ops), p=[0.25, 0.3, 0.04, 0.04, 0.2, 0.09, 0.04, 0.04])]
        if op == "claim":
            free = [bool(q._returned) or q._next_claim < q._position + q.capacity
                    for q in (port, ref)]
            assert free[0] == free[1]
            if not free[1]:
                continue  # a claim would block until the learner takes
            ticket = port.claim()
            assert ticket == ref.claim()
            held.append(ticket)
        elif op in ("push", "abandon", "stale"):
            pool = old if op == "stale" else held
            if not pool:
                continue
            index, salt = pool.pop(int(rng.integers(len(pool))))
            if op == "abandon":
                port.abandon(index, salt)
                ref.abandon(index, salt)
            else:
                version = max(0, step - int(rng.integers(0, 2 * kw["staleness_bound"])))
                assert port.push(index, salt, version, _batch(index)) == \
                    ref.push(index, salt, version, _batch(index))
        elif op == "take":
            assert _take(port) == _take(ref)
        elif op == "step":
            step += int(rng.integers(1, 4))
            port.note_learner_step(step)
            ref.note_learner_step(step)
        else:
            salt = int(rng.integers(0, 100))
            if op == "perturb":
                port.perturb(salt)
                ref.perturb(salt)
            else:
                position = ref.state_dict()["position"]
                state = {"position": int(rng.integers(max(0, position - 3), position + 3)),
                         "salt": salt}
                port.load_state_dict(state)
                ref.load_state_dict(state)
            old += held
            held = []
        counts[op] += 1
        assert port.state_dict() == ref.state_dict()
        assert (port.stale_dropped, port.rejected_pushes) == \
            (ref.stale_dropped, ref.rejected_pushes)
    assert all(counts.values()), counts  # the script reached every operation
    port.close()
    ref.close()
    tail = [_take(port)]
    while tail[-1] != "stopped":
        tail.append(_take(port))
    assert tail == [_take(ref) for _ in tail]


def _obs(n=32, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _labels(n=32, n_actions=4, seed=1):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_actions, n).astype(np.float32),
                     rng.integers(0, 2, n).astype(np.float32)], axis=1)


def _unbox(tree):
    return jax.tree.map(np.asarray, tree)


def test_policy_mlp_matches_flax():
    module = jpolicy.PolicyMLP(n_actions=4, hidden=16)
    variables = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.float32))
    obs = _obs()
    want = np.asarray(module.apply(variables, jnp.asarray(obs)))
    port = tpolicy.PolicyMLP(8, 4, 16, device="cpu")
    port.load_state_dict(policy_from_flax(_unbox(variables["params"])))
    got = port(torch.from_numpy(obs)).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_labels", [True, False])
def test_policy_with_loss_matches_flax(with_labels):
    """The REINFORCE loss and its gradients, on the learner face's
    converted params (``policy`` level kept); without labels both sides
    use zeros."""
    module = jpolicy.PolicyWithLoss(n_actions=4, hidden=16)
    obs, labels = _obs(), _labels() if with_labels else None
    variables = module.init(jax.random.PRNGKey(4), jnp.asarray(obs))

    def loss_fn(params):
        return module.apply({"params": params}, jnp.asarray(obs), train=True,
                            labels=None if labels is None else jnp.asarray(labels))

    want, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    port = tpolicy.PolicyWithLoss(8, 4, 16, device="cpu")
    port.load_state_dict(policy_from_flax(_unbox(variables["params"])))
    loss = port(torch.from_numpy(obs),
                labels=None if labels is None else torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_grads = policy_from_flax(_unbox(jgrads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **TOL)


def test_policy_servable_matches_jax():
    """Logits plus the version column, against the JAX servable on the
    same observations (1, 5 and 8 rows: padded buckets and a full one)."""
    variables = jpolicy.init_policy_variables(8, 4, 16, seed=2)
    jserv = jpolicy.make_policy_servable(
        "p", variables, version=7, n_actions=4, hidden=16, max_batch=8,
        device=jax.devices("cpu")[0], obs_dim=8)
    tserv = tpolicy.make_policy_servable(
        "p", policy_from_flax(_unbox(variables["params"])), version=7, n_actions=4,
        hidden=16, max_batch=8, device="cpu", obs_dim=8)
    assert tserv.version == jserv.version == 7
    for n in (1, 5, 8):
        obs = _obs(n, seed=n)
        want, got = np.asarray(jserv.predict(obs)), tserv.predict(obs)
        assert got.shape == want.shape == (n, 5)
        np.testing.assert_allclose(got, want, **TOL)
        logits, version = tpolicy.split_predictions(got)
        assert version == 7 and logits.shape == (n, 4)


def test_extract_policy_variables_drops_the_wrapper_level():
    learner = tpolicy.PolicyWithLoss(8, 4, 16, seed=1, device="cpu")
    served = tpolicy.extract_policy_variables(
        {"params": dict(learner.named_parameters())})
    assert set(served) == {"Dense_0.weight", "Dense_0.bias", "Dense_1.weight",
                           "Dense_1.bias"}
    mlp = tpolicy.PolicyMLP(8, 4, 16, device="cpu")
    mlp.load_state_dict(served)
    obs = torch.from_numpy(_obs())
    torch.testing.assert_close(mlp(obs), learner.policy(obs), rtol=0, atol=0)
    # A seed gives the same weights however it is passed.
    again = tpolicy.init_policy_variables(8, 4, 16, torch.Generator().manual_seed(1),
                                          device="cpu")
    for name, value in again.items():
        torch.testing.assert_close(value, served[name], rtol=0, atol=0)


# -- the publisher's departure -------------------------------------------------


def _rl_cfg(**changes):
    from kubeflow_tpu_torch.rl.loop import RLConfig

    base = dict(env=EnvConfig(seed=5, horizon=4, n_envs=8, obs_dim=8, n_actions=4),
                hidden=16, total_steps=48, publish_every=12, learning_rate=0.05)
    return RLConfig(**{**base, **changes})


def _save_steps(trainer, directory, steps, max_to_keep=3):
    """The learner's state committed at each of `steps`, the parameters
    moved between saves so that every step holds other weights."""
    from kubeflow_tpu_torch.train import Checkpointer

    ckpt = Checkpointer(str(directory), save_interval_steps=1, max_to_keep=max_to_keep)
    state = trainer.init_state()
    try:
        for step in steps:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(0.01 * step)
            ckpt.save(step, state, force=True)
            ckpt.wait()
    finally:
        ckpt.close()
    return state


def _served_weights(servable):
    return {k: v.detach().clone() for k, v in servable.variables.state_dict().items()}


def test_publisher_serves_the_specs_step_where_jax_serves_the_newest(tmp_path):
    """Steps 12 and 24 on disk, spec 12: the port's replica serves 12
    with step 12's weights, JAX's serves 24. Spec 0, or an empty
    directory: the seeded fresh init at version 1."""
    from kubeflow_tpu.parallel import MeshSpec, build_mesh
    from kubeflow_tpu.rl import loop as jloop
    from kubeflow_tpu.train import Checkpointer as JaxCheckpointer
    from kubeflow_tpu_torch.rl.loop import build_learner
    from kubeflow_tpu_torch.train import Checkpointer

    cfg = _rl_cfg()
    trainer = build_learner(cfg, device="cpu")
    publisher = tpolicy.PolicyCheckpointPublisher(
        str(tmp_path / "port"), trainer.abstract_state, obs_dim=8, n_actions=4,
        hidden=16, init_seed=3, device="cpu")
    fresh = publisher({"model": "policy", "modelVersion": 12})  # no directory yet
    assert fresh.version == 1
    _save_steps(trainer, tmp_path / "port", [12, 24])
    served = publisher({"model": "policy", "modelVersion": 12, "maxBatch": 8})
    assert served.version == 12
    ckpt = Checkpointer(str(tmp_path / "port"), read_only=True)
    want = ckpt.restore_latest(trainer.abstract_state(), prefer_step=12)
    assert want.step == 12
    weights = _served_weights(served)
    for name, value in tpolicy.extract_policy_variables(want.state["params"]).items():
        torch.testing.assert_close(weights[name], value, rtol=0, atol=0)
    assert publisher({"model": "policy", "modelVersion": 36}).version == 24
    init = publisher({"model": "policy", "modelVersion": 0})
    assert init.version == 1
    seeded = tpolicy.init_policy_variables(8, 4, 16, 3, device="cpu")
    for name, value in _served_weights(init).items():
        torch.testing.assert_close(value, seeded[name], rtol=0, atol=0)

    mesh = build_mesh(MeshSpec(dp=1), jax.devices()[:1])
    jtrainer = jloop.build_learner(jloop.RLConfig(env=jloop.EnvConfig(
        seed=5, horizon=4, n_envs=8, obs_dim=8, n_actions=4), hidden=16), mesh)
    jckpt = JaxCheckpointer(str(tmp_path / "jax"), save_interval_steps=1)
    state = jtrainer.init_state(jax.random.PRNGKey(0))
    try:
        for step in (12, 24):
            jckpt.save(step, state, force=True)
    finally:
        jckpt.close()
    jpub = jpolicy.PolicyCheckpointPublisher(
        str(tmp_path / "jax"), jtrainer.abstract_state, obs_dim=8, n_actions=4,
        hidden=16, device=jax.devices("cpu")[0])
    assert jpub({"model": "policy", "modelVersion": 12}).version == 24


def test_publisher_and_learner_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """Without CUDA and without a named device the entry points raise."""
    from kubeflow_tpu_torch.rl.loop import build_learner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_learner(_rl_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpolicy.PolicyCheckpointPublisher(str(tmp_path), lambda: {}, obs_dim=8,
                                          n_actions=4, hidden=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpolicy.make_policy_servable("p", {}, version=1, n_actions=4, hidden=16)


# -- the control plane ------------------------------------------------------------


def test_a_publish_rolls_each_replica_once_and_actors_observe_it(tmp_path):
    """The fleet serves the seeded init at version 1; the learner commits
    step 12 and the CR is bumped to it: one reconcile rolls each replica
    exactly once, an actor's next response carries version 12 and step
    12's logits, and further reconciles roll nothing."""
    from kubeflow_tpu_torch.rl.loop import _RouterPolicy, build_learner, bump_model_version

    cfg = _rl_cfg()
    trainer = build_learner(cfg, device="cpu")
    api, router, ctl = _policy_fleet(tmp_path / "ckpt", trainer, cfg)
    try:
        seen = []
        actor = _RouterPolicy(router, timeout_s=10, on_version=seen.append)
        obs = _obs(8)
        _, version = actor(obs)
        assert version == 1
        state = _save_steps(trainer, tmp_path / "ckpt", [12])
        bump_model_version(api, "pol", "default", 12)
        bump_model_version(api, "pol", "default", 11)  # never backwards
        ctl.controller.run_until_idle()
        assert _rolls(api, "pol") == {
            serving_api.replica_name("pol", i): [12] for i in range(2)}
        logits, version = actor(obs)
        assert version == 12 and seen == [1, 12]
        want = state.model.policy(torch.from_numpy(obs)).detach().numpy()
        np.testing.assert_allclose(logits, want, atol=1e-6, rtol=1e-6)
        for _ in range(5):
            ctl.controller.enqueue(("default", "pol"))
            ctl.controller.run_until_idle()
        assert ctl.rolls_total.value(deployment="pol") == 2
        status = api.get(serving_api.KIND, "pol", "default").status
        assert status["servedVersions"] == [12] and _mixed_recorded(api) == []
        assert api.get(serving_api.KIND, "pol", "default").spec["modelVersion"] == 12
    finally:
        _close_fleet(router)


def _mixed_events(api):
    return [ev.spec for ev in api.list("Event", "default")
            if ev.spec["reason"] == "MixedVersions"]


def _mixed_recorded(api):
    """Every MixedVersions event the apiserver's journal recorded, deleted
    ones included."""
    entries, _ = api.events_since(0, kind="Event")
    return [ev.spec["message"] for _, kind, ev in entries
            if kind == "ADDED" and ev.spec["reason"] == "MixedVersions"]


def test_a_fleet_serving_two_versions_says_so(tmp_path):
    """ROADMAP Queue 3's fault. The directory holds steps 9, 12 and 15
    (max_to_keep 3) and the spec names 9: replica 0 serves 9. Training
    saves 18, which evicts 9; a second replica, built later, restores
    the newest step, 18. Both are current (`version_current`), so
    nothing rolls: the CR's ``servedVersions`` reads [9, 18] and one
    ``MixedVersions`` Warning names the set, once however often the
    controller reconciles. A bump to 18 rolls replica 0 to match: the
    field reads [18] and the event is gone."""
    from kubeflow_tpu_torch.rl.loop import build_learner, bump_model_version

    cfg = _rl_cfg()
    trainer = build_learner(cfg, device="cpu")
    ckpt_dir = tmp_path / "ckpt"
    _save_steps(trainer, ckpt_dir, [9, 12, 15])
    publisher = tpolicy.PolicyCheckpointPublisher(
        str(ckpt_dir), trainer.abstract_state, obs_dim=8, n_actions=4, hidden=16,
        device="cpu")
    api, router = FakeApiServer(), Router()
    ctl = ServingDeploymentController(api, runtime=LocalReplicaRuntime(router, publisher))
    api.create(serving_api.make_serving_deployment(
        "pol", model="policy", replicas=1, max_batch=8, batch_timeout_ms=1.0,
        checkpoint_dir=str(ckpt_dir), model_version=9))
    status = lambda: api.get(serving_api.KIND, "pol", "default").status  # noqa: E731
    try:
        ctl.controller.run_until_idle()
        assert status()["servedVersions"] == [9] and not _mixed_events(api)

        _save_steps(trainer, ckpt_dir, [18])  # evicts 9
        assert sorted(int(p.name) for p in ckpt_dir.iterdir()) == [12, 15, 18]
        dep = api.get(serving_api.KIND, "pol", "default").thaw()
        dep.spec = {**dep.spec, "replicas": 2}
        api.update(dep)
        for _ in range(5):
            ctl.controller.enqueue(("default", "pol"))
            ctl.controller.run_until_idle()
        assert sorted(router.replica(n).version for n in router.replica_names()) == [9, 18]
        assert ctl.rolls_total.value(deployment="pol") == 0
        assert status()["servedVersions"] == [9, 18]
        events = _mixed_events(api)
        assert len(events) == 1 and events[0]["type"] == "Warning"
        assert "[9, 18]" in events[0]["message"]

        bump_model_version(api, "pol", "default", 18)
        ctl.controller.run_until_idle()
        assert ctl.rolls_total.value(deployment="pol") == 1
        assert status()["servedVersions"] == [18]
        assert not _mixed_events(api)
        assert _mixed_recorded(api) == [events[0]["message"]]
    finally:
        _close_fleet(router)


# -- the acting path holds no torch --------------------------------------------


def test_acting_path_makes_no_host_sync():
    """The AST half of JAX's rl-actor-learner contract
    (kubeflow_tpu/ci/lint/contracts.py:655-700) on the port: `_actor_loop`,
    `rollout` and `sample_actions` name no torch and call no `.item()`,
    `.cpu()`, `.numpy()` or `synchronize`. A host sync there would step
    every rollout in lockstep with the device."""
    found, syncs = set(), []
    for module, names in ((loop_mod, {"_actor_loop"}),
                          (env_mod, {"rollout", "sample_actions"})):
        _host_syncs(inspect.getsource(module), names, found, syncs)
    assert found == {"_actor_loop", "rollout", "sample_actions"}
    assert syncs == []
    # The scan finds what it looks for.
    probe_found, probe_syncs = set(), []
    _host_syncs(textwrap.dedent("""
        def rollout(x):
            torch.cuda.synchronize()
            return x.cpu().numpy(), x.item()
    """), {"rollout"}, probe_found, probe_syncs)
    assert probe_found == {"rollout"}
    assert sorted(probe_syncs) == sorted(
        f"rollout: {s}" for s in (".synchronize", ".cuda", "torch", ".cpu", ".numpy",
                                  ".item"))


def _host_syncs(source: str, names: set, found: set, syncs: list) -> None:
    """Record which of the functions `names` `source` defines (into
    `found`) and each torch name or sync call inside them (`syncs`)."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            found.add(node.name)
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and sub.attr in (
                        "item", "cpu", "numpy", "synchronize", "cuda"):
                    syncs.append(f"{node.name}: .{sub.attr}")
                if isinstance(sub, ast.Name) and sub.id == "torch":
                    syncs.append(f"{node.name}: torch")
