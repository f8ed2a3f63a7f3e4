"""The port's train step against the JAX package's.

Both sides get the same numbers: the port's weights are converted from
the JAX trainer's init (`convert.from_flax`) and both step on the same
numpy batches (the threefry data streams cannot be reproduced). The JAX
side runs flash attention in Pallas interpret mode, as its own CPU tests
do, on a one-device mesh.

Tolerances. Loss and gradients: f32 atol = rtol = 5e-5, the reference's
own flash gate (tests/test_flash_schedule.py), for sums taken in another
order. Parameters after adam steps: adam turns any nonzero gradient
into an update of about ±lr, so a gradient near 0 whose sign differs
by 1e-9 between the two moves its parameter by up to 2·lr a step; the
parameters are held at atol = 2·lr·steps. The optimizer alone, on the
same gradients, is held at 1e-6.

The in-model objective (``loss_in_model``) is held the same way on the
RL learner: three guarded REINFORCE steps of `rl.loop.build_learner`
against JAX's at accum_steps 1 and 2, on numpy batches of observations
and packed [action, return] labels.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.parallel import MeshSpec, build_mesh
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.train import trainer as ttrainer

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64,
            remat_policy="none")
SEQ, BATCH, STEPS = 128, 4, 3
TOL = dict(atol=5e-5, rtol=5e-5)


def _unbox(tree):
    return jax.tree.map(np.asarray, fnn.meta.unbox(tree))


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, TINY["vocab_size"], (BATCH, SEQ + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


# -- pieces ---------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 5, 17))).astype(np.float32)
    labels = rng.integers(0, 17, (2, 5))
    want = jtrainer.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), smoothing
    )
    got = ttrainer.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), smoothing
    )
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)


def test_schedule_matches_optax():
    cfg = ttrainer.TrainConfig(learning_rate=0.3, warmup_steps=5, total_steps=40)
    want = optax.warmup_cosine_decay_schedule(0.0, 0.3, 5, 40)
    schedule = ttrainer.warmup_cosine_schedule(cfg)
    counts = torch.arange(0, 60, dtype=torch.int32)
    got = schedule(counts).numpy()
    np.testing.assert_allclose(got, [float(want(c)) for c in range(60)], atol=1e-7)
    assert got[0] == 0.0
    short = ttrainer.TrainConfig(warmup_steps=10, total_steps=5)  # decay clamps
    want = optax.warmup_cosine_decay_schedule(0.0, 0.4, 10, 11)
    got = ttrainer.warmup_cosine_schedule(short)(counts[:15]).numpy()
    np.testing.assert_allclose(got, [float(want(c)) for c in range(15)], atol=1e-7)


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(train_metrics="all"), ValueError),
        (dict(optimizer="adam"), ValueError),
        (dict(step_remat="most"), ValueError),
        (dict(adam_mu_dtype="float16"), ValueError),
        (dict(accum_steps=0), ValueError),
        (dict(batch_size=6, accum_steps=4), ValueError),
        (dict(loss_in_model=True), ValueError),
        (dict(loss_in_model=True, train_metrics="loss", label_smoothing=0.1), ValueError),
        # "none" and "mlp" are block policies, not checkpoint policies.
        (dict(step_remat="none"), ValueError),
        (dict(step_remat="mlp"), ValueError),
    ],
)
def test_train_config_refuses(kwargs, error):
    with pytest.raises(error):
        ttrainer.TrainConfig(**kwargs)
    if error is ValueError:  # JAX refuses the same config
        with pytest.raises(ValueError):
            jtrainer.TrainConfig(**kwargs)


def test_train_config_takes_loss_in_model():
    """The in-model objective (the RL learner's) is ported: accepted
    where JAX accepts it."""
    kwargs = dict(loss_in_model=True, train_metrics="loss", label_smoothing=0.0)
    assert ttrainer.TrainConfig(**kwargs).loss_in_model
    assert jtrainer.TrainConfig(**kwargs).loss_in_model


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_optimizer_matches_optax(optimizer):
    """Three updates on the same params and gradients; warmup_steps=1,
    so steps 1 and 2 have a nonzero rate (step 0's is 0)."""
    cfg = ttrainer.TrainConfig(optimizer=optimizer, learning_rate=0.1,
                               warmup_steps=1, total_steps=10)
    jcfg = jtrainer.TrainConfig(optimizer=optimizer, learning_rate=0.1,
                                warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "scale": rng.standard_normal(3).astype(np.float32)}
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32)
              for n, p in params.items()} for _ in range(3)]
    tx = jtrainer.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)

    @jax.jit  # as the JAX train step runs it
    def update(g, jstate, jp):
        upd, jstate = tx.update(g, jstate, jp)
        return optax.apply_updates(jp, upd), jstate

    for g in grads:
        jp, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jp)
    opt = ttrainer.make_optimizer(cfg)
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    state = opt.init(tp)
    for g in grads:
        state = opt.step(tp, {n: torch.from_numpy(x) for n, x in g.items()}, state)
    for n in params:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), atol=1e-6, rtol=1e-6)
    if optimizer == "adamw":
        mu = state["mu"]["w"]
        assert mu.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mu.float().numpy(), np.asarray(jstate[0].mu["w"], np.float32)
        )


# -- the whole step ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_run():
    """Three adamw steps of the JAX Trainer on a tiny flash LM: the
    initial params, each step's loss, the first step's gradients and the
    final params."""
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    tcfg = jtrainer.TrainConfig(
        batch_size=BATCH, learning_rate=1e-2, warmup_steps=1, total_steps=10,
        optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
        train_metrics="loss",
    )
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    trainer = jtrainer.Trainer(
        jtf.TransformerLM(cfg, mesh=mesh), tcfg, mesh,
        example_input_shape=(2, SEQ), example_input_dtype=jnp.int32,
        input_key="tokens", label_key="labels",
    )
    state = trainer.init_state(jax.random.PRNGKey(0))
    init = _unbox(state.params)
    batches = _batches(STEPS)

    def loss_fn(params, batch):
        logits = state.apply_fn({"params": params}, jnp.asarray(batch["tokens"]))
        return jtrainer.softmax_cross_entropy(logits, jnp.asarray(batch["labels"]))

    grads = _unbox(jax.jit(jax.grad(loss_fn))(state.params, batches[0]))
    step = trainer.make_train_step()
    losses = []
    for batch in batches:
        state, metrics = step(state, jax.tree.map(
            lambda x: jnp.asarray(x, jnp.int32), batch))
        losses.append(float(metrics["loss"]))
    return init, grads, losses, _unbox(state.params), tcfg


def _port_trainer(init, tcfg, **changes):
    cfg = ttf.TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    model = ttf.TransformerLM(cfg, device="cpu")
    model.load_state_dict(convert.from_flax(init))
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)}
    config = ttrainer.TrainConfig(**{**fields, **changes})
    return ttrainer.Trainer(model, config, input_key="tokens",
                            label_key="labels", device="cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_steps_match_jax_trainer(jax_run):
    init, jgrads, jlosses, jfinal, tcfg = jax_run
    trainer = _port_trainer(init, tcfg)
    state = trainer.init_state()
    batches = _batches(STEPS)

    model = state.model
    loss = ttrainer.softmax_cross_entropy(
        model(torch.from_numpy(batches[0]["tokens"])),
        torch.from_numpy(batches[0]["labels"]),
    )
    loss.backward()
    want = convert.from_flax(jgrads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
        p.grad = None

    step = trainer.make_train_step()
    losses = []
    for batch in batches:
        state, metrics = step(state, _torch_batch(batch))
        losses.append(metrics["loss"].item())
    assert int(state.step) == STEPS
    np.testing.assert_allclose(losses, jlosses, **TOL)
    final = convert.from_flax(jfinal)
    atol = 2 * tcfg.learning_rate * STEPS
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)
    # The bound is loose by construction; most parameters agree far closer.
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - final[n].numpy()).ravel()
        for n, p in state.model.named_parameters()
    ])
    assert np.median(diffs) < 1e-6


def test_accumulation_equals_one_full_batch(jax_run):
    init, _, _, _, tcfg = jax_run
    batch = _torch_batch(_batches(1)[0])
    full = _port_trainer(init, tcfg)
    accum = _port_trainer(init, tcfg, accum_steps=2, train_metrics="full")
    s_full, m_full = full.make_train_step()(full.init_state(), batch)
    s_acc, m_acc = accum.make_train_step()(accum.init_state(), batch)
    np.testing.assert_allclose(m_acc["loss"].item(), m_full["loss"].item(), **TOL)
    assert 0.0 <= m_acc["accuracy"].item() <= 1.0
    for (name, a), b in zip(s_acc.model.named_parameters(),
                            s_full.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    for key, value in s_acc.opt_state["nu"].items():
        np.testing.assert_allclose(value.numpy(), s_full.opt_state["nu"][key].numpy(),
                                   atol=1e-9, rtol=1e-4, err_msg=key)


def test_eval_step_and_refusals(jax_run):
    init, _, _, _, tcfg = jax_run
    trainer = _port_trainer(init, tcfg)
    state = trainer.init_state()
    batch = _torch_batch(_batches(1)[0])
    metrics = trainer.make_eval_step()(state, batch)
    assert set(metrics) == {"loss", "accuracy"}
    assert np.isfinite(metrics["loss"].item())
    with pytest.raises(TypeError, match="AnomalyGuard"):
        ttrainer.Trainer(state.model, trainer.config, device="cpu", guard=object())


# -- loss_in_model: the REINFORCE learner ------------------------------------------


def _rl_batches(n):
    """`n` learner batches of 32 transitions: observations, and packed
    [action, return] labels (0/1 rewards, as the env pays)."""
    rng = np.random.default_rng(7)
    return [{"obs": rng.standard_normal((32, 8)).astype(np.float32),
             "target": np.stack([rng.integers(0, 4, 32), rng.integers(0, 2, 32)],
                                axis=1).astype(np.float32)} for _ in range(n)]


def _rl_cfg(jax_side: bool):
    from kubeflow_tpu.rl import loop as jloop
    from kubeflow_tpu_torch.rl import loop as tloop

    mod = jloop if jax_side else tloop
    return mod.RLConfig(env=mod.EnvConfig(seed=5, horizon=4, n_envs=8, obs_dim=8,
                                          n_actions=4),
                        hidden=16, total_steps=48, learning_rate=0.05)


@pytest.fixture(scope="module")
def rl_jax_runs():
    """Three guarded steps of the JAX REINFORCE learner (`rl.loop.build_learner`,
    ``loss_in_model=True``) at accum_steps 1 and 2, from one init: each
    step's loss and gradient norm, and the final params; and the eval
    step's loss on the first batch."""
    from kubeflow_tpu.rl import loop as jloop
    from kubeflow_tpu.rl.policy import PolicyWithLoss
    from kubeflow_tpu.train.guard import AnomalyGuard

    mesh = build_mesh(MeshSpec(dp=1), devices=jax.devices()[:1])
    base = jloop.build_learner(_rl_cfg(True), mesh, guard=AnomalyGuard())
    init = base.init_state(jax.random.PRNGKey(0))
    runs = {}
    for accum in (1, 2):
        trainer = base if accum == 1 else jtrainer.Trainer(
            PolicyWithLoss(n_actions=4, hidden=16),
            dataclasses.replace(base.config, accum_steps=2), mesh,
            example_input_shape=(32, 8), input_key="obs", label_key="target",
            guard=AnomalyGuard())
        state = trainer.init_state(jax.random.PRNGKey(0))
        step = trainer.make_train_step()
        losses, norms = [], []
        for batch in _rl_batches(STEPS):
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            assert int(metrics["guard_skipped_total"]) == 0
        runs[accum] = losses, norms, _unbox(state.params)
    first = jax.tree.map(jnp.asarray, _rl_batches(1)[0])
    eval_loss = float(base.make_eval_step()(init, first)["loss"])
    return _unbox(init.params), runs, eval_loss


def _rl_port_trainer(init, accum=1, **changes):
    from kubeflow_tpu_torch.rl import loop as tloop
    from kubeflow_tpu_torch.train.guard import AnomalyGuard

    trainer = tloop.build_learner(_rl_cfg(False), guard=AnomalyGuard(), device="cpu")
    trainer.model.load_state_dict(convert.policy_from_flax(init))
    if accum == 1 and not changes:
        return trainer
    config = dataclasses.replace(trainer.config, accum_steps=accum, **changes)
    return ttrainer.Trainer(trainer.model, config, input_key="obs", label_key="target",
                            device="cpu", guard=AnomalyGuard())


def _rl_port_run(trainer):
    state = trainer.init_state()
    step = trainer.make_train_step()
    losses, norms = [], []
    for batch in _rl_batches(STEPS):
        state, metrics = step(state, _torch_batch(batch))
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        assert metrics["guard_skipped_total"].item() == 0
    return losses, norms, state


@pytest.mark.parametrize("accum", [1, 2])
def test_reinforce_steps_match_jax_trainer(rl_jax_runs, accum):
    """Three guarded adamw steps of the REINFORCE learner against JAX's
    Trainer on converted weights: losses and gradient norms at 5e-5,
    parameters at 2·lr·steps (this file's tolerances)."""
    init, runs, _ = rl_jax_runs
    jlosses, jnorms, jfinal = runs[accum]
    trainer = _rl_port_trainer(init, accum)
    assert trainer.config.loss_in_model and trainer.config.accum_steps == accum
    losses, norms, state = _rl_port_run(trainer)
    assert int(state.step) == STEPS
    np.testing.assert_allclose(losses, jlosses, **TOL)
    np.testing.assert_allclose(norms, jnorms, **TOL)
    final = convert.policy_from_flax(jfinal)
    atol = 2 * trainer.config.learning_rate * STEPS
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)
    diffs = np.concatenate([
        np.abs(p.detach().numpy() - final[n].numpy()).ravel()
        for n, p in state.model.named_parameters()
    ])
    assert np.median(diffs) < 1e-6


def test_reinforce_under_full_remat_equals_the_plain_step(rl_jax_runs):
    """``step_remat="full"`` composes with the in-model loss and the
    guard: the same losses and parameters as without it."""
    init = rl_jax_runs[0]
    plain = _rl_port_run(_rl_port_trainer(init))
    remat = _rl_port_run(_rl_port_trainer(init, step_remat="full"))
    np.testing.assert_allclose(remat[0], plain[0], atol=1e-7, rtol=0)
    for (name, a), b in zip(remat[2].model.named_parameters(),
                            plain[2].model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-7, rtol=0, err_msg=name)


def test_reinforce_eval_step_matches_jax(rl_jax_runs):
    """Under loss_in_model the eval step reports the model's own loss
    (in eval mode) and nothing else, as JAX's does."""
    init, _, jloss = rl_jax_runs
    trainer = _rl_port_trainer(init)
    metrics = trainer.make_eval_step()(trainer.init_state(),
                                       _torch_batch(_rl_batches(1)[0]))
    assert set(metrics) == {"loss"}
    np.testing.assert_allclose(metrics["loss"].item(), jloss, **TOL)
