"""The port's anomaly guard and guarded train step against the JAX package's.

The guard is held against JAX's `AnomalyGuard` on the same (loss,
grad_norm, update_finite) sequences, drawn from seeded numpy: verdicts,
counters and the `diverged` flag equal, the EWMAs within 1e-6 relative
(both run in float32; the tolerance covers one rounding of a different
operation order, of which there is none today). The guarded step is held
against JAX's guarded `Trainer` on a tiny flash LM (2 layers, d_model
64; JAX's flash in Pallas interpret mode) with the port's weights
converted from JAX's init (`convert.from_flax`) and the same numpy
batches: the losses at the unguarded step's tolerance
(tests/test_torch_trainer.py, atol = rtol = 5e-5) and the same skip
decisions. A skipped step leaves the port's parameters and optimizer
state bitwise unchanged.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.parallel import MeshSpec, build_mesh
from kubeflow_tpu.train import guard as jguard
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.train import trainer as ttrainer
from kubeflow_tpu_torch.train.guard import AnomalyGuard, GuardConfig

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64, remat_policy="none")
SEQ, BATCH = 128, 4
TOL = dict(atol=5e-5, rtol=5e-5)
EWMA_RTOL = 1e-6


def _poison(model):
    """A forward pre-hook on the first block that multiplies the
    embedding output by NaN; returns its handle."""
    return model.layers[0].register_forward_pre_hook(
        lambda module, args: (args[0] * float("nan"), *args[1:]))


# -- the guard alone -------------------------------------------------------------


@pytest.mark.parametrize("kwargs,match", [
    (dict(loss_spike_factor=0.5), "spike factors"),
    (dict(grad_spike_factor=1.0), "spike factors"),
    (dict(ewma_alpha=0.0), "ewma_alpha"),
    (dict(ewma_alpha=1.5), "ewma_alpha"),
    (dict(max_consecutive_skips=0), "max_consecutive_skips"),
])
def test_guard_config_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        GuardConfig(**kwargs)
    with pytest.raises(ValueError, match=match):  # JAX refuses the same
        jguard.GuardConfig(**kwargs)


def _t(x):
    return torch.tensor(x, dtype=torch.float32)


def test_guard_skips_nonfinite_and_spikes_updates_ewma_on_accept_only():
    guard = AnomalyGuard(GuardConfig(
        ewma_alpha=0.5, warmup_steps=1, loss_spike_factor=2.0,
        max_consecutive_skips=2,
    ))
    g = guard.init_state()
    g, ok = guard.apply(g, _t(1.0), _t(1.0))
    assert bool(ok) and float(g["ewma_loss"]) == 1.0
    g, ok = guard.apply(g, _t(np.nan), _t(1.0))
    assert not bool(ok)
    assert float(g["ewma_loss"]) == 1.0 and int(g["skipped_total"]) == 1
    g, ok = guard.apply(g, _t(10.0), _t(1.0))
    assert not bool(ok) and float(g["ewma_loss"]) == 1.0
    assert guard.diverged(g)
    g, ok = guard.apply(g, _t(1.1), _t(1.0))
    assert bool(ok) and int(g["consecutive_skips"]) == 0
    assert guard.diverged(g)  # sticky
    g, ok = guard.apply(g, _t(1.0), _t(1.0), update_finite=torch.tensor(False))
    assert not bool(ok)


def test_negative_loss_objective_not_flagged_as_spike():
    guard = AnomalyGuard(GuardConfig(
        ewma_alpha=0.5, warmup_steps=1, loss_spike_factor=2.0,
        max_consecutive_skips=2,
    ))
    g = guard.init_state()
    for loss in (-1.0, -0.9, -0.8):
        g, ok = guard.apply(g, _t(loss), _t(1.0))
        assert bool(ok), loss
    assert not guard.diverged(g)
    g, ok = guard.apply(g, _t(np.nan), _t(1.0))
    assert not bool(ok)


KINDS = ["nonfinite", "spikes", "negative", "sustained", "near-zero"]


def _sequence(kind: str, n: int = 60):
    """(loss, grad_norm, update_finite) arrays of one kind, from numpy."""
    rng = np.random.default_rng(KINDS.index(kind))
    loss = (3.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    gnorm = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    finite = np.ones(n, bool)
    if kind == "nonfinite":
        loss[rng.choice(n, 6, replace=False)] = np.nan
        loss[rng.choice(n, 3, replace=False)] = np.inf
        gnorm[rng.choice(n, 4, replace=False)] = -np.inf
        finite[rng.choice(n, 3, replace=False)] = False
    elif kind == "spikes":
        idx = rng.choice(np.arange(15, n), 8, replace=False)
        loss[idx[:4]] *= 10
        gnorm[idx[4:]] *= 50
    elif kind == "negative":
        loss = (-2.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
        loss[[20, 40]] = np.nan
    elif kind == "sustained":
        loss[30:45] = 1e4
        gnorm[50:] = np.nan
    elif kind == "near-zero":
        loss = np.abs(0.01 * rng.standard_normal(n)).astype(np.float32)
        loss[25] = 5.0
    return loss, gnorm, finite


@pytest.mark.parametrize("config", [
    dict(),
    dict(ewma_alpha=0.3, warmup_steps=3, loss_spike_factor=1.5,
         grad_spike_factor=2.0, max_consecutive_skips=2),
    dict(spike_slack=0.05, warmup_steps=0, max_consecutive_skips=4),
], ids=["defaults", "tight", "slack"])
@pytest.mark.parametrize("kind", KINDS)
def test_guard_matches_jax_on_shared_sequences(kind, config):
    loss, gnorm, finite = _sequence(kind)
    port = AnomalyGuard(GuardConfig(**config))
    ref = jguard.AnomalyGuard(jguard.GuardConfig(**config))
    g, jg = port.init_state(), ref.init_state()
    apply = jax.jit(ref.apply)
    verdicts = []
    for i in range(len(loss)):
        g, ok = port.apply(g, _t(loss[i]), _t(gnorm[i]),
                           update_finite=torch.tensor(bool(finite[i])))
        jg, jok = apply(jg, jnp.float32(loss[i]), jnp.float32(gnorm[i]),
                        jnp.bool_(finite[i]))
        assert bool(ok) == bool(jok), i
        verdicts.append(bool(ok))
        for key in ("accepted", "consecutive_skips", "skipped_total", "diverged"):
            assert int(g[key]) == int(jg[key]), (i, key)
        for key in ("ewma_loss", "ewma_grad_norm"):
            np.testing.assert_allclose(float(g[key]), float(jg[key]),
                                       rtol=EWMA_RTOL, atol=0, err_msg=f"{i} {key}")
        assert port.diverged(g) == ref.diverged(jg)
    # Each sequence exercises both verdicts.
    assert any(verdicts) and not all(verdicts)


# -- the guarded step --------------------------------------------------------------


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, TINY["vocab_size"], (BATCH, SEQ + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# Steps 1-2 warm the EWMA; from step 3 on every step is a "spike" (loss >
# 2·ewma − 100 holds for any loss near ln 128), so steps 3 and 4 are
# skipped and the second skip sets `diverged`: decisions with a margin of
# ~100, far from any rounding.
SKIPPING = dict(ewma_alpha=0.2, warmup_steps=2, spike_slack=-100.0,
                max_consecutive_skips=2)
TCFG = dict(batch_size=BATCH, learning_rate=1e-2, warmup_steps=1, total_steps=10,
            optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
            train_metrics="loss")


@pytest.fixture(scope="module")
def jax_guarded_run():
    """Four guarded adamw steps of the JAX Trainer on a tiny flash LM:
    the initial params, each step's metrics and the final params."""
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    trainer = jtrainer.Trainer(
        jtf.TransformerLM(cfg, mesh=mesh), jtrainer.TrainConfig(**TCFG), mesh,
        example_input_shape=(2, SEQ), example_input_dtype=jnp.int32,
        input_key="tokens", label_key="labels",
        guard=jguard.AnomalyGuard(jguard.GuardConfig(**SKIPPING)),
    )
    state = trainer.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, fnn.meta.unbox(state.params))
    step = trainer.make_train_step()
    metrics = []
    for batch in _batches(4):
        state, m = step(state, jax.tree.map(lambda x: jnp.asarray(x, jnp.int32), batch))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    final = jax.tree.map(np.asarray, fnn.meta.unbox(state.params))
    return init, metrics, final, int(state.step)


def _port_trainer(init=None, guard_config=SKIPPING, **changes):
    cfg = ttf.TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    model = ttf.TransformerLM(cfg, device="cpu")
    if init is not None:
        model.load_state_dict(convert.from_flax(init))
    return ttrainer.Trainer(
        model, ttrainer.TrainConfig(**{**TCFG, **changes}), input_key="tokens",
        label_key="labels", device="cpu",
        guard=AnomalyGuard(GuardConfig(**guard_config)),
    )


def test_guarded_step_matches_jax_trainer(jax_guarded_run):
    init, jmetrics, jfinal, jstep = jax_guarded_run
    trainer = _port_trainer(init)
    state, step = trainer.init_state(), trainer.make_train_step()
    metrics = []
    for batch in _batches(4):
        state, m = step(state, _torch_batch(batch))
        metrics.append(m)
    assert int(state.step) == jstep == 4
    np.testing.assert_allclose([float(m["loss"]) for m in metrics],
                               [float(m["loss"]) for m in jmetrics], **TOL)
    np.testing.assert_allclose([float(m["grad_norm"]) for m in metrics],
                               [float(m["grad_norm"]) for m in jmetrics], **TOL)
    for key in ("guard_ok", "guard_skipped_total", "guard_consecutive_skips",
                "guard_diverged"):
        assert [int(m[key]) for m in metrics] == [int(m[key]) for m in jmetrics], key
    assert [int(m["guard_ok"]) for m in metrics] == [1, 1, 0, 0]
    assert int(state.opt_state["count"]) == 2  # the skipped updates never count
    # Two applied adamw steps: the unguarded test's bound, 2·lr a step.
    final = convert.from_flax(jfinal)
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=2 * TCFG["learning_rate"] * 2, rtol=0,
                                   err_msg=name)


def test_guarded_step_skips_poison_batch_without_touching_state():
    trainer = _port_trainer(guard_config=dict(ewma_alpha=0.2, warmup_steps=2,
                                              loss_spike_factor=3.0,
                                              grad_spike_factor=6.0,
                                              max_consecutive_skips=3))
    state, step = trainer.init_state(), trainer.make_train_step()
    batches = [_torch_batch(b) for b in _batches(4, seed=1)]
    for batch in batches[:3]:
        state, metrics = step(state, batch)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    opt_before = ttrainer.map_tensors(torch.clone, state.opt_state)
    hook = _poison(trainer.model)
    try:
        state, metrics = step(state, batches[3])
    finally:
        hook.remove()
    assert not np.isfinite(float(metrics["loss"]))
    assert int(metrics["guard_ok"]) == 0
    assert int(metrics["guard_skipped_total"]) == 1
    assert int(state.step) == 4  # the step count advances...
    for name, p in trainer.model.named_parameters():  # ...nothing else moves
        assert torch.equal(p, before[name]), name
    for group in ("mu", "nu"):
        for name, t in state.opt_state[group].items():
            assert torch.equal(t, opt_before[group][name]), (group, name)
    assert torch.equal(state.opt_state["count"], opt_before["count"])
    assert all(torch.isfinite(p).all() for p in trainer.model.parameters())


def test_nonfinite_update_is_rejected():
    """A finite loss and gradient whose update leaves a parameter
    non-finite (an optimizer that overflows one element, stood in for by
    a wrapper that writes inf after the real update): the verdict screens
    the updated parameters too, so the step is skipped, the parameters
    keep their values and the optimizer state its own."""
    trainer = _port_trainer()
    real_step = trainer.tx.step

    def overflowing(params, grads, opt_state):
        out = real_step(params, grads, opt_state)
        next(iter(params.values())).view(-1)[0] = float("inf")
        return out

    trainer.tx.step = overflowing
    state, step = trainer.init_state(), trainer.make_train_step()
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state, metrics = step(state, _torch_batch(_batches(1, seed=2)[0]))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert int(metrics["guard_ok"]) == 0
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, before[name]), name
    assert int(state.opt_state["count"]) == 0


def test_unguarded_step_is_unchanged_by_the_guard_code():
    """Without a guard the step takes the old path: the same losses and
    bitwise the same parameters as a guarded trainer whose guard accepts
    every step."""
    accept = dict(warmup_steps=10_000)
    plain = _port_trainer()
    plain.guard = None
    guarded = _port_trainer(guard_config=accept)
    results = []
    for trainer in (plain, guarded):
        state, step = trainer.init_state(), trainer.make_train_step()
        losses = []
        for batch in _batches(3, seed=3):
            state, metrics = step(state, _torch_batch(batch))
            losses.append(float(metrics["loss"]))
        results.append((losses, [p.detach() for p in trainer.model.parameters()]))
    assert results[0][0] == results[1][0]
    for a, b in zip(results[0][1], results[1][1]):
        assert torch.equal(a, b)
    assert dataclasses.fields(ttrainer.TrainState)[-1].name == "guard"
