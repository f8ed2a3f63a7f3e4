"""Training ResNet in the port against the JAX package's `Trainer`, on the CPU.

`tiny_resnet` (f32, 32x32, batch 8) with the same numpy weights on both
sides (tests/test_torch_resnet.py's `flax_weights`, converted for the
port) and the same numpy batches: three SGD-Nesterov steps (the bench's
optimizer: momentum 0.9, weight decay on matrices only, label smoothing
0.1) against JAX's `Trainer` on a one-device mesh, once at accum_steps=1
and once at 2, where each microbatch reads the statistics the one before
it left. Loss, parameters, momentum and running statistics are held at
atol = rtol = 1e-4. Then the anomaly guard: a NaN batch and a finite
batch whose variance overflows the running statistics (loss finite,
statistics not) are skipped by both frameworks, and the port's skip
leaves parameters, momentum and statistics bitwise unchanged. Then the
data stream, the checkpoint layout, `fit()`'s bitwise resume and its
rollback, which restores the statistics.
"""

import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_resnet import flax_weights  # noqa: E402

from kubeflow_tpu.models import resnet as jr  # noqa: E402
from kubeflow_tpu.parallel import MeshSpec, build_mesh  # noqa: E402
from kubeflow_tpu.train import guard as jguard  # noqa: E402
from kubeflow_tpu.train import trainer as jtrainer  # noqa: E402
from kubeflow_tpu_torch.models import convert  # noqa: E402
from kubeflow_tpu_torch.models import resnet as tr  # noqa: E402
from kubeflow_tpu_torch.models import transformer as ttf  # noqa: E402
from kubeflow_tpu_torch.train import (  # noqa: E402
    AnomalyGuard,
    Checkpointer,
    GuardConfig,
    Preempted,
    SyntheticImages,
    TrainConfig,
    Trainer,
    fit,
)
from kubeflow_tpu_torch.train.trainer import batch_stats  # noqa: E402

BATCH, SIDE, CLASSES, STEPS = 8, 32, 10, 3
TOL = dict(atol=1e-4, rtol=1e-4)
TCFG = dict(batch_size=BATCH, learning_rate=0.1, warmup_steps=1, total_steps=20,
            fsdp_params=False)
GUARD = dict(ewma_alpha=0.2, warmup_steps=2, loss_spike_factor=3.0,
             grad_spike_factor=6.0, max_consecutive_skips=3)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH)} for _ in range(n)]


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_batch(batch):
    return {"image": jnp.asarray(batch["image"]),
            "label": jnp.asarray(batch["label"], jnp.int32)}


@pytest.fixture(scope="module")
def weights():
    return flax_weights(jr.tiny_resnet(), SIDE)


def _jax_trainer(weights, guard=None, **changes):
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    trainer = jtrainer.Trainer(
        jr.tiny_resnet(), jtrainer.TrainConfig(**{**TCFG, **changes}), mesh,
        example_input_shape=(2, SIDE, SIDE, 3), guard=guard)
    state = trainer.init_state(jax.random.PRNGKey(0))
    params, stats = weights
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    return trainer, state


def _port_trainer(weights, guard=None, **changes):
    model = tr.tiny_resnet(device="cpu")
    model.load_state_dict(convert.resnet_from_flax(*weights))
    return Trainer(model, TrainConfig(**{**TCFG, **changes}), device="cpu", guard=guard)


def _snapshot(trainer, state):
    return {
        "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
        "trace": {n: t.clone() for n, t in state.opt_state["trace"].items()},
        "stats": {n: b.clone() for n, b in batch_stats(trainer.model).items()},
    }


def _assert_bitwise(a, b):
    for group in a:
        for name in a[group]:
            assert torch.equal(a[group][name], b[group][name]), (group, name)


@pytest.mark.parametrize("accum", [1, 2])
def test_sgd_steps_match_jax_trainer(weights, accum):
    batches = _batches(STEPS)
    jt, jstate = _jax_trainer(weights, accum_steps=accum)
    jstep = jt.make_train_step()
    jlosses = []
    for batch in batches:
        jstate, metrics = jstep(jstate, _jax_batch(batch))
        jlosses.append(float(metrics["loss"]))

    trainer = _port_trainer(weights, accum_steps=accum)
    state, step = trainer.init_state(), trainer.make_train_step()
    losses = []
    for batch in batches:
        state, metrics = step(state, _torch_batch(batch))
        losses.append(metrics["loss"].item())
    assert int(state.step) == STEPS == int(jstate.step)
    np.testing.assert_allclose(losses, jlosses, **TOL)
    unbox = lambda tree: jax.tree.map(np.asarray, tree)
    want = {
        "params": convert.resnet_from_flax(unbox(jstate.params)),
        "trace": convert.resnet_from_flax(unbox(jstate.opt_state[1][0].trace)),
        "stats": convert.resnet_from_flax({}, unbox(jstate.batch_stats)),
    }
    got = _snapshot(trainer, state)
    assert int(state.opt_state["count"]) == STEPS
    for group, tensors in want.items():
        assert set(tensors) == set(got[group])
        for name, value in tensors.items():
            np.testing.assert_allclose(got[group][name].numpy(), value.numpy(),
                                       err_msg=f"{group} {name}", **TOL)


def test_step_remat_full_moves_the_statistics_once(weights):
    batch = _torch_batch(_batches(1)[0])
    plain = _port_trainer(weights)
    remat = _port_trainer(weights, step_remat="full")
    s_plain, m_plain = plain.make_train_step()(plain.init_state(), batch)
    s_remat, m_remat = remat.make_train_step()(remat.init_state(), batch)
    torch.testing.assert_close(m_remat["loss"], m_plain["loss"], atol=0, rtol=0)
    a, b = _snapshot(plain, s_plain), _snapshot(remat, s_remat)
    for group in a:
        for name in a[group]:
            torch.testing.assert_close(b[group][name], a[group][name], atol=1e-6,
                                       rtol=1e-6, msg=f"{group} {name}")


def test_eval_step_runs_in_eval_mode_and_matches_jax(weights):
    batch = _batches(1, seed=4)[0]
    jt, jstate = _jax_trainer(weights)
    want = jt.make_eval_step()(jstate, _jax_batch(batch))
    trainer = _port_trainer(weights)
    state = trainer.init_state()
    before = {n: b.clone() for n, b in batch_stats(trainer.model).items()}
    got = trainer.make_eval_step()(state, _torch_batch(batch))
    assert not trainer.model.training
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **TOL)
    assert got["accuracy"].item() == float(want["accuracy"])
    for name, value in batch_stats(trainer.model).items():
        assert torch.equal(value, before[name]), name
    trainer.make_train_step()(state, _torch_batch(batch))
    assert trainer.model.training


@pytest.mark.parametrize("poison", ["nan", "overflow"])
def test_guard_skip_keeps_params_momentum_and_statistics(weights, poison):
    """A NaN batch, and a finite one (images x 1e20) whose batch variance
    overflows the running statistics while the loss stays finite: both
    frameworks skip it, and the port's state is bitwise unchanged."""
    clean, bad = _batches(2, seed=5)
    bad = dict(bad, image=bad["image"] * (np.float32(np.nan) if poison == "nan"
                                          else np.float32(1e20)))
    jt, jstate = _jax_trainer(weights, guard=jguard.AnomalyGuard(jguard.GuardConfig(**GUARD)))
    jstep = jt.make_train_step()
    jstate, _ = jstep(jstate, _jax_batch(clean))
    jstate, jmetrics = jstep(jstate, _jax_batch(bad))
    assert int(jmetrics["guard_ok"]) == 0

    trainer = _port_trainer(weights, guard=AnomalyGuard(GuardConfig(**GUARD)))
    state, step = trainer.init_state(), trainer.make_train_step()
    state, metrics = step(state, _torch_batch(clean))
    assert int(metrics["guard_ok"]) == 1
    kept = _snapshot(trainer, state)
    state, metrics = step(state, _torch_batch(bad))
    assert int(metrics["guard_ok"]) == 0
    assert int(metrics["guard_skipped_total"]) == 1 and int(state.step) == 2
    assert np.isfinite(metrics["loss"].item()) == (poison == "overflow")
    assert int(state.opt_state["count"]) == 1
    _assert_bitwise(_snapshot(trainer, state), kept)
    state, metrics = step(state, _torch_batch(clean))  # the next step applies
    assert int(metrics["guard_ok"]) == 1


def test_synthetic_images_protocol():
    data = SyntheticImages(4, image_size=8, num_classes=5, seed=3,
                           dtype=torch.bfloat16, vary_per_step=True, device="cpu")
    it = iter(data)
    first, second = next(it), next(it)
    assert first["image"].shape == (4, 8, 8, 3) and first["image"].dtype == torch.bfloat16
    assert first["label"].dtype == torch.int64
    assert int(first["label"].min()) >= 0 and int(first["label"].max()) < 5
    assert not torch.equal(first["image"], second["image"])
    assert data.state_dict() == {"position": 2, "salt": 0}
    again = SyntheticImages(4, image_size=8, num_classes=5, seed=3,
                            dtype=torch.bfloat16, vary_per_step=True, device="cpu")
    again.load_state_dict({"position": 1, "salt": 0})
    assert torch.equal(next(iter(again))["image"], second["image"])
    again.perturb(7)
    assert again.state_dict() == {"position": 2, "salt": 7}
    assert not torch.equal(next(iter(again))["image"], next(iter(data))["image"])
    fixed = SyntheticImages(2, image_size=4, device="cpu")
    assert fixed.perturb is None and not fixed.vary_per_step
    a, b = next(iter(fixed)), next(iter(fixed))
    assert a is b and a["image"].dtype == torch.float32
    with pytest.raises(ValueError):
        SyntheticImages(0, device="cpu")


def test_state_carries_batch_stats_and_the_lm_layout_is_unchanged(weights, tmp_path):
    trainer = _port_trainer(weights, guard=AnomalyGuard())
    state = trainer.init_state()
    tree = state.state_dict()
    assert set(tree) == {"step", "params", "opt_state", "guard", "batch_stats"}
    assert set(tree["batch_stats"]) == set(batch_stats(trainer.model))
    assert set(trainer.abstract_state()) == set(tree)
    ckpt = Checkpointer(tmp_path / "ckpt")
    ckpt.save(1, state, force=True)
    ckpt.wait()
    assert sorted(os.listdir(tmp_path / "ckpt" / "1")) == [
        "batch_stats.pt", "guard.pt", "kftpu_manifest.json", "opt_state.pt",
        "params.pt", "step.pt"]
    lm = ttf.TransformerLM(ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                                                 n_heads=2, head_dim=16, d_ff=64,
                                                 dtype=torch.float32), device="cpu")
    lm_trainer = Trainer(lm, TrainConfig(**TCFG), device="cpu")
    assert set(lm_trainer.init_state().state_dict()) == {"step", "params", "opt_state", "guard"}
    assert set(lm_trainer.abstract_state()) == {"step", "params", "opt_state", "guard"}
    with pytest.raises(KeyError, match="batch_stats"):
        trainer.load_state_dict({**tree, "batch_stats": {}})


def _stream():
    return SyntheticImages(BATCH, SIDE, CLASSES, vary_per_step=True, device="cpu")


def test_fit_resume_is_bitwise(weights, tmp_path):
    def run(ckpt, total, **kw):
        trainer = _port_trainer(weights, guard=AnomalyGuard(GuardConfig(**GUARD)))
        result = fit(trainer, _stream(), total, checkpointer=ckpt, log_every=1, **kw)
        return trainer, result

    trainer, straight = run(None, 4)
    want = _snapshot(trainer, straight.state)

    def sigterm(step, rec):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    ckpt = Checkpointer(tmp_path / "ckpt", save_interval_steps=2)
    _, first = run(ckpt, 4, on_metrics=sigterm)
    assert isinstance(first, Preempted) and int(first.state.step) == 2
    assert ckpt.all_steps() == [2]
    trainer, resumed = run(Checkpointer(tmp_path / "ckpt", save_interval_steps=2), 4)
    assert resumed.resumed_from == 2 and int(resumed.state.step) == 4
    _assert_bitwise(_snapshot(trainer, resumed.state), want)
    assert any(not torch.equal(want["stats"][n], b)
               for n, b in convert.resnet_from_flax({}, weights[1]).items())


class SpikeFrom:
    """A resumable image stream whose logits are multiplied by 1e3 from
    position `start` on while its salt is 0 (a sustained loss spike that
    a perturbed salt cures)."""

    def __init__(self, inner, model, start):
        self.inner, self.start, self.scale = inner, start, 1.0
        model.register_forward_hook(lambda module, args, out: out * self.scale)

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)

    def perturb(self, salt):
        self.inner.perturb(salt)

    def __iter__(self):
        for batch in self.inner:
            state = self.inner.state_dict()
            spike = state["position"] - 1 >= self.start and state["salt"] == 0
            self.scale = 1e3 if spike else 1.0
            yield batch


def test_rollback_restores_the_statistics(weights, tmp_path):
    """Saved at step 4, step 5 accepted (statistics move), steps 6-8
    spike and are skipped, the guard declares divergence at 8 (before
    any save there): the rollback puts the step-4 statistics back, and
    the run finishes on the perturbed stream."""
    trainer = _port_trainer(weights, guard=AnomalyGuard(GuardConfig(**GUARD)))
    seen, restored = {}, []
    load = trainer.load_state_dict

    def spy(state):
        out = load(state)
        restored.append({n: b.clone() for n, b in batch_stats(trainer.model).items()})
        return out

    trainer.load_state_dict = spy

    def record(step, rec):
        seen[step] = {n: b.clone() for n, b in batch_stats(trainer.model).items()}

    result = fit(trainer, SpikeFrom(_stream(), trainer.model, 5), 10,
                 checkpointer=Checkpointer(tmp_path / "ckpt", save_interval_steps=4),
                 log_every=1, on_metrics=record, handle_signals=False)
    assert result.rollbacks == 1 and int(result.state.step) == 10
    assert len(restored) == 1
    for name, value in restored[0].items():
        assert torch.equal(value, seen[4][name]), name
    assert any(not torch.equal(seen[5][n], seen[4][n]) for n in seen[4])
    assert all(torch.isfinite(b).all() for b in batch_stats(trainer.model).values())


def test_sgd_foreach_keeps_optax_order_on_a_decayed_subset():
    """Decay only on the matrices, one Nesterov update, against the
    per-tensor formula."""
    from kubeflow_tpu_torch.train.trainer import SGD

    rng = np.random.default_rng(9)
    params = {"w": torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(2).astype(np.float32))}
    grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
             for n, p in params.items()}
    opt = SGD(lambda count: torch.tensor(0.5), weight_decay=0.1, momentum=0.9)
    state = opt.init(params)
    state["trace"] = {n: torch.ones_like(p) for n, p in params.items()}
    want = {}
    for n, p in params.items():
        g = grads[n] + 0.1 * p if p.dim() > 1 else grads[n]
        t = g + 0.9 * state["trace"][n]
        want[n] = (p - 0.5 * (g + 0.9 * t), t)
    state = opt.step(params, grads, state)
    for n, (p, t) in want.items():
        torch.testing.assert_close(params[n], p)
        torch.testing.assert_close(state["trace"][n], t)
    assert int(state["count"]) == 1
