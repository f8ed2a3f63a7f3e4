"""The port's `fit()` against the JAX package's training loop.

A tiny flash LM (2 layers, d_model 64, S = 128) on the CPU. JAX's `fit`
and the port's run the same guarded steps on the same numpy batches from
converted weights: the logged losses at the unguarded step's tolerance
(tests/test_torch_trainer.py, atol = rtol = 5e-5), the same skip counts.
The rest mirrors tests/test_guard.py's loop cases: preemption and resume
(bitwise equal to an uninterrupted run on the CPU), a NaN between saves
never persisted, rollback with a perturbed stream, and the refusals. The
LM's inputs are tokens, so a step is poisoned through the model: a
forward pre-hook on the first block multiplies the embedding output by
NaN, and a forward hook scales the logits for a loss spike.
"""

import os
import signal

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.parallel import MeshSpec, build_mesh
from kubeflow_tpu.train import guard as jguard
from kubeflow_tpu.train import loop as jloop
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.train import (
    AnomalyGuard,
    Checkpointer,
    ElasticResize,
    GuardConfig,
    Preempted,
    SyntheticTokens,
    TrainConfig,
    Trainer,
    TrainingDiverged,
    fit,
)
from kubeflow_tpu_torch.train.checkpoint import verify_manifest

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64, remat_policy="none")
SEQ, BATCH = 128, 4
TOL = dict(atol=5e-5, rtol=5e-5)
GUARD = dict(ewma_alpha=0.2, warmup_steps=2, loss_spike_factor=3.0,
             grad_spike_factor=6.0, max_consecutive_skips=3)
TCFG = dict(batch_size=BATCH, learning_rate=1e-2, warmup_steps=1, total_steps=20,
            optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
            train_metrics="loss")


def _trainer(guard=True, init=None):
    cfg = ttf.TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    model = ttf.TransformerLM(cfg, device="cpu")
    if init is not None:
        model.load_state_dict(convert.from_flax(init))
    return Trainer(model, TrainConfig(**TCFG), input_key="tokens", label_key="labels",
                   device="cpu", guard=AnomalyGuard(GuardConfig(**GUARD)) if guard else None)


def _stream(vary=True):
    return SyntheticTokens(BATCH, SEQ, TINY["vocab_size"], vary_per_step=vary,
                           device="cpu")


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


class Poisoned:
    """A resumable token stream that poisons the steps its scheduled
    positions feed: at `nan_at` the model's embedding output is multiplied
    by NaN; under salt 0, from position `spike_from` on, its logits are
    multiplied by `scale` (a sustained loss spike that a perturbed salt
    cures, unless `cured` is False). The hooks read the factor set as
    each batch is yielded, just before the step that takes it."""

    def __init__(self, inner, model, nan_at=(), spike_from=None, scale=1e3,
                 cured=True):
        self.inner, self.nan_at, self.spike_from, self.scale = (
            inner, frozenset(nan_at), spike_from, scale)
        self.cured = cured
        self.embed = self.logits = 1.0
        model.layers[0].register_forward_pre_hook(
            lambda module, args: (args[0] * self.embed, *args[1:]))
        model.register_forward_hook(lambda module, args, out: out * self.logits)
        if getattr(inner, "perturb", None) is None:
            self.perturb = None

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, state):
        self.inner.load_state_dict(state)

    def perturb(self, salt):
        self.inner.perturb(salt)

    def __iter__(self):
        for batch in self.inner:
            state = self.inner.state_dict()
            pos = state["position"] - 1
            self.embed = float("nan") if pos in self.nan_at else 1.0
            spike = (self.spike_from is not None and pos >= self.spike_from
                     and (state["salt"] == 0 or not self.cured))
            self.logits = self.scale if spike else 1.0
            yield batch


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    return tree is None or bool(torch.isfinite(tree.float()).all())


# -- against JAX ---------------------------------------------------------------------


def _batches(n):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        toks = rng.integers(0, TINY["vocab_size"], (BATCH, SEQ + 1))
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def test_fit_matches_jax_fit_on_the_same_batches():
    """Four guarded steps of each `fit` over the same numpy batches (a
    list: no resumable protocol): the logged losses and grad norms agree,
    nothing is skipped on either side."""
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    mesh = build_mesh(MeshSpec(dp=-1), devices=jax.devices()[:1])
    jtr = jtrainer.Trainer(
        jtf.TransformerLM(cfg, mesh=mesh), jtrainer.TrainConfig(**TCFG), mesh,
        example_input_shape=(2, SEQ), example_input_dtype=jnp.int32,
        input_key="tokens", label_key="labels",
        guard=jguard.AnomalyGuard(jguard.GuardConfig(**GUARD)),
    )
    init = jax.tree.map(np.asarray, fnn.meta.unbox(
        jtr.init_state(jax.random.PRNGKey(0)).params))
    batches = _batches(4)
    want = jloop.fit(jtr, [jax.tree.map(lambda x: jnp.asarray(x, jnp.int32), b)
                           for b in batches], 4, rng=jax.random.PRNGKey(0),
                     log_every=1, handle_signals=False)
    got = fit(_trainer(init=init), [{k: torch.from_numpy(v) for k, v in b.items()}
                                    for b in batches], 4, log_every=1,
              handle_signals=False)
    assert [r["step"] for r in got.history] == [r["step"] for r in want.history]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([r[key] for r in got.history],
                                   [r[key] for r in want.history], err_msg=key, **TOL)
    for key in ("guard_skipped_total", "rollbacks"):
        assert [r[key] for r in got.history] == [r[key] for r in want.history] == [0] * 4
    assert got.steps_done == want.steps_done == 4
    assert got.resumed_from is want.resumed_from is None


# -- preemption and resume ----------------------------------------------------------


def test_sigterm_returns_preempted_after_emergency_save(tmp_path):
    trainer = _trainer()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=100)

    def on_metrics(step, rec):
        if step == 4:
            os.kill(os.getpid(), signal.SIGTERM)

    result = fit(trainer, _stream(), total_steps=12, checkpointer=ckpt,
                 log_every=1, on_metrics=on_metrics)
    assert isinstance(result, Preempted) and result.signum == signal.SIGTERM
    assert ckpt.latest_step() == 5  # the boundary after the signal
    assert verify_manifest(tmp_path / "ck" / "5")["data_state"] == {"position": 5,
                                                                     "salt": 0}
    ckpt.close()

    data_b = _stream()
    ckpt_b = Checkpointer(tmp_path / "ck", save_interval_steps=100)
    result_b = fit(_trainer(), data_b, total_steps=12, checkpointer=ckpt_b, log_every=1)
    ckpt_b.close()
    assert not isinstance(result_b, Preempted)
    assert result_b.resumed_from == 5 and result_b.steps_done == 7
    assert data_b.state_dict()["position"] == 12
    assert int(result_b.state.step) == 12


def test_resume_with_data_state_matches_uninterrupted(tmp_path):
    """SIGTERM at step 3 (saves every 2): `Preempted` at step 4 after its
    save; a second fit() resumes there, and the parameters, optimizer and
    guard state after step 6 equal an uninterrupted run's bitwise, over
    the same batch positions."""
    straight = _trainer()
    fit(straight, _stream(), total_steps=6, rng=0, log_every=1)

    def sigterm_at_3(step, rec):
        if step == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer = _trainer()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=2)
    first = fit(trainer, _stream(), total_steps=6, rng=0, checkpointer=ckpt,
                log_every=1, on_metrics=sigterm_at_3)
    assert isinstance(first, Preempted) and int(first.state.step) == 4
    assert ckpt.all_steps() == [2, 4]
    ckpt.close()

    data = _stream()
    ckpt2 = Checkpointer(tmp_path / "ck", save_interval_steps=2)
    resumed = fit(trainer, data, total_steps=6, rng=1, checkpointer=ckpt2, log_every=1)
    ckpt2.close()
    assert resumed.resumed_from == 4 and data.state_dict()["position"] == 6
    want = straight.model.state_dict()
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, want[name]), name


def test_signal_handlers_are_restored_after_fit():
    before = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    fit(_trainer(), _stream(), total_steps=2, log_every=1)
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before


# -- the guard in the loop ------------------------------------------------------------


def test_nan_at_non_log_step_never_persisted(tmp_path):
    """A NaN at step 3 with log_every=50: the guard skips it on the
    device, and every checkpoint ever written holds finite state."""
    trainer = _trainer()
    data = Poisoned(_stream(), trainer.model, nan_at=(2,))  # step 3's batch
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=5, max_to_keep=5)
    result = fit(trainer, data, total_steps=10, checkpointer=ckpt, log_every=50)
    ckpt.close()
    assert result.history[-1]["guard_skipped_total"] == 1
    steps = ckpt.all_steps()
    assert steps == [5, 10]
    for step in steps:
        for name in os.listdir(tmp_path / "ck" / str(step)):
            if name.endswith(".pt"):
                tree = torch.load(tmp_path / "ck" / str(step) / name, weights_only=True)
                assert _all_finite(tree), (step, name)


def test_sustained_divergence_rolls_back_with_seed_perturbation(tmp_path):
    """Under salt 0 every batch from position 6 on spikes: three skips in
    a row flag divergence at step 9, fit rolls back to the step-5
    checkpoint and perturbs the stream; under salt 1 the run completes.
    The perturbed salt is durable in step 5's manifest."""
    trainer = _trainer()
    data = Poisoned(_stream(), trainer.model, spike_from=6)
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=5)
    result = fit(trainer, data, total_steps=12, checkpointer=ckpt, log_every=1)
    ckpt.close()
    assert result.rollbacks == 1
    assert int(result.state.step) == 12
    assert _all_finite(result.state.state_dict())
    assert data.state_dict()["salt"] == 1
    manifest = verify_manifest(tmp_path / "ck" / "5")
    assert manifest["data_state"] == {"position": 5, "salt": 1}


def test_rollback_refuses_fixed_stream_without_perturb(tmp_path):
    trainer = _trainer()
    fixed = _stream(vary=False)
    assert fixed.perturb is None
    data = Poisoned(fixed, trainer.model, spike_from=6)
    assert data.perturb is None
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=5)
    with pytest.raises(TrainingDiverged, match="perturbable"):
        fit(trainer, data, total_steps=12, checkpointer=ckpt, log_every=1)
    ckpt.close()


def test_sustained_divergence_without_checkpoint_raises():
    trainer = _trainer()
    data = Poisoned(_stream(), trainer.model, spike_from=6)
    with pytest.raises(TrainingDiverged, match="divergence"):
        fit(trainer, data, total_steps=12, log_every=1)


def test_rollback_budget_is_bounded(tmp_path):
    """A spike that no salt cures: after max_rollbacks rollbacks fit
    raises instead of retrying forever."""
    trainer = _trainer()
    data = Poisoned(_stream(), trainer.model, spike_from=6, cured=False)
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=5)
    with pytest.raises(TrainingDiverged, match="after 1 rollback"):
        fit(trainer, data, total_steps=12, checkpointer=ckpt, log_every=1,
            max_rollbacks=1)
    ckpt.close()
    assert data.state_dict()["salt"] == 1


def test_nonfinite_loss_without_guard_raises_before_saving(tmp_path):
    trainer = _trainer(guard=False)
    data = Poisoned(_stream(), trainer.model, nan_at=(3,))
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=2)
    with pytest.raises(TrainingDiverged, match="non-finite loss"):
        fit(trainer, data, total_steps=8, checkpointer=ckpt, log_every=1)
    ckpt.close()
    assert ckpt.all_steps() == [2]


# -- edges and refusals ----------------------------------------------------------------


def test_fit_without_checkpointer():
    result = fit(_trainer(), _stream(), total_steps=3, log_every=1)
    assert result.steps_done == 3 and result.resumed_from is None
    assert len(result.history) == 3 and int(result.state.step) == 3


def test_fit_noop_when_already_past_total_steps(tmp_path):
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=2)
    fit(_trainer(), _stream(), total_steps=4, checkpointer=ckpt, log_every=1)
    ckpt.close()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=2)
    result = fit(_trainer(), _stream(), total_steps=3, checkpointer=ckpt)
    ckpt.close()
    assert result.steps_done == 0 and result.resumed_from == 4 and result.history == []


def test_fit_short_data_raises():
    with pytest.raises(ValueError, match="exhausted at step 2"):
        fit(_trainer(), [next(iter(_stream()))] * 2, total_steps=4, log_every=1)


def test_fit_draws_parameters_from_an_explicit_generator():
    """rng: a seed or a `torch.Generator` draws the parameters anew (the
    same seed, the same draw); None keeps the model's."""
    a, b = _trainer(), _trainer()
    fit(a, _stream(), total_steps=1, rng=torch.Generator().manual_seed(7), log_every=1)
    fit(b, _stream(), total_steps=1, rng=7, log_every=1)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    keep = _trainer()
    before = _params(keep)
    keep.init_state()
    assert all(torch.equal(p, before[n]) for n, p in keep.model.named_parameters())


def test_elastic_resize_is_refused():
    elastic = ElasticResize(mesh_factory=lambda dp: None,
                            data_factory=lambda mesh, data: data,
                            propose=lambda step, preempted: None)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        fit(_trainer(), _stream(), total_steps=1, elastic=elastic)
