"""The port's selective remat policies against the JAX package's.

"dots", "attn" and "flash", as the per-block policy and as the trainer's
whole-step ``step_remat``: loss and every gradient against JAX's under
the same policy (its Pallas flash in interpret mode) at f32 atol = rtol
= 5e-5, and against the port's "none". Then what each policy keeps and
recomputes, read off the ops the port runs:

- the flash forwards a train step runs, counted at the flash wrapper
  that `ops.flash.FLASH_FWD_OP` calls (on the CPU its plain version):
  one per layer where the backward runs none ("none", "mlp", "flash"),
  two where it runs one again ("full", "dots", "attn");
- the bytes a forward leaves alive for its backward, by storage: "attn"
  keeps each layer's attention output beyond "full", "flash" its (o,
  lse), and "flash" less than "mlp" in all. Bytes are read by storage
  weak references to every op's output, not by `saved_tensors_hooks`: a
  checkpoint keeps its policy's outputs in a cache of its own, which no
  pack hook sees;
- the 2-D products (`aten.mm`) the backward runs: "dots" recomputes
  none of the forward's, and every batched one (`aten.bmm`).
"""

import gc

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.train import trainer as jtrainer
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.ops import flash
from kubeflow_tpu_torch.train import trainer as ttrainer

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64)
BATCH, SEQ = 2, 128
TOL = dict(atol=5e-5, rtol=5e-5)


def _tokens(seed):
    toks = np.random.default_rng(seed).integers(0, TINY["vocab_size"], (BATCH, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


@pytest.fixture(scope="module")
def params():
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    variables = jtf.TransformerLM(cfg).init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))


def _port_model(params, policy="none", attention_impl="flash", **changes):
    cfg = ttf.TransformerConfig(**{**TINY, **changes}, dtype=torch.float32,
                                attention_impl=attention_impl, remat_policy=policy)
    model = ttf.TransformerLM(cfg, device="cpu")
    if params is not None:
        model.load_state_dict(convert.from_flax(params))
    return model


def _jax_loss_grads(params, tokens, labels, policy, step_remat):
    cfg = jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash",
                                remat_policy=policy)
    model = jtf.TransformerLM(cfg)

    def forward(p):
        return model.apply({"params": p}, jnp.asarray(tokens))

    if step_remat is not None:  # as JAX's Trainer wraps its forward
        forward = jax.checkpoint(forward, policy=jtf.checkpoint_policy(step_remat))

    def loss_fn(p):
        return jtrainer.softmax_cross_entropy(forward(p), jnp.asarray(labels))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), convert.from_flax(jax.tree.map(np.asarray, grads))


def _port_loss_grads(model, tokens, labels, step_remat=None):
    inputs = torch.from_numpy(tokens)
    if step_remat is None:
        logits = model(inputs)
    else:  # as the port's Trainer wraps its forward
        logits = checkpoint(model, inputs, use_reentrant=False,
                            context_fn=ttf.checkpoint_policy(step_remat))
    loss = ttrainer.softmax_cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


@pytest.mark.parametrize("where", ["block", "step"])
@pytest.mark.parametrize("policy", ["dots", "attn", "flash"])
def test_policy_matches_jax_and_none(params, policy, where):
    tokens, labels = _tokens(0)
    block, step = (policy, None) if where == "block" else ("none", policy)
    want_loss, want = _jax_loss_grads(params, tokens, labels, block, step)
    loss, grads = _port_loss_grads(_port_model(params, block), tokens, labels, step)
    none_loss, none = _port_loss_grads(_port_model(params), tokens, labels)
    np.testing.assert_allclose(loss, want_loss, **TOL)
    assert loss == none_loss
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), none[name].numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)


# -- what each policy runs and keeps ------------------------------------------------


@pytest.fixture
def flash_forwards(monkeypatch):
    """Counts the flash forwards run (`FLASH_FWD_OP` calls the wrapper)."""
    calls = [0]
    wrapper = flash.flash_fwd

    def counted(*args, **kwargs):
        calls[0] += 1
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(flash, "flash_fwd", counted)
    return calls


def _train_step(model, step_remat=None):
    trainer = ttrainer.Trainer(
        model, ttrainer.TrainConfig(batch_size=BATCH, optimizer="adamw",
                                    learning_rate=1e-2, warmup_steps=0,
                                    label_smoothing=0.0, train_metrics="loss",
                                    step_remat=step_remat),
        input_key="tokens", label_key="labels", device="cpu")
    tokens, labels = _tokens(1)
    state, metrics = trainer.make_train_step()(trainer.init_state(), {
        "tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)})
    return metrics["loss"].item(), dict(state.model.named_parameters())


@pytest.mark.parametrize("block,step,per_layer", [
    ("none", None, 1), ("mlp", None, 1), ("flash", None, 1),
    ("full", None, 2), ("dots", None, 2), ("attn", None, 2),
    ("none", "full", 2), ("none", "dots", 2), ("none", "attn", 2),
    ("none", "flash", 1),
])
def test_train_step_runs_the_flash_forwards_its_policy_keeps(
        params, flash_forwards, block, step, per_layer):
    """A train step's flash forwards: one per layer where the backward
    reruns none, two where it reruns each; the step's loss and update
    are those of the step without remat."""
    want_loss, want = _train_step(_port_model(params))
    flash_forwards[0] = 0
    loss, got = _train_step(_port_model(params, block), step)
    assert flash_forwards[0] == per_layer * TINY["n_layers"], (block, step)
    np.testing.assert_allclose(loss, want_loss, atol=1e-6, rtol=1e-6)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


class _Recorder(TorchDispatchMode):
    """Counts the ops run, and keeps a weak reference to every output's
    storage."""

    def __init__(self):
        super().__init__()
        self.ops, self.storages = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                self.storages.append(
                    (StorageWeakRef(storage), storage.data_ptr(), storage.nbytes()))
        return out

    def alive_bytes(self) -> int:
        gc.collect()
        alive = {ptr: n for ref, ptr, n in self.storages if not ref.expired()}
        return sum(alive.values())


def _profile(policy, **changes):
    """(bytes the forward leaves alive, ops the backward runs)."""
    model = _port_model(None, policy, **changes)
    tokens = torch.from_numpy(_tokens(2)[0])
    with _Recorder() as forward:
        loss = model(tokens).logsumexp(-1).mean()
    alive = forward.alive_bytes()
    with _Recorder() as backward:
        loss.backward()
    return alive, backward.ops


def test_attn_and_flash_keep_their_outputs_and_flash_keeps_less_than_mlp():
    full, _ = _profile("full")
    attn, _ = _profile("attn")
    flash_kept, _ = _profile("flash")
    mlp, _ = _profile("mlp")
    n = TINY["n_layers"]
    out_bytes = BATCH * SEQ * TINY["n_heads"] * TINY["head_dim"] * 4
    lse_bytes = BATCH * TINY["n_heads"] * SEQ * 4
    assert attn - full == n * out_bytes
    assert flash_kept - full == n * (out_bytes + lse_bytes)
    assert flash_kept < mlp
    print(f"bytes kept per block: full {full / n:.0f}, flash {flash_kept / n:.0f}, "
          f"mlp {mlp / n:.0f}")


def test_dots_keeps_the_2d_products_and_recomputes_the_batched_ones():
    """With experts and dense attention, so that the forward has batched
    products (attention's, the experts') as well as 2-D ones."""
    moe = dict(num_experts=4, attention_impl="dense")
    _, none = _profile("none", **moe)
    _, full = _profile("full", **moe)
    _, dots = _profile("dots", **moe)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert full[mm] > none[mm] and dots[mm] == none[mm]
    assert full[bmm] > none[bmm] and dots[bmm] == full[bmm]


def test_flash_policy_under_dense_attention_recomputes_as_full():
    """Dense attention runs no flash forward: "flash" keeps nothing and
    recomputes what "full" does."""
    alive_full, full = _profile("full", attention_impl="dense")
    alive_flash, flash_ops = _profile("flash", attention_impl="dense")
    assert alive_flash == alive_full
    assert flash_ops == full
