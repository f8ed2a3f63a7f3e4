"""Decoder-only Transformer LM: the flat model, its switch-MoE form, and
its sequence-parallel (sp ring) form.

Counterpart of `kubeflow_tpu/models/transformer.py` without the tensor-
parallel, pipeline and expert-parallel paths. Given a mesh with an sp
ring (`parallel/mesh.build_mesh`), attention runs around the ring
(`ring_flash_attention`, or `ring_attention` for "dense"); every other
layer works per token and is unchanged, and so are the parameters.
Parameters keep the flax
layouts — ``wq|wk|wv`` (d_model, h, d), ``attn.wo`` (h, d, d_model),
``wi_gate|wi_up`` (d_model, d_ff), ``mlp.wo`` (d_ff, d_model),
``moe.router`` (d_model, E), ``moe.w_in`` (E, d_model, d_ff),
``moe.w_out`` (E, d_ff, d_model), ``embedding`` (V, d_model), norm
scales (d,) — and are float32, cast to the compute dtype at use as
flax's ``DenseGeneral(dtype=bf16, param_dtype=f32)`` does, so carrying
weights across is a renaming (`models/convert.py`).

Training runs through autograd: flash attention's backward is its own
kernels (`ops/flash.py`), and every remat policy of the JAX model is a
`torch.utils.checkpoint` region: "full" and "mlp" as its `nn.remat`
wraps are, "dots", "attn" and "flash" as selective checkpoints whose
policy keeps what JAX's `checkpoint_policy` saves (`checkpoint_policy`).

A switch-MoE model's load-balancing losses are returned, not sown:
``model(tokens, with_losses=True)`` gives (logits, per-layer losses),
which the trainer adds to the objective once per (micro)batch. A
checkpointed region that runs again in the backward recomputes them
and throws them away, so none is counted twice.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops.attention import dense_attention, ring_attention
from kubeflow_tpu_torch.ops.flash import (
    FLASH_FWD_OP,
    flash_attention,
    flash_kernels_take,
    ring_flash_attention,
    ring_flash_usable,
)


_REMAT_POLICIES = ("none", "full", "mlp", "dots", "attn", "flash")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields and defaults, `dtype` a `torch.dtype`.

    Remat (`remat`, `remat_policy`) applies when gradients are taken:
    "none" (or ``remat=False``) saves every activation, "full"
    recomputes each block in the backward, "mlp" only each block's MLP
    (or MoE); "dots" keeps the outputs of matrix products with no batch
    dimension, "attn" each attention's output, "flash" each flash
    forward's (o, lse), and recomputes the rest of the block. Under
    ``attention_impl="dense"`` nothing is a flash forward, and "flash"
    recomputes as "full" does. ``num_experts > 0`` replaces each block's
    MLP with a top-1 switch MoE (`SwitchMoE`)."""

    vocab_size: int = 32_000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    head_dim: int = 64
    d_ff: int = 2048
    rope_theta: float = 10_000.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    # "flash" runs `flash_attention` (the kernels on CUDA, their plain
    # versions on CPU); "auto" does too, except on CUDA at a head dim or
    # dtype the kernels do not take, where it runs `dense_attention`
    # (`use_flash`); "dense" runs `dense_attention`.
    attention_impl: str = "auto"
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    flash_block_q_bwd: int | None = None
    flash_block_k_bwd: int | None = None
    num_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01

    def __post_init__(self):
        if self.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; expected one "
                f"of {_REMAT_POLICIES}"
            )
        if self.attention_impl not in ("auto", "flash", "dense"):
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r}; expected "
                "'auto', 'flash', or 'dense'"
            )


# -- remat policies ---------------------------------------------------------------

# The names the active selective checkpoint keeps (`checkpoint_name`).
_KEPT_NAMES: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "kftpu_kept_names", default=frozenset())


@torch.library.custom_op("kftpu::checkpoint_name", mutates_args=())
def _name_op(x: torch.Tensor, name: str) -> torch.Tensor:
    # An op may not return its input, so the named value is a copy.
    return x.clone()


@_name_op.register_fake
def _(x, name):
    return torch.empty_like(x)


_name_op.register_autograd(lambda ctx, grad: (grad, None))
_NAME_OP = torch.ops.kftpu.checkpoint_name.default


def checkpoint_name(x, name: str):
    """`jax.ad_checkpoint.checkpoint_name`: `x`, tagged `name` for a
    policy that keeps it. Inside a selective checkpoint that keeps
    `name`, the value passes through an op the policy can see (a copy);
    everywhere else it is `x` itself."""
    if name in _KEPT_NAMES.get():
        return _NAME_OP(x, name)
    return x


@contextlib.contextmanager
def _keeping(names: frozenset, mode):
    token = _KEPT_NAMES.set(names)
    try:
        with mode:
            yield
    finally:
        _KEPT_NAMES.reset(token)


def checkpoint_policy(name: str):
    """The ``context_fn`` of `torch.utils.checkpoint` for a named remat
    policy: JAX's `checkpoint_policy` (kubeflow_tpu/models/
    transformer.py:106-128). The per-block checkpoint and the trainer's
    ``step_remat`` both take it, so the two cannot drift.

    "full" keeps nothing inside the region (the plain checkpoint).
    "dots" keeps the outputs of ``aten.mm``, the 2-D matrix products:
    `dots_with_no_batch_dims_saveable`, since this model writes its
    projections, SwiGLU, router and head as 2-D products and its batched
    contractions (attention, the experts) as ``bmm``. "attn" keeps the
    value named ``attn_out``; "flash" keeps what `FLASH_FWD_OP` returns,
    so the backward runs no flash forward. Everything else is
    recomputed."""
    if name == "full":
        return noop_context_fn
    names = frozenset()
    if name == "dots":
        keep = lambda op, args: op is torch.ops.aten.mm.default
    elif name == "attn":
        names = frozenset({"attn_out"})
        keep = lambda op, args: op is _NAME_OP and args[1] in names
    elif name == "flash":
        keep = lambda op, args: op is FLASH_FWD_OP
    else:
        raise ValueError(
            f"no checkpoint policy for remat_policy {name!r}; expected "
            "'full', 'dots', 'attn', or 'flash'"
        )

    def policy(ctx, op, *args, **kwargs):
        if keep(op, args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    def context_fn():
        forward, recompute = create_selective_checkpoint_contexts(policy)
        return _keeping(names, forward), _keeping(names, recompute)

    return context_fn


def lm_head(x, embed, *, dtype):
    """Tied output head: operands rounded to `dtype`, products summed
    and returned in float32 (flax: einsum with
    preferred_element_type=f32). A product of two bf16 values is exact
    in float32, so an f32 matmul of the rounded operands is that
    contract."""
    return torch.matmul(x.to(dtype).float(), embed.to(dtype).float().T)


def rms_norm(x, scale, *, dtype, eps: float = 1e-6):
    """Normalise in f32 (eps inside the rsqrt), times the f32 scale,
    cast to `dtype`."""
    x32 = x.float()
    norm = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (norm * scale).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype, device=None, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        return rms_norm(x, self.scale, dtype=self.dtype, eps=self.eps)


def rope(x, positions, theta: float):
    """Rotary embeddings, half-split: x: [B, S, H, D], positions [B, S].
    The first and second halves of D are the pair, not interleaved
    neighbours; angles in f32."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )
    angles = positions[..., None].float() * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def use_flash(impl: str, *, cuda: bool, head_dim: int, dtype) -> bool:
    """Whether `_attend` runs flash attention (else dense) off the ring,
    decided by shape before any call, as JAX's "auto" decides by its
    `flash_usable` predicate. "flash" always: flash is asked for, flash
    runs, and a shape the kernels do not take raises there. "auto": on
    the CPU always (the plain versions take any shape), on CUDA where the
    kernels take the head dim and dtype (`flash_kernels_take`)."""
    if impl == "flash":
        return True
    return impl == "auto" and (not cuda or flash_kernels_take(head_dim, dtype))


def _attend(q, k, v, mesh, cfg: TransformerConfig):
    """Causal attention by `cfg.attention_impl`: around the ring when the
    mesh's sp axis is real (JAX `_attend`, kubeflow_tpu/models/
    transformer.py:256-273) — ring flash for "auto"/"flash" where it takes
    the chunks (on CUDA where the kernels take the head dim and dtype; on
    the CPU where the chunks tile, as in JAX), else the dense-hop ring —
    and otherwise flash or dense by `use_flash`."""
    bq, bk = cfg.flash_block_q, cfg.flash_block_k
    if mesh is not None and mesh.shape["sp"] > 1:
        chunk = q.shape[1] // len(mesh.ring().ranks)
        if cfg.attention_impl in ("auto", "flash") and ring_flash_usable(
            q, chunk, bq, bk
        ):
            return ring_flash_attention(
                q, k, v, mesh, causal=True, block_q=bq, block_k=bk
            )
        return ring_attention(q, k, v, mesh, causal=True)
    if not use_flash(cfg.attention_impl, cuda=q.is_cuda, head_dim=q.shape[-1],
                     dtype=q.dtype):
        return dense_attention(q, k, v, causal=True)
    return flash_attention(
        q, k, v, causal=True, block_q=bq, block_k=bk,
        bwd_block_q=cfg.flash_block_q_bwd, bwd_block_k=cfg.flash_block_k_bwd,
    )


def _param(*shape, device):
    # Filled by `TransformerLM` from `init_params` (or a converted
    # checkpoint) right after construction.
    return nn.Parameter(torch.empty(*shape, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, mesh=None, device=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        h, d, dm = cfg.n_heads, cfg.head_dim, cfg.d_model
        self.wq = _param(dm, h, d, device=device)
        self.wk = _param(dm, h, d, device=device)
        self.wv = _param(dm, h, d, device=device)
        self.wo = _param(h, d, dm, device=device)

    def forward(self, x, positions):
        cfg, dt = self.cfg, self.cfg.dtype
        b, s, _ = x.shape
        h, d = cfg.n_heads, cfg.head_dim
        x = x.to(dt)
        # Each projection is one 2-D product, as "dots" needs (an einsum
        # would lower to a bmm).
        proj = lambda w: (x @ w.to(dt).flatten(1)).view(b, s, h, d)
        q = rope(proj(self.wq), positions, cfg.rope_theta)
        k = rope(proj(self.wk), positions, cfg.rope_theta)
        out = checkpoint_name(_attend(q, k, proj(self.wv), self.mesh, cfg), "attn_out")
        return out.to(dt).reshape(b, s, h * d) @ self.wo.to(dt).flatten(0, 1)


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.wi_gate = _param(cfg.d_model, cfg.d_ff, device=device)
        self.wi_up = _param(cfg.d_model, cfg.d_ff, device=device)
        self.wo = _param(cfg.d_ff, cfg.d_model, device=device)

    def forward(self, x):
        dt = self.cfg.dtype
        x = x.to(dt)
        gate = x @ self.wi_gate.to(dt)
        up = x @ self.wi_up.to(dt)
        return (nn.functional.silu(gate) * up) @ self.wo.to(dt)


def group_size(n_tok: int, target: int = 4096) -> int:
    """The largest divisor of `n_tok` that is at most `target`: the
    routing group (`SwitchMoE._group_size`)."""
    for g in range(min(target, n_tok), 0, -1):
        if n_tok % g == 0:
            return g
    return n_tok


class Routing(NamedTuple):
    """One `SwitchMoE` call's routing, over G groups of g tokens."""

    probs: torch.Tensor  # [G, g, E] float32 router probabilities
    expert: torch.Tensor  # [G, g] the chosen expert (first argmax)
    gate: torch.Tensor  # [G, g] float32, its probability
    slot: torch.Tensor  # [G, g] the token's place in its expert's queue
    keep: torch.Tensor  # [G, g] slot < capacity; the rest are dropped
    capacity: int
    aux: torch.Tensor  # the load-balancing loss, a float32 scalar


class SwitchMoE(nn.Module):
    """Top-1 (switch) MoE with capacity: JAX's `SwitchMoE`
    (kubeflow_tpu/models/transformer.py:368-442), on one device.

    The tokens route in groups of `group_size` (n_tok) with a capacity of
    ``max(1, int(capacity_factor · g / E))`` per expert and group; a
    token past its expert's capacity is dropped (its output is 0, so
    the block passes it on by the residual). JAX moves tokens to and
    from the experts by one-hot einsums; here an index copy and an
    index gather do: each one-hot row holds at most one 1, so the
    function is the same, without the [G, g, E, cap] one-hots. forward(x)
    → (output, load-balancing loss)."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, dm, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = _param(dm, e, device=device)
        self.w_in = _param(e, dm, ff, device=device)
        self.w_out = _param(e, ff, dm, device=device)

    def route(self, x) -> Routing:
        """The router in float32 on the float32 input: softmax, the first
        argmax and its probability, each token's slot in its expert's
        queue in token order, and the Switch Transformer's loss
        E · mean over groups of Σ_E (token share · mean probability),
        times ``aux_loss_coef``."""
        cfg = self.cfg
        dm, e = x.shape[-1], cfg.num_experts
        n_tok = x.numel() // dm
        g = group_size(n_tok)
        cap = max(1, int(cfg.capacity_factor * g / e))
        logits = x.reshape(n_tok, dm).float() @ self.router
        probs = torch.softmax(logits, dim=-1).view(n_tok // g, g, e)
        expert = probs.argmax(-1)
        gate = probs.gather(-1, expert[..., None])[..., 0]
        onehot = nn.functional.one_hot(expert, e)
        # Running counts per expert along the group's tokens, scanned on
        # the innermost dimension of [G, E, g] (a scan along the middle
        # one of [G, g, E] runs a thread per column on CUDA).
        queue = onehot.transpose(1, 2).cumsum(-1)
        slot = queue.gather(1, expert[:, None, :])[:, 0] - 1
        frac_tokens = onehot.float().mean(1)
        frac_probs = probs.mean(1)
        aux = e * (frac_tokens * frac_probs).sum(-1).mean() * cfg.aux_loss_coef
        return Routing(probs, expert, gate, slot, slot < cap, cap, aux)

    def forward(self, x):
        dt = self.cfg.dtype
        b, s, dm = x.shape
        r = self.route(x)
        n_groups, e = r.probs.shape[0], r.probs.shape[-1]
        # Expert e's queue of group G holds rows (e·n_groups + G)·cap ..;
        # a dropped token goes to one row past them all, which is cut off.
        group = torch.arange(n_groups, device=x.device)[:, None]
        rows = e * n_groups * r.capacity
        row = torch.where(r.keep, (r.expert * n_groups + group) * r.capacity + r.slot,
                          rows).flatten()
        tokens = x.reshape(b * s, dm).to(dt)
        xin = tokens.new_zeros(rows + 1, dm).index_copy(0, row, tokens)
        xin = xin[:rows].view(e, n_groups * r.capacity, dm)
        hidden = nn.functional.silu(torch.bmm(xin, self.w_in.to(dt)))
        xout = torch.bmm(hidden, self.w_out.to(dt)).view(rows, dm)
        xout = torch.cat([xout, xout.new_zeros(1, dm)])
        # The gate is rounded to the compute dtype before the product, as
        # JAX's combine one-hot is.
        out = xout.index_select(0, row) * r.gate.flatten()[:, None].to(dt)
        return out.view(b, s, dm), r.aux


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x)), the MLP
    a SwiGLU or, with experts, a `SwitchMoE`. forward → (x, the MoE's
    load-balancing loss or None)."""

    def __init__(self, cfg: TransformerConfig, mesh=None, device=None):
        super().__init__()
        # The "mlp" policy's only checkpoint: the MLP half recomputes in
        # the backward, attention's residuals stay saved.
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        self.ln_attn = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.attn = Attention(cfg, mesh, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.is_moe = cfg.num_experts > 0
        if self.is_moe:
            self.moe = SwitchMoE(cfg, device)
        else:
            self.mlp = SwiGLU(cfg, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln_attn(x), positions)
        ffn = self.moe if self.is_moe else self.mlp
        mlp = lambda x: ffn(self.ln_mlp(x))
        if self.remat_mlp and torch.is_grad_enabled():
            out = checkpoint(mlp, x, use_reentrant=False)
        else:
            out = mlp(x)
        out, aux = out if self.is_moe else (out, None)
        return x + out, aux


class TransformerLM(nn.Module):
    """Embed → N blocks → norm → tied logits. forward(tokens) → [B, S, V]
    float32 logits; forward(tokens, with_losses=True) → (logits, the
    blocks' load-balancing losses in layer order, empty without
    experts). Weights come from `init_params(config, seed)`; load others
    (e.g. `convert.from_flax`) with `load_state_dict`.

    With a `mesh` whose sp axis is more than 1, attention runs around its
    sp ring. On an in-process ring the tokens are the whole sequence; on
    a `torch.distributed` ring each rank passes its own chunk of it (rank
    r: positions r·C .. r·C + C - 1) and gets that chunk's logits. A MoE
    model routes over all the batch's tokens, which no rank of a process
    ring holds, so it takes no process ring."""

    def __init__(self, config: TransformerConfig, *, mesh=None, device=None,
                 seed: int = 0):
        super().__init__()
        if config.num_experts > 0 and mesh is not None and mesh.multiprocess:
            raise NotImplementedError(
                "a switch-MoE model on a torch.distributed ring would route "
                "each rank's chunk apart from the rest of the batch; MoE "
                "across processes (ep, sp) is ROADMAP Queue 1 item 12"
            )
        device = resolve_device(device)
        self.config, self.mesh = config, mesh
        self.embedding = _param(config.vocab_size, config.d_model, device=device)
        self.layers = nn.ModuleList(
            Block(config, mesh, device) for _ in range(config.n_layers)
        )
        self.ln_final = RMSNorm(config.d_model, dtype=config.dtype, device=device)
        self.load_state_dict(init_params(config, seed, device=device))

    @property
    def sows_losses(self) -> bool:
        """Whether the model has losses of its own for the objective
        (JAX's "losses" collection): the MoE's load balancing."""
        return self.config.num_experts > 0

    def reset_parameters(self, seed: int | torch.Generator) -> None:
        """Draw every weight anew from `seed` (an int or a generator), as
        `init_params` does; the parameters stay the same tensors."""
        device = self.embedding.device
        self.load_state_dict(init_params(self.config, seed, device=device))

    def features(self, tokens, losses: list | None = None):
        """The final-normed hidden states [B, S, d_model] (compute dtype):
        everything before the output head. Each block's load-balancing
        loss is appended to `losses`, if one is given."""
        # Gather, then cast: the same values as flax's cast-then-gather,
        # without casting the whole table.
        x = nn.functional.embedding(tokens, self.embedding).to(self.config.dtype)
        # Rope needs the global positions: a rank of a process ring holds
        # a chunk that starts past 0.
        start = 0
        if self.mesh is not None:
            start = self.mesh.ring().sequence_offset(tokens.shape[1])
        positions = torch.arange(start, start + tokens.shape[1],
                                 device=tokens.device)
        positions = positions.expand(tokens.shape)
        policy = self._block_policy()
        context_fn = checkpoint_policy(policy) if policy else None
        for layer in self.layers:
            if context_fn is not None:
                x, aux = checkpoint(layer, x, positions, use_reentrant=False,
                                    context_fn=context_fn)
            else:
                x, aux = layer(x, positions)
            if aux is not None and losses is not None:
                losses.append(aux)
        return self.ln_final(x)

    def _block_policy(self) -> str | None:
        """The policy of each block's checkpoint, or None for no block
        checkpoint (`_block_cls`, kubeflow_tpu/models/transformer.py:
        131-168): only under autograd, and not for "none" or "mlp" (whose
        checkpoint is the MLP's, inside `Block`)."""
        cfg = self.config
        if not (cfg.remat and torch.is_grad_enabled()):
            return None
        if cfg.remat_policy in ("none", "mlp"):
            return None
        return cfg.remat_policy

    def forward(self, tokens, *, with_losses: bool = False):
        losses = [] if with_losses else None
        logits = lm_head(self.features(tokens, losses), self.embedding,
                         dtype=self.config.dtype)
        return (logits, losses) if with_losses else logits
