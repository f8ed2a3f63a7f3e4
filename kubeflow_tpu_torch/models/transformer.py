"""Decoder-only Transformer LM: the flat model, and its sequence-parallel
(sp ring) form.

Counterpart of `kubeflow_tpu/models/transformer.py` without the tensor-
parallel, pipeline and mixture-of-experts paths. Given a mesh with an sp
ring (`parallel/mesh.build_mesh`), attention runs around the ring
(`ring_flash_attention`, or `ring_attention` for "dense"); every other
layer works per token and is unchanged, and so are the parameters.
Parameters keep the flax
layouts — ``wq|wk|wv`` (d_model, h, d), ``attn.wo`` (h, d, d_model),
``wi_gate|wi_up`` (d_model, d_ff), ``mlp.wo`` (d_ff, d_model),
``embedding`` (V, d_model), norm scales (d,) — and are float32, cast to
the compute dtype at use as flax's ``DenseGeneral(dtype=bf16,
param_dtype=f32)`` does, so carrying weights across is a renaming
(`models/convert.py`).

Training runs through autograd: flash attention's backward is its own
kernels (`ops/flash.py`), and the remat policies "none", "full" and
"mlp" are `torch.utils.checkpoint` regions as the JAX model's
`nn.remat` wraps are.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops.attention import dense_attention, ring_attention
from kubeflow_tpu_torch.ops.flash import (
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
    recomputes each block in the backward, "mlp" only each block's MLP.
    "dots", "attn" and "flash" name what the JAX checkpoint policies
    save; they are not ported (ROADMAP Queue 1 item 4) and raise when a
    model with them is differentiated. ``num_experts > 0`` (switch MoE)
    is not ported."""

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
        if self.num_experts > 0:
            raise NotImplementedError(
                "switch MoE (num_experts > 0) is not ported yet (ROADMAP "
                "Queue 1)"
            )
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
        dt = self.cfg.dtype
        proj = lambda w: torch.einsum("bsm,mhd->bshd", x.to(dt), w.to(dt))
        q = rope(proj(self.wq), positions, self.cfg.rope_theta)
        k = rope(proj(self.wk), positions, self.cfg.rope_theta)
        out = _attend(q, k, proj(self.wv), self.mesh, self.cfg)
        return torch.einsum("bshd,hdm->bsm", out.to(dt), self.wo.to(dt))


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


class Block(nn.Module):
    """Pre-norm block: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: TransformerConfig, mesh=None, device=None):
        super().__init__()
        # The "mlp" policy's only checkpoint: the MLP half recomputes in
        # the backward, attention's residuals stay saved.
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        self.ln_attn = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.attn = Attention(cfg, mesh, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.mlp = SwiGLU(cfg, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln_attn(x), positions)
        mlp = lambda x: self.mlp(self.ln_mlp(x))
        if self.remat_mlp and torch.is_grad_enabled():
            return x + checkpoint(mlp, x, use_reentrant=False)
        return x + mlp(x)


class TransformerLM(nn.Module):
    """Embed → N blocks → norm → tied logits. forward(tokens) → [B, S, V]
    float32 logits. Weights come from `init_params(config, seed)`; load
    others (e.g. `convert.from_flax`) with `load_state_dict`.

    With a `mesh` whose sp axis is more than 1, attention runs around its
    sp ring. On an in-process ring the tokens are the whole sequence; on
    a `torch.distributed` ring each rank passes its own chunk of it (rank
    r: positions r·C .. r·C + C - 1) and gets that chunk's logits."""

    def __init__(self, config: TransformerConfig, *, mesh=None, device=None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config, self.mesh = config, mesh
        self.embedding = _param(config.vocab_size, config.d_model, device=device)
        self.layers = nn.ModuleList(
            Block(config, mesh, device) for _ in range(config.n_layers)
        )
        self.ln_final = RMSNorm(config.d_model, dtype=config.dtype, device=device)
        self.load_state_dict(init_params(config, seed, device=device))

    def features(self, tokens):
        """The final-normed hidden states [B, S, d_model] (compute dtype):
        everything before the output head."""
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
        remat = self._block_remat()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, positions, use_reentrant=False)
            else:
                x = layer(x, positions)
        return self.ln_final(x)

    def _block_remat(self) -> bool:
        """Whether each block recomputes in the backward (`_block_cls`,
        kubeflow_tpu/models/transformer.py:131-168): only under autograd,
        and only for the "full" policy."""
        cfg = self.config
        if not (cfg.remat and torch.is_grad_enabled()):
            return False
        if cfg.remat_policy in ("dots", "attn", "flash"):
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} needs selective "
                "checkpointing of the flash Function's saved o and lse; it "
                "is not ported yet (ROADMAP Queue 1 item 4). Use 'none', "
                "'full' or 'mlp'."
            )
        return cfg.remat_policy == "full"

    def forward(self, tokens):
        return lm_head(self.features(tokens), self.embedding, dtype=self.config.dtype)
