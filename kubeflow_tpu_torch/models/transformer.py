"""Decoder-only Transformer LM: the flat model, for one device.

Counterpart of `kubeflow_tpu/models/transformer.py` without the mesh,
ring, pipeline and mixture-of-experts paths. Parameters keep the flax
layouts — ``wq|wk|wv`` (d_model, h, d), ``attn.wo`` (h, d, d_model),
``wi_gate|wi_up`` (d_model, d_ff), ``mlp.wo`` (d_ff, d_model),
``embedding`` (V, d_model), norm scales (d,) — and are float32, cast to
the compute dtype at use as flax's ``DenseGeneral(dtype=bf16,
param_dtype=f32)`` does, so carrying weights across is a renaming
(`models/convert.py`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.models.convert import init_params
from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX config's fields and defaults, `dtype` a `torch.dtype`.

    The remat fields are accepted for parity and unused: the port runs
    inference only. ``num_experts > 0`` (switch MoE) is not ported."""

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
    # "auto" and "flash" run `flash_attention` (the kernel on CUDA, its
    # plain version on CPU); "dense" runs `dense_attention`.
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


def _attend(q, k, v, cfg: TransformerConfig):
    """Causal attention by `cfg.attention_impl`."""
    if cfg.attention_impl == "dense":
        return dense_attention(q, k, v, causal=True)
    return flash_attention(
        q, k, v, causal=True,
        block_q=cfg.flash_block_q, block_k=cfg.flash_block_k,
    )


def _param(*shape, device):
    # Filled by `TransformerLM` from `init_params` (or a converted
    # checkpoint) right after construction.
    return nn.Parameter(torch.empty(*shape, device=device))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
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
        out = _attend(q, k, proj(self.wv), self.cfg)
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

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.attn = Attention(cfg, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dtype=cfg.dtype, device=device)
        self.mlp = SwiGLU(cfg, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln_attn(x), positions)
        return x + self.mlp(self.ln_mlp(x))


class TransformerLM(nn.Module):
    """Embed → N blocks → norm → tied logits. forward(tokens) → [B, S, V]
    float32 logits. Weights come from `init_params(config, seed)`; load
    others (e.g. `convert.from_flax`) with `load_state_dict`."""

    def __init__(self, config: TransformerConfig, *, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embedding = _param(config.vocab_size, config.d_model, device=device)
        self.layers = nn.ModuleList(
            Block(config, device) for _ in range(config.n_layers)
        )
        self.ln_final = RMSNorm(config.d_model, dtype=config.dtype, device=device)
        self.load_state_dict(init_params(config, seed, device=device))

    def features(self, tokens):
        """The final-normed hidden states [B, S, d_model] (compute dtype):
        everything before the output head."""
        # Gather, then cast: the same values as flax's cast-then-gather,
        # without casting the whole table.
        x = nn.functional.embedding(tokens, self.embedding).to(self.config.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        positions = positions.expand(tokens.shape)
        for layer in self.layers:
            x = layer(x, positions)
        return self.ln_final(x)

    def forward(self, tokens):
        return lm_head(self.features(tokens), self.embedding, dtype=self.config.dtype)
