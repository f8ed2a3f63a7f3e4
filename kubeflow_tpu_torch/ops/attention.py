"""Dense attention: the oracle the flash kernel is held against.

Counterpart of `kubeflow_tpu/ops/attention.py:dense_attention`. Ring
(sequence-parallel) attention is not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import math

import torch


def dense_attention(q, k, v, *, causal: bool = True):
    """Reference attention. q, k, v: [B, S, H, D] → [B, S, H, D].

    Scores q·kᵀ/√d in the input dtype; causal mask tril(k=s_k−s_q);
    softmax in f32; weights cast back to the input dtype before PV —
    the JAX function's numerics, rounding points included."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril(
            s_k - s_q
        )
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores.float(), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)
