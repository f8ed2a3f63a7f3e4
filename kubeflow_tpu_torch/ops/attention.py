"""Attention: the dense reference and ring (sequence-parallel) attention.

Counterpart of `kubeflow_tpu/ops/attention.py`. `dense_attention` is the
oracle the flash kernels are held against. `ring_attention` is the
dense-hop ring over a mesh's sp axis: the sequence is cut into one chunk
per ring position, each position keeps its q chunk while the k/v chunks
rotate around the ring (`parallel/collectives.ppermute_ring`), and the
softmax accumulates online, so no position holds the whole [S, S] score
matrix or the whole k/v. It is the non-flash sp branch of
`TransformerLM` and the CPU oracle of `ops/flash.ring_flash_attention`,
whose hops run the flash kernels instead.
"""

from __future__ import annotations

import math

import torch

from kubeflow_tpu_torch.parallel.collectives import axis_size, ppermute_ring
from kubeflow_tpu_torch.parallel.sharding import batch_axes


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


def _rotate(x, ring):
    # One helper for both attention modules: the dense-hop ring and the
    # flash-hop ring must share the same permutation direction.
    return ppermute_ring(x, ring, shift=1)


def _check_ring_batch(mesh, batch: int) -> None:
    """On an in-process ring the batch splits over the mesh's batch axes
    as the JAX package's shard_map splits it: it must divide."""
    shards = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    if not mesh.multiprocess and batch % shards:
        raise ValueError(
            f"ring attention: batch ({batch}) must divide into the mesh's "
            f"{shards} batch shards ({', '.join(batch_axes(mesh))})"
        )


def _ring_body(q, k, v, *, ring, causal: bool):
    """Ring attention over local chunks q, k, v [R, B, C, H, D], one per
    ring position this process holds (`ring.ranks`).

    The loop runs the ring's n hops; the final hop skips its rotation
    (n-1 rotations). Under causality a k/v chunk from a later ring
    position is masked whole for this position's queries, so that hop is
    skipped; the others run in float32 with the online softmax.

    k and v rotate as one stacked tensor, so the rotations' transposes
    form one chain that autograd runs in the same order on every rank of
    a process ring. A skipped hop selects no position: it computes
    nothing but stays in the graph, so a rank that skips the last hop
    still takes part in the backward of every rotation."""
    n = axis_size(ring)
    r, b, c, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    cols = torch.arange(c, device=q.device)
    my = torch.tensor(ring.ranks, device=q.device)
    q_pos = my[:, None] * c + cols  # [R, C]

    o = torch.zeros(r, b, c, h, d, device=q.device)
    m = torch.full((r, b, h, c), float("-inf"), device=q.device)
    l = torch.zeros(r, b, h, c, device=q.device)
    kv_cur = torch.stack([k, v], dim=1)  # [R, 2, B, C, H, D]
    for i in range(n):
        src = [(x - i) % n for x in ring.ranks]  # where each k/v chunk began
        run = [j for j, x in enumerate(ring.ranks) if not causal or src[j] <= x]
        idx = torch.tensor(run, dtype=torch.int64, device=q.device)
        k_run, v_run = kv_cur[idx].float().unbind(1)
        s = torch.einsum("rbqhd,rbkhd->rbhqk", q32[idx], k_run) * scale
        if causal:
            k_pos = torch.tensor([src[j] for j in run], dtype=torch.int64,
                                 device=q.device)
            seen = q_pos[idx][:, :, None] >= (k_pos[:, None] * c + cols)[:, None, :]
            s = torch.where(seen[:, None, None], s, float("-inf"))
        m_run = m[idx]
        m_new = torch.maximum(m_run, s.amax(-1))
        # Rows with no unmasked key yet keep m = -inf; exp(-inf - -inf)
        # is nan, so guard the correction factor.
        corr = torch.where(m_run == float("-inf"), 0.0, torch.exp(m_run - m_new))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        pv = torch.einsum("rbhqk,rbkhd->rbqhd", p, v_run)
        # The positions that skipped keep their state.
        o = o.index_copy(0, idx, o[idx] * corr.transpose(2, 3)[..., None] + pv)
        l = l.index_copy(0, idx, l[idx] * corr + p.sum(-1))
        m = m.index_copy(0, idx, m_new)
        if i + 1 < n:
            kv_cur = _rotate(kv_cur, ring)
    l = torch.where(l == 0.0, 1.0, l)
    out = o / l.transpose(2, 3)[..., None]
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, *, causal: bool = True):
    """Sequence-parallel attention over `mesh`'s sp ring.

    q, k, v: [B, S, H, D] — the whole sequence on an in-process ring
    (`build_mesh` in one process), this rank's chunk of it on a
    `torch.distributed` ring; S must divide by the ring positions held
    here. Differentiable through autograd (the rotations are
    `ppermute_ring`'s). Falls back to dense attention when the ring is
    trivial."""
    if mesh.shape["sp"] == 1:
        return dense_attention(q, k, v, causal=causal)
    ring = mesh.ring()
    local = len(ring.ranks)
    if q.shape[1] % local:
        raise ValueError(
            f"ring attention requires the sequence length ({q.shape[1]}) to "
            f"be divisible by the sp ring size ({ring.size})"
        )
    _check_ring_batch(mesh, q.shape[0])
    split = lambda x: x.unflatten(1, (local, x.shape[1] // local)).movedim(1, 0)
    out = _ring_body(split(q), split(k), split(v), ring=ring, causal=causal)
    return out.movedim(0, 1).flatten(1, 2)
