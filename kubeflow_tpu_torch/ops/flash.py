"""Flash attention, forward only: a Hopper kernel and its plain version.

Counterpart of `kubeflow_tpu/ops/flash.py`. There the forward is a
Pallas TPU kernel (`_fwd_kernel_compact`, on the compact causal grid);
here it is the CUDA C++ kernel ``csrc/flash_fwd.cu``, and beside it
`flash_attention_reference`, which runs the JAX schedule in plain
PyTorch — `_pick_block`, pad-to-128 plus the ``kv_len`` tail mask, the
lower-triangular (or predicated rectangular) block walk — with the same
masks, guards and float32 math.

`flash_fwd` is the one dispatch point: CPU tensors go to the plain
version, CUDA tensors to the kernel (or an error). The kernel covers
what `TransformerLM` runs: causal self-attention, any S (it masks its
own ragged edge, so nothing is padded on CUDA), D of 64 or 128, bf16 or
f32. Not ported yet (ROADMAP Queue 2): the rectangular `_fwd_kernel`
(non-causal, s_q != s_k), the backward kernels and ring flash.
"""

from __future__ import annotations

import math

import torch

from kubeflow_tpu_torch.ops import _kernels

_NEG_INF = float("-inf")
_LANES = 128
_SUBLANES = 8
# The TPU's compact grid carries (i, j) lookup tables in scalar memory
# and caps their length; kept so the schedule helpers answer as JAX's do.
# The CUDA kernel's causal loop bound has no such cap.
_MAX_COMPACT_STEPS = 1 << 16

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


# -- schedule (same results as kubeflow_tpu/ops/flash.py:204-258) ------------


def _pick_block(block: int, s: int) -> int:
    """The requested block clamped to `s`, or the largest 8-aligned
    divisor of `s` below it (lane-aligned divisors first)."""
    block = min(block, s)
    if s % block == 0 and block % _SUBLANES == 0:
        return block
    for step in (_LANES, _SUBLANES):
        for candidate in range(block - block % step, step - 1, -step):
            if s % candidate == 0:
                return candidate
    raise ValueError(
        f"flash attention: no {_SUBLANES}-aligned block <= {block} divides "
        f"the sequence length ({s}); pad the sequence (flash_attention "
        "does this automatically) or use dense_attention"
    )


def _tileable(block: int, s: int) -> bool:
    try:
        _pick_block(block, s)
    except ValueError:
        return False
    return True


def _pad_to_tileable(block: int, s: int) -> int:
    """`s` when it already tiles, else the next multiple of 128."""
    if _tileable(block, s):
        return s
    return -(-s // _LANES) * _LANES


def _compactable(causal: bool, sq: int, sk: int, bq: int, bk: int) -> bool:
    """Causal self-attention with square blocks: block row i runs
    exactly the blocks j <= i."""
    if not (causal and sq == sk and bq == bk):
        return False
    nq = sq // bq
    return nq * (nq + 1) // 2 <= _MAX_COMPACT_STEPS


def _grid_steps(causal: bool, sq: int, sk: int, bq: int, bk: int):
    """(steps, rectangular_steps, compact) per (batch*head) row."""
    nq, nk = sq // bq, sk // bk
    rect = nq * nk
    if _compactable(causal, sq, sk, bq, bk):
        return nq * (nq + 1) // 2, rect, True
    return rect, rect, False


def flash_usable(seq_q: int, seq_k: int, block_q: int = 1024,
                 block_k: int = 1024) -> bool:
    """True when `flash_attention` can run these shapes: any positive
    pair, since ragged lengths are handled inside."""
    del block_q, block_k
    return seq_q >= 1 and seq_k >= 1


def flash_kernel_tileable(seq: int, block: int = 1024) -> bool:
    """True when `seq` divides into 8-aligned flash blocks without
    padding."""
    return _tileable(block, seq)


# -- the plain version --------------------------------------------------------


def flash_attention_reference(
    q, k, v, *, causal: bool = True, block_q: int = 1024, block_k: int = 1024
):
    """The JAX forward schedule in plain PyTorch. q: [BH, Sq, D],
    k, v: [BH, Sk, D] → (o [BH, Sq, D] in q's dtype, lse [BH, Sq] f32).

    Untileable lengths pad to a multiple of 128 and mask keys past the
    true length (``kv_len``); per q block i the k blocks run in order
    with the online softmax of `_fwd_body` (kubeflow_tpu/ops/flash.py:
    460-512), all in float32. The causal mask is q_pos >= k_pos with no
    s_k - s_q offset, as in the TPU kernels."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sp_q = _pad_to_tileable(block_q, sq)
    sp_k = _pad_to_tileable(block_k, sk)
    kv_len = sk if sp_k != sk else None
    pad = lambda x, s: torch.nn.functional.pad(x, (0, 0, 0, s - x.shape[1]))
    q, k, v = pad(q, sp_q), pad(k, sp_k), pad(v, sp_k)
    bq = _pick_block(block_q, sp_q)
    bk = _pick_block(block_k, sp_k)
    compact = _compactable(causal, sp_q, sp_k, bq, bk)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    o = torch.empty(bh, sp_q, d, dtype=q.dtype, device=dev)
    lse = torch.empty(bh, sp_q, dtype=torch.float32, device=dev)
    rows = torch.arange(bq, device=dev)[:, None]
    cols = torch.arange(bk, device=dev)[None, :]
    for i in range(sp_q // bq):
        qb = q[:, i * bq:(i + 1) * bq].float() * scale
        m = torch.full((bh, bq, 1), _NEG_INF, device=dev)
        l = torch.zeros(bh, bq, 1, device=dev)
        acc = torch.zeros(bh, bq, d, device=dev)
        for j in range(i + 1 if compact else sp_k // bk):
            if causal and j * bk > i * bq + bq - 1:
                continue  # the rectangular grid's predicated-off block
            kb = k[:, j * bk:(j + 1) * bk].float()
            s = qb @ kb.transpose(1, 2)
            if causal:
                s = s.masked_fill(i * bq + rows < j * bk + cols, _NEG_INF)
            if kv_len is not None:
                s = s.masked_fill(j * bk + cols >= kv_len, _NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            safe_m = torch.where(m_new == _NEG_INF, 0.0, m_new)
            corr = torch.where(m == _NEG_INF, 0.0, torch.exp(m - safe_m))
            p = torch.where(s == _NEG_INF, 0.0, torch.exp(s - safe_m))
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ v[:, j * bk:(j + 1) * bk].float()
            m = m_new
        safe_l = torch.where(l == 0.0, 1.0, l)
        o[:, i * bq:(i + 1) * bq] = (acc / safe_l).to(q.dtype)
        lse[:, i * bq:(i + 1) * bq] = torch.where(
            m == _NEG_INF, _NEG_INF, m + torch.log(safe_l)
        )[..., 0]
    return o[:, :sq], lse[:, :sq]


# -- the kernel ----------------------------------------------------------------


def _check_kernel_inputs(q, k, v) -> None:
    """What the CUDA kernel takes: [BH, S, D] q, k, v of one shape, dtype
    and device, contiguous and 16-byte aligned, bf16 or f32, D 64 or 128."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_fwd kernel: q, k, v must share one [BH, S, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_fwd kernel: dtype must be bfloat16 or float32 for all of "
            f"q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[2] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_fwd kernel: head dim must be one of {_KERNEL_HEAD_DIMS}; "
            f"got {q.shape[2]}"
        )
    if q.shape[0] > 65535:
        raise ValueError(
            f"flash_fwd kernel: at most 65535 (batch*heads) rows; got "
            f"{q.shape[0]}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd kernel: {name} is not 16-byte aligned")
        if t.device != q.device:
            raise ValueError(
                f"flash_fwd kernel: {name} is on {t.device}, q on {q.device}"
            )


def _flash_fwd_cuda(q, k, v):
    _check_kernel_inputs(q, k, v)
    lib = _kernels.library("flash_fwd")
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.kftpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise _kernels.KernelLaunchError(
            f"flash_fwd kernel launch failed: "
            f"{lib.kftpu_error_string(err).decode()} (cudaError {err})"
        )
    _kernels.count_launch("flash_fwd")
    return o, lse


def flash_fwd(
    q, k, v, *, causal: bool = True, block_q: int = 1024, block_k: int = 1024
):
    """The wrapper: (o, lse) of flash attention over [BH, S, D] inputs.

    CPU tensors run `flash_attention_reference`; CUDA tensors launch the
    Hopper kernel, which takes causal self-attention only — there is no
    path from a CUDA tensor to the plain version. The blocks shape the
    plain version's schedule only; the kernel tiles by its own sizes."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    if not causal or q.shape[1] != k.shape[1]:
        raise NotImplementedError(
            "the CUDA flash kernel covers causal self-attention only; "
            "non-causal and s_q != s_k (the TPU's rectangular _fwd_kernel) "
            "are ROADMAP Queue 2, item 5"
        )
    return _flash_fwd_cuda(q, k, v)


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
    return_lse: bool = False,
):
    """Blockwise attention. q, k, v: [B, S, H, D] → [B, S, H, D].

    Runs in the head-major [B·H, S, D] layout, as the JAX function does.
    Ragged lengths need nothing from the caller: the plain version pads
    to a multiple of 128 and masks the tail (``kv_len``), the kernel
    masks its own ragged edge; either way the output has q's length.
    ``return_lse=True`` also returns the log-sum-exp as [B, H, S] f32."""
    b, sq, h, d = q.shape
    to_bhsd = lambda x: x.transpose(1, 2).contiguous().view(
        b * h, x.shape[1], d
    )
    o, lse = flash_fwd(
        to_bhsd(q), to_bhsd(k), to_bhsd(v),
        causal=causal, block_q=block_q, block_k=block_k,
    )
    o = o.reshape(b, h, sq, d).transpose(1, 2)
    if not return_lse:
        return o
    return o, lse.reshape(b, h, sq)
