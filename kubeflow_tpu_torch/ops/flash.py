"""Flash attention, forward and backward: Hopper kernels and their plain
versions.

Counterpart of `kubeflow_tpu/ops/flash.py`. There the kernels are Pallas
TPU kernels on the compact causal grid; here they are CUDA C++ kernels
under ``csrc/``, each with a plain PyTorch version beside it that runs
the JAX schedule — `_pick_block`, pad-to-128 plus the ``kv_len`` tail
mask, the lower-triangular (or predicated rectangular) block walk — with
the same masks, guards and float32 math:

| TPU kernel | CUDA kernel (launch counter) | plain version |
|---|---|---|
| `_fwd_kernel_compact` | ``csrc/flash_fwd.cu`` (flash_fwd) | `flash_attention_reference` |
| `_fwd_kernel` | ``csrc/flash_fwd.cu`` (flash_fwd_rect) | `flash_attention_reference` |
| `_delta_kernel` | ``csrc/flash_delta.cu`` (flash_delta) | `flash_delta_reference` |
| `_dq_kernel_compact` | ``csrc/flash_bwd_dq.cu`` (flash_bwd_dq) | `flash_bwd_reference` |
| `_dq_kernel` | ``csrc/flash_bwd_dq.cu`` (flash_bwd_dq_rect) | `flash_bwd_reference` |
| `_dkv_kernel_compact` | ``csrc/flash_bwd_dkv.cu`` (flash_bwd_dkv) | `flash_bwd_reference` |
| `_dkv_kernel` | ``csrc/flash_bwd_dkv.cu`` (flash_bwd_dkv_rect) | `flash_bwd_reference` |
| `_dqkv_kernel_fused` | ``csrc/flash_bwd_dkv.cu`` (flash_bwd_fused) | `flash_bwd_fused_reference` |

The wrappers `flash_fwd`, `flash_delta` and `flash_bwd_kernels` are the
dispatch points: CPU tensors go to the plain versions, CUDA tensors to
the kernels (or an error). Causal self-attention takes the causal
kernels; non-causal attention and s_q != s_k (with the TPU kernels'
top-left causal mask, q_pos >= k_pos and no offset) take the
rectangular ones. The kernels take any lengths (they mask their own
ragged edges, so nothing is padded on CUDA) and any number of
(batch*head) rows, D of 64 or 128, bf16 or f32 (`flash_kernels_take`).
`FlashAttentionFunction` ties them into autograd, and `flash_attention`
runs through it on every device.

Ring flash attention (`ring_flash_attention`, sequence parallelism over
a mesh's sp ring) composes these kernels: each hop runs the causal ones
on its own chunk and the rectangular ones on an earlier rank's chunk.
"""

from __future__ import annotations

import math
import os

import torch

from kubeflow_tpu_torch.ops import _kernels
from kubeflow_tpu_torch.ops.attention import _check_ring_batch, _rotate
from kubeflow_tpu_torch.parallel.collectives import axis_size

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


def flash_kernels_take(head_dim: int, dtype) -> bool:
    """True when the CUDA kernels take q, k and v of this head dim and
    dtype: D of 64 or 128, bf16 or f32. It decides, by shape and before
    any call, whether a model's "auto" attention on CUDA runs the flash
    kernels or dense attention; a direct kernel call on anything else
    raises."""
    return head_dim in _KERNEL_HEAD_DIMS and dtype in _KERNEL_DTYPES


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


def flash_delta_reference(o, do):
    """delta = rowsum(dO∘O) in float32, as `_delta_kernel` computes it
    (kubeflow_tpu/ops/flash.py:549-559): [BH, S, D] → [BH, S]."""
    return (do.float() * o.float()).sum(-1)


def _bwd_blocks(q, k, v, do, lse, delta, causal, block_q, block_k):
    """The backward's shared set-up, as the JAX wrapper does it: pad to
    a tileable length (lse with +inf, so padded rows get p = 0; delta
    with 0), pick the blocks, and return a function that gives, for one
    block pair (i, j), the float32 (scale·q, k, dO, p, ds) of
    `_dq_body`/`_dkv_body` (kubeflow_tpu/ops/flash.py:562-676)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    sp_q = _pad_to_tileable(block_q, sq)
    sp_k = _pad_to_tileable(block_k, sk)
    kv_len = sk if sp_k != sk else None
    pad = lambda x, s: torch.nn.functional.pad(x, (0, 0, 0, s - x.shape[1]))
    q, do, k, v = pad(q, sp_q), pad(do, sp_q), pad(k, sp_k), pad(v, sp_k)
    lse = torch.nn.functional.pad(lse, (0, sp_q - sq), value=float("inf"))
    delta = torch.nn.functional.pad(delta, (0, sp_q - sq))
    bq = _pick_block(block_q, sp_q)
    bk = _pick_block(block_k, sp_k)
    scale = 1.0 / math.sqrt(d)
    rows = torch.arange(bq, device=q.device)[:, None]
    cols = torch.arange(bk, device=q.device)[None, :]

    def terms(i, j):
        rq, rk = slice(i * bq, (i + 1) * bq), slice(j * bk, (j + 1) * bk)
        qb = q[:, rq].float() * scale
        kb = k[:, rk].float()
        s = qb @ kb.transpose(1, 2)
        if causal:
            s = s.masked_fill(i * bq + rows < j * bk + cols, _NEG_INF)
        if kv_len is not None:
            s = s.masked_fill(j * bk + cols >= kv_len, _NEG_INF)
        p = torch.where(s == _NEG_INF, 0.0, torch.exp(s - lse[:, rq, None]))
        dob = do[:, rq].float()
        dp = dob @ v[:, rk].float().transpose(1, 2)
        ds = p * (dp - delta[:, rq, None])
        return qb, kb, dob, p, ds

    def runs(i, j):  # the rectangular grid's causal predicate
        return not causal or j * bk <= i * bq + bq - 1

    return terms, runs, (sp_q, sp_k, bq, bk, scale)


def flash_bwd_reference(
    q, k, v, do, lse, delta, *, causal: bool = True, block_q: int = 1024,
    block_k: int = 1024,
):
    """The two-pass backward in plain PyTorch: (dq, dk, dv) in the input
    dtypes from q, dO [BH, S_q, D], k, v [BH, S_k, D] and lse, delta
    [BH, S_q] float32.

    dq runs row-major over the key blocks j <= i (`_dq_body`), dk and dv
    column-major over the query blocks i >= j (`_dkv_body`), each on the
    compact triangle where it applies and on the predicated rectangular
    grid otherwise; all sums in float32, with JAX's masks and guards."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    terms, runs, (sp_q, sp_k, bq, bk, scale) = _bwd_blocks(
        q, k, v, do, lse, delta, causal, block_q, block_k
    )
    nq, nk = sp_q // bq, sp_k // bk
    compact = _compactable(causal, sp_q, sp_k, bq, bk)
    dq = torch.empty(bh, sp_q, d, device=q.device)
    dk = torch.empty(bh, sp_k, d, device=q.device)
    dv = torch.empty(bh, sp_k, d, device=q.device)
    for i in range(nq):
        acc = torch.zeros(bh, bq, d, device=q.device)
        for j in range(i + 1 if compact else nk):
            if runs(i, j):
                _, kb, _, _, ds = terms(i, j)
                acc = acc + ds @ kb
        dq[:, i * bq:(i + 1) * bq] = acc * scale
    for j in range(nk):
        dk_acc = torch.zeros(bh, bk, d, device=q.device)
        dv_acc = torch.zeros(bh, bk, d, device=q.device)
        for i in range(j, nq) if compact else range(nq):
            if runs(i, j):
                qb, _, dob, p, ds = terms(i, j)
                dv_acc = dv_acc + p.transpose(1, 2) @ dob
                dk_acc = dk_acc + ds.transpose(1, 2) @ qb
        dk[:, j * bk:(j + 1) * bk] = dk_acc
        dv[:, j * bk:(j + 1) * bk] = dv_acc
    return dq[:, :sq].to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype)


def flash_bwd_fused_reference(
    q, k, v, do, lse, delta, *, causal: bool = True, block_q: int = 1024,
    block_k: int = 1024,
):
    """The fused one-pass backward in plain PyTorch (`_dqkv_kernel_fused`,
    kubeflow_tpu/ops/flash.py:714-798): one column-major walk of the
    compact triangle, dk and dv per column, each step's ds·k added into
    its row's slot of a float32 dq ring, slot j flushed when column j
    ends. Only the compact grid (causal self-attention, square blocks)
    has it; other shapes raise ValueError, as JAX's `fused=True` does."""
    bh, sq, d = q.shape
    terms, _, (sp_q, sp_k, bq, bk, scale) = _bwd_blocks(
        q, k, v, do, lse, delta, causal, block_q, block_k
    )
    if not _compactable(causal, sp_q, sp_k, bq, bk):
        raise ValueError(
            "fused flash backward requires the compact causal grid (causal "
            f"self-attention, square blocks); got causal={causal} "
            f"sq={sp_q} sk={sp_k} bq={bq} bk={bk}"
        )
    nq = sp_q // bq
    ring = torch.empty(bh, sp_q, d, device=q.device)
    dq = torch.empty(bh, sp_q, d, device=q.device)
    dk = torch.empty(bh, sp_k, d, device=q.device)
    dv = torch.empty(bh, sp_k, d, device=q.device)
    for j in range(nq):
        dk_acc = torch.zeros(bh, bk, d, device=q.device)
        dv_acc = torch.zeros(bh, bk, d, device=q.device)
        for i in range(j, nq):
            qb, kb, dob, p, ds = terms(i, j)
            dv_acc = dv_acc + p.transpose(1, 2) @ dob
            dk_acc = dk_acc + ds.transpose(1, 2) @ qb
            slot = slice(i * bq, (i + 1) * bq)
            ring[:, slot] = ds @ kb if j == 0 else ring[:, slot] + ds @ kb
        dk[:, j * bk:(j + 1) * bk] = dk_acc
        dv[:, j * bk:(j + 1) * bk] = dv_acc
        dq[:, j * bq:(j + 1) * bq] = ring[:, j * bq:(j + 1) * bq] * scale
    sk = k.shape[1]
    return dq[:, :sq].to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype)


# -- the kernels ---------------------------------------------------------------


def _on_cpu(x) -> bool:
    """True for a CPU tensor (the plain versions), False for a CUDA one
    (the kernels); anything else is refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {x.device}")
    return False


def _check_kernel_inputs(*tensors, names="qkv", kernel: str = "flash_fwd") -> None:
    """What the CUDA kernels take: q, dO (and o) of one [BH, S_q, D]
    shape, k and v of one [BH, S_k, D] shape, all of one dtype and
    device, contiguous and 16-byte aligned, bf16 or f32, D 64 or 128
    (`flash_kernels_take`), any BH."""
    first = tensors[0]
    kv = [t.shape for n, t in zip(names, tensors) if n in ("k", "v")]
    rows = [t.shape for n, t in zip(names, tensors) if n not in ("k", "v")]
    if (any(t.dim() != 3 for t in tensors)
            or any(shape != rows[0] for shape in rows)
            or any(shape != kv[0] for shape in kv)
            or any(t.shape[0] != first.shape[0] or t.shape[2] != first.shape[2]
                   for t in tensors)):
        raise ValueError(
            f"{kernel} kernel: {', '.join(n for n in names if n not in ('k', 'v'))} "
            "must share one [BH, S_q, D] shape and k, v one [BH, S_k, D] "
            f"shape; got {', '.join(str(tuple(t.shape)) for t in tensors)}"
        )
    if first.dtype not in _KERNEL_DTYPES or any(
        t.dtype != first.dtype for t in tensors
    ):
        raise ValueError(
            f"{kernel} kernel: dtype must be bfloat16 or float32 for all of "
            f"{', '.join(names)}; got {', '.join(str(t.dtype) for t in tensors)}"
        )
    if first.shape[2] not in _KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{kernel} kernel: head dim must be one of {_KERNEL_HEAD_DIMS}; "
            f"got {first.shape[2]}"
        )
    for name, t in zip(names, tensors):
        if not t.is_contiguous():
            raise ValueError(f"{kernel} kernel: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel} kernel: {name} is not 16-byte aligned")
        if t.device != first.device:
            raise ValueError(
                f"{kernel} kernel: {name} is on {t.device}, {names[0]} on "
                f"{first.device}"
            )


def _check_rows(q, lse, delta) -> None:
    """lse and delta as the backward kernels take them: contiguous
    [BH, S] float32 on q's device."""
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(
                f"flash backward kernels: {name} must be a contiguous "
                f"[BH, S] float32 tensor on {q.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )


def _launch(library: str, entry: str, counter: str, device, *args) -> None:
    """Calls one C entry point on `device`'s current stream; raises
    `KernelLaunchError` if the runtime refused the launch, else counts
    it under `counter`."""
    lib = _kernels.library(library)
    with torch.cuda.device(device):
        err = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream
        )
    if err:
        raise _kernels.KernelLaunchError(
            f"{counter} kernel launch failed: "
            f"{lib.kftpu_error_string(err).decode()} (cudaError {err})"
        )
    _kernels.count_launch(counter)


def _self_attention(causal: bool, q, k) -> bool:
    """Causal self-attention: the case the causal kernels (and the TPU's
    compact grid) cover; everything else is rectangular."""
    return causal and q.shape[1] == k.shape[1]


def _flash_fwd_cuda(q, k, v):
    _check_kernel_inputs(q, k, v)
    bh, s, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, s, dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", "kftpu_flash_fwd", "flash_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, s, d, _KERNEL_DTYPES[q.dtype],
    )
    return o, lse


def _flash_fwd_rect_cuda(q, k, v, causal: bool):
    _check_kernel_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", "kftpu_flash_fwd_rect", "flash_fwd_rect", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_rect_shape(q, k, causal),
    )
    return o, lse


def flash_fwd(
    q, k, v, *, causal: bool = True, block_q: int = 1024, block_k: int = 1024
):
    """The wrapper: (o, lse) of flash attention, q [BH, S_q, D] against
    k, v [BH, S_k, D].

    CPU tensors run `flash_attention_reference`; CUDA tensors launch a
    Hopper kernel — the causal one for causal self-attention, the
    rectangular one otherwise — and there is no path from a CUDA tensor
    to the plain version. The blocks shape the plain version's schedule
    only; the kernels tile by their own sizes."""
    if _on_cpu(q):
        return flash_attention_reference(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k
        )
    if _self_attention(causal, q, k):
        return _flash_fwd_cuda(q, k, v)
    return _flash_fwd_rect_cuda(q, k, v, causal)


# -- the backward dispatch ------------------------------------------------------

# KFTPU_FLASH_FUSED_BWD=0 pins the two-pass backward everywhere, as in the
# JAX package (kubeflow_tpu/ops/flash.py:284-294). It is read at every
# backward call.
_FUSED_ENV = "KFTPU_FLASH_FUSED_BWD"


def _fused_enabled() -> bool:
    return os.environ.get(_FUSED_ENV, "1") != "0"


def flash_delta(o, do):
    """The wrapper: delta = rowsum(dO∘O) [BH, S] float32. CPU tensors run
    `flash_delta_reference`, CUDA tensors the kernel (csrc/flash_delta.cu)."""
    if _on_cpu(o):
        return flash_delta_reference(o, do)
    _check_kernel_inputs(o, do, names=("o", "dO"), kernel="flash_delta")
    return _flash_delta_cuda(o, do)


def _flash_delta_cuda(o, do):
    delta = torch.empty(o.shape[:2], dtype=torch.float32, device=o.device)
    _launch("flash_delta", "kftpu_flash_delta", "flash_delta", o.device,
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), *_bwd_shape(o))
    return delta


def flash_bwd_kernels(
    q, k, v, do, lse, delta, *, causal: bool = True, block_q: int = 1024,
    block_k: int = 1024, fused: bool | None = None,
):
    """(dq, dk, dv) over a precomputed (lse, delta): the counterpart of
    `_flash_bwd_kernels` (kubeflow_tpu/ops/flash.py:942-1130).

    ``fused=None`` takes the fused one-pass backward wherever it exists —
    the compact causal grid (on CUDA: causal self-attention) — unless
    ``KFTPU_FLASH_FUSED_BWD=0``; the TPU's VMEM budget has no counterpart.
    True or False pins a path; True off the compact grid raises
    ValueError, as JAX's does. CPU tensors run the plain versions, CUDA
    tensors the kernels (csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu): the
    causal two-pass kernels for causal self-attention, the rectangular
    ones otherwise."""
    if _on_cpu(q):
        sp_q = _pad_to_tileable(block_q, q.shape[1])
        sp_k = _pad_to_tileable(block_k, k.shape[1])
        compact = _compactable(
            causal, sp_q, sp_k, _pick_block(block_q, sp_q),
            _pick_block(block_k, sp_k),
        )
        if fused is None:
            fused = compact and _fused_enabled()
        plain = flash_bwd_fused_reference if fused else flash_bwd_reference
        return plain(
            q, k, v, do, lse, delta, causal=causal, block_q=block_q,
            block_k=block_k,
        )
    _check_kernel_inputs(q, k, v, do, names=("q", "k", "v", "dO"),
                         kernel="flash backward")
    _check_rows(q, lse, delta)
    compact = _self_attention(causal, q, k)
    if fused is None:
        fused = compact and _fused_enabled()
    if fused and not compact:
        raise ValueError(
            "fused flash backward requires the compact causal grid (causal "
            f"self-attention); got causal={causal} sq={q.shape[1]} "
            f"sk={k.shape[1]}"
        )
    if fused:
        return _flash_bwd_fused_cuda(q, k, v, do, lse, delta)
    if compact:
        return (_flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                *_flash_bwd_dkv_cuda(q, k, v, do, lse, delta))
    return (_flash_bwd_dq_rect_cuda(q, k, v, do, lse, delta, causal),
            *_flash_bwd_dkv_rect_cuda(q, k, v, do, lse, delta, causal))


def _bwd_args(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_shape(q):
    return (*q.shape, _KERNEL_DTYPES[q.dtype])


def _rect_shape(q, k, causal: bool):
    """(bh, s_q, s_k, d, causal, dtype), the rectangular kernels' ints."""
    bh, sq, d = q.shape
    return bh, sq, k.shape[1], d, int(causal), _KERNEL_DTYPES[q.dtype]


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta):
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", "kftpu_flash_bwd_dq", "flash_bwd_dq", q.device,
            *_bwd_args(q, k, v, do, lse, delta), dq.data_ptr(), *_bwd_shape(q))
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", "kftpu_flash_bwd_dkv", "flash_bwd_dkv", q.device,
            *_bwd_args(q, k, v, do, lse, delta), dk.data_ptr(), dv.data_ptr(),
            *_bwd_shape(q))
    return dk, dv


def _flash_bwd_dq_rect_cuda(q, k, v, do, lse, delta, causal: bool):
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", "kftpu_flash_bwd_dq_rect", "flash_bwd_dq_rect",
            q.device, *_bwd_args(q, k, v, do, lse, delta), dq.data_ptr(),
            *_rect_shape(q, k, causal))
    return dq


def _flash_bwd_dkv_rect_cuda(q, k, v, do, lse, delta, causal: bool):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", "kftpu_flash_bwd_dkv_rect", "flash_bwd_dkv_rect",
            q.device, *_bwd_args(q, k, v, do, lse, delta), dk.data_ptr(),
            dv.data_ptr(), *_rect_shape(q, k, causal))
    return dk, dv


def _flash_bwd_fused_cuda(q, k, v, do, lse, delta):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # The fused kernel's dq accumulator, zeroed by the call.
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("flash_bwd_dkv", "kftpu_flash_bwd_fused", "flash_bwd_fused",
            q.device, *_bwd_args(q, k, v, do, lse, delta), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), *_bwd_shape(q))
    return dq, dk, dv


def flash_bwd(
    q, k, v, o, lse, do, *, causal: bool = True, block_q: int = 1024,
    block_k: int = 1024, fused: bool | None = None,
):
    """The backward of `flash_fwd`: delta, then the fused or two-pass
    kernels (`_flash_bwd_impl`, kubeflow_tpu/ops/flash.py:1133-1141)."""
    do = do.contiguous()
    delta = flash_delta(o, do)
    return flash_bwd_kernels(
        q, k, v, do, lse, delta, causal=causal, block_q=block_q,
        block_k=block_k, fused=fused,
    )


class FlashAttentionFunction(torch.autograd.Function):
    """Counterpart of the custom VJP `_flash_bhsd` (kubeflow_tpu/ops/
    flash.py:1153-1202): [BH, S, D] q, k, v → (o, lse); saves
    (q, k, v, o, lse). The lse output carries no gradient: its cotangent
    is dropped. The backward runs with its own blocks (JAX's
    ``bwd_block_q``/``bwd_block_k``), which shape the plain versions'
    schedule only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, bwd_block_q, bwd_block_k):
        o, lse = flash_fwd(q, k, v, causal=causal, block_q=block_q,
                           block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.schedule = dict(causal=causal, block_q=bwd_block_q,
                            block_k=bwd_block_k)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, **ctx.schedule)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
    bwd_block_q: int | None = None,
    bwd_block_k: int | None = None,
    return_lse: bool = False,
):
    """Blockwise attention. q, k, v: [B, S, H, D] → [B, S, H, D].

    Runs in the head-major [B·H, S, D] layout, as the JAX function does.
    Ragged lengths need nothing from the caller: the plain version pads
    to a multiple of 128 and masks the tail (``kv_len``), the kernel
    masks its own ragged edge; either way the output has q's length.
    ``return_lse=True`` also returns the log-sum-exp as [B, H, S] f32,
    which carries no gradient. Gradients reach q, k and v through
    `FlashAttentionFunction`: the backward kernels on CUDA, their plain
    versions on the CPU."""
    b, sq, h, d = q.shape
    to_bhsd = lambda x: x.transpose(1, 2).contiguous().view(
        b * h, x.shape[1], d
    )
    o, lse = FlashAttentionFunction.apply(
        to_bhsd(q), to_bhsd(k), to_bhsd(v), causal, block_q, block_k,
        bwd_block_q or block_q, bwd_block_k or block_k,
    )
    o = o.reshape(b, h, sq, d).transpose(1, 2)
    if not return_lse:
        return o
    return o, lse.reshape(b, h, sq)


# -- ring flash: sequence-parallel flash attention ----------------------------
#
# Counterpart of kubeflow_tpu/ops/flash.py:1294-1560. Each ring position
# holds one sequence chunk; k/v chunks rotate around the ring
# (`ops/attention._rotate`) and every hop runs the flash kernels on the
# local [C, C] tile. Hop kinds: a chunk from an earlier position is a
# "full" hop (rectangular kernels, causal=False), the position's own
# chunk the diagonal (causal kernels), a later chunk is skipped under
# causality. Per-hop (o_i, lse_i) pairs merge in log-sum-exp space in
# float32; the backward re-walks the ring with the GLOBAL lse and one
# shared delta = rowsum(dO∘O) of the global output, accumulating dk/dv
# in the rotating frame and taking them home with one final rotation.
#
# The body runs over a leading dimension of the R ring positions this
# process holds (all n on an in-process ring, one on a process group).
# The positions of one hop kind are one contiguous run of that dimension
# and are folded into the kernels' BH dimension: one launch per hop kind.


def _hop_index(src: int, my: int) -> int:
    # 0 = full (earlier chunk), 1 = diagonal (own chunk), 2 = skip
    # (later chunk — fully masked under causality).
    return 1 if src == my else (0 if src < my else 2)


def _hop_groups(ring, i: int, causal: bool):
    """[(kernel causal flag, slice of local positions)] of hop i: the
    full hops, then the diagonal ones; skipped positions are left out.
    Each kind is one contiguous run: on an in-process ring hop 0 is all
    diagonal and hop i > 0 full on positions [i, n) (causal) or all of
    them, and a process ring holds one position."""
    n = axis_size(ring)
    kinds = [
        _hop_index((my - i) % n, my) if causal else 0 for my in ring.ranks
    ]
    groups = []
    for kind, kernel_causal in ((0, False), (1, True)):
        run = [j for j, x in enumerate(kinds) if x == kind]
        if run:
            groups.append((kernel_causal, slice(run[0], run[-1] + 1)))
    return groups


def _ring_flash_fwd_pass(q, k, v, ring, causal, bq, bk):
    """q, k, v [R, BH, C, D] → (o [R, BH, C, D] in q's dtype, the global
    lse [R, BH, C] float32)."""
    r, bh, c, d = q.shape
    acc = torch.zeros(r, bh, c, d, device=q.device)
    m = torch.full((r, bh, c, 1), _NEG_INF, device=q.device)
    l = torch.zeros(r, bh, c, 1, device=q.device)
    k_cur, v_cur = k, v
    for i in range(axis_size(ring)):
        for hop_causal, sel in _hop_groups(ring, i, causal):
            o_i, lse_i = flash_fwd(
                q[sel].flatten(0, 1), k_cur[sel].flatten(0, 1),
                v_cur[sel].flatten(0, 1), causal=hop_causal, block_q=bq,
                block_k=bk,
            )
            # Log-sum-exp merge of the hop's normalized output (in q's
            # dtype) into the running global softmax, in float32.
            lse_i = lse_i.view(-1, bh, c, 1)
            m_sel = m[sel]
            m_new = torch.maximum(m_sel, lse_i)
            corr = torch.where(m_sel == _NEG_INF, 0.0, torch.exp(m_sel - m_new))
            w = torch.where(lse_i == _NEG_INF, 0.0, torch.exp(lse_i - m_new))
            acc[sel] = acc[sel] * corr + w * o_i.view(-1, bh, c, d).float()
            l[sel] = l[sel] * corr + w
            m[sel] = m_new
        if i + 1 < axis_size(ring):
            k_cur = _rotate(k_cur, ring)
            v_cur = _rotate(v_cur, ring)
    safe_l = torch.where(l == 0.0, 1.0, l)
    o = (acc / safe_l).to(q.dtype)
    return o, (m + torch.log(safe_l))[..., 0]


class RingFlashFunction(torch.autograd.Function):
    """Counterpart of the custom VJP `_ring_flash_body` (kubeflow_tpu/ops/
    flash.py:1408-1493): [R, BH, C, D] q, k, v → o; saves (q, k, v, o,
    lse). The backward runs delta once on the global (o, dO), then per
    hop `flash_bwd_kernels` with the global lse — the fused kernel on
    the diagonal (unless ``KFTPU_FLASH_FUSED_BWD=0``), the rectangular dq
    and dk/dv kernels on full hops — summing each hop's gradients, which
    come out in the input dtype, in float32."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, block_q, block_k):
        o, lse = _ring_flash_fwd_pass(q, k, v, ring, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.schedule = (ring, causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, causal, bq, bk = ctx.schedule
        n = axis_size(ring)
        r, bh, c, d = q.shape
        do = do.contiguous()
        # One delta for the whole ring: it depends only on the global
        # output and its cotangent, which every hop shares.
        delta = flash_delta(o.flatten(0, 1), do.flatten(0, 1)).view(r, bh, c)
        dq = torch.zeros(r, bh, c, d, device=q.device)
        # dk/dv accumulate in the rotating frame and travel with their
        # chunk.
        dk_cur = torch.zeros(r, bh, c, d, device=q.device)
        dv_cur = torch.zeros(r, bh, c, d, device=q.device)
        k_cur, v_cur = k, v
        for i in range(n):
            for hop_causal, sel in _hop_groups(ring, i, causal):
                dq_i, dk_i, dv_i = flash_bwd_kernels(
                    q[sel].flatten(0, 1), k_cur[sel].flatten(0, 1),
                    v_cur[sel].flatten(0, 1), do[sel].flatten(0, 1),
                    lse[sel].flatten(0, 1), delta[sel].flatten(0, 1),
                    causal=hop_causal, block_q=bq, block_k=bk,
                )
                dq[sel] += dq_i.view(-1, bh, c, d).float()
                dk_cur[sel] += dk_i.view(-1, bh, c, d).float()
                dv_cur[sel] += dv_i.view(-1, bh, c, d).float()
            if i + 1 < n:
                k_cur = _rotate(k_cur, ring)
                v_cur = _rotate(v_cur, ring)
                dk_cur = _rotate(dk_cur, ring)
                dv_cur = _rotate(dv_cur, ring)
        # After n-1 rotations each chunk's gradient sits one hop short of
        # home: one final rotation delivers dk/dv to their owners.
        dk, dv = _rotate(dk_cur, ring), _rotate(dv_cur, ring)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_flash_usable(x, chunk: int, block_q: int = 1024,
                      block_k: int = 1024) -> bool:
    """True when `ring_flash_attention` takes chunks of `chunk` tokens on
    `x`'s device. On CUDA wherever the kernels take x's head dim and
    dtype (`flash_kernels_take`), for any chunk: the kernels mask their
    own ragged edges, so every hop sees exactly its [C, C] tile. On the
    CPU only where the chunk divides into 8-aligned blocks without
    padding (`flash_kernel_tileable`), as in JAX, so the CPU ring answers
    and refuses as JAX's does."""
    if not _on_cpu(x):
        return flash_kernels_take(x.shape[-1], x.dtype)
    return flash_kernel_tileable(chunk, block_q) and flash_kernel_tileable(
        chunk, block_k
    )


def ring_flash_attention(
    q,
    k,
    v,
    mesh,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
):
    """Sequence-parallel flash attention over `mesh`'s sp ring.

    q, k, v: [B, S, H, D] — the whole sequence on an in-process ring,
    this rank's chunk on a `torch.distributed` ring (then C = S). Each
    hop runs the flash kernels on the local [C, C] tile (C = S / ring
    size), so per-position attention memory is O(C·D), not O(C²).
    Differentiable (`RingFlashFunction` re-walks the ring with global
    statistics). Falls back to `flash_attention` when the ring is
    trivial. On the CPU the chunks must tile without padding, on CUDA
    the kernels must take the head dim and dtype (`ring_flash_usable`)."""
    if mesh.shape["sp"] == 1:
        return flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k
        )
    ring = mesh.ring()
    local = len(ring.ranks)
    b, s, h, d = q.shape
    if s % local:
        raise ValueError(
            f"ring flash attention: sequence length {s} does not divide "
            f"the sp ring size {ring.size}"
        )
    chunk = s // local
    if not ring_flash_usable(q, chunk, block_q, block_k):
        if _on_cpu(q):
            raise ValueError(
                f"ring flash attention: per-device chunk {chunk} does not "
                "divide into 8-aligned flash blocks (the ring cannot pad); "
                "use ring_attention or resize the sp axis"
            )
        raise ValueError(
            f"ring flash attention: the kernels take head dim "
            f"{_KERNEL_HEAD_DIMS} in bf16 or f32, not {d} in {q.dtype}; "
            "use ring_attention"
        )
    _check_ring_batch(mesh, b)
    # Contiguous: the kernels take each hop kind's run of positions as one
    # [R'·BH, C, D] block (a reshape alone can leave a strided view).
    to_ring = lambda x: x.unflatten(1, (local, chunk)).permute(1, 0, 3, 2, 4).reshape(
        local, b * h, chunk, d
    ).contiguous()
    o = RingFlashFunction.apply(
        to_ring(q), to_ring(k), to_ring(v), ring, causal, block_q, block_k
    )
    return o.view(local, b, h, chunk, d).permute(1, 0, 3, 2, 4).reshape(b, s, h, d)
