"""Flash attention, forward and backward: Hopper kernels and their plain
versions.

Counterpart of `kubeflow_tpu/ops/flash.py`. There the kernels are Pallas
TPU kernels on the compact causal grid; here they are CUDA C++ kernels
under ``csrc/``, each with a plain PyTorch version beside it that runs
the JAX schedule — `_pick_block`, pad-to-128 plus the ``kv_len`` tail
mask, the lower-triangular (or predicated rectangular) block walk — with
the same masks, guards and float32 math:

| TPU kernel | CUDA kernel | plain version |
|---|---|---|
| `_fwd_kernel_compact` | ``csrc/flash_fwd.cu`` | `flash_attention_reference` |
| `_delta_kernel` | ``csrc/flash_delta.cu`` | `flash_delta_reference` |
| `_dq_kernel_compact` | ``csrc/flash_bwd_dq.cu`` | `flash_bwd_reference` |
| `_dkv_kernel_compact` | ``csrc/flash_bwd_dkv.cu`` | `flash_bwd_reference` |
| `_dqkv_kernel_fused` | ``csrc/flash_bwd_dkv.cu`` | `flash_bwd_fused_reference` |

The wrappers `flash_fwd`, `flash_delta` and `flash_bwd_kernels` are the
dispatch points: CPU tensors go to the plain versions, CUDA tensors to
the kernels (or an error). `FlashAttentionFunction` ties them into
autograd, and `flash_attention` runs through it on every device. The
kernels cover what `TransformerLM` runs: causal self-attention, any S
(they mask their own ragged edge, so nothing is padded on CUDA), D of 64
or 128, bf16 or f32. Not ported yet (ROADMAP Queue 2): the rectangular
`_fwd_kernel`, `_dq_kernel` and `_dkv_kernel` (non-causal, s_q != s_k)
and ring flash.
"""

from __future__ import annotations

import math
import os

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
    dtypes from q, k, v, dO [BH, S, D] and lse, delta [BH, S] float32.

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
    """What the CUDA kernels take: [BH, S, D] tensors of one shape, dtype
    and device, contiguous and 16-byte aligned, bf16 or f32, D 64 or 128."""
    first = tensors[0]
    if first.dim() != 3 or any(t.shape != first.shape for t in tensors):
        raise ValueError(
            f"{kernel} kernel: {', '.join(names)} must share one [BH, S, D] "
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
    if first.shape[0] > 65535:
        raise ValueError(
            f"{kernel} kernel: at most 65535 (batch*heads) rows; got "
            f"{first.shape[0]}"
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


def _check_kernel_shape(causal: bool, sq: int, sk: int) -> None:
    if not causal or sq != sk:
        raise NotImplementedError(
            "the CUDA flash kernels cover causal self-attention only; "
            "non-causal and s_q != s_k (the TPU's rectangular _fwd_kernel, "
            "_dq_kernel and _dkv_kernel) are ROADMAP Queue 2, items 5 and 6"
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


def flash_fwd(
    q, k, v, *, causal: bool = True, block_q: int = 1024, block_k: int = 1024
):
    """The wrapper: (o, lse) of flash attention over [BH, S, D] inputs.

    CPU tensors run `flash_attention_reference`; CUDA tensors launch the
    Hopper kernel, which takes causal self-attention only — there is no
    path from a CUDA tensor to the plain version. The blocks shape the
    plain version's schedule only; the kernel tiles by its own sizes."""
    if _on_cpu(q):
        return flash_attention_reference(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k
        )
    _check_kernel_shape(causal, q.shape[1], k.shape[1])
    return _flash_fwd_cuda(q, k, v)


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
    True or False pins a path. CPU tensors run the plain versions, CUDA
    tensors the kernels (csrc/flash_bwd_dq.cu, csrc/flash_bwd_dkv.cu)."""
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
    _check_kernel_shape(causal, q.shape[1], k.shape[1])
    _check_kernel_inputs(q, k, v, do, names=("q", "k", "v", "dO"),
                         kernel="flash backward")
    _check_rows(q, lse, delta)
    if fused is None:
        fused = _fused_enabled()
    if fused:
        return _flash_bwd_fused_cuda(q, k, v, do, lse, delta)
    return (_flash_bwd_dq_cuda(q, k, v, do, lse, delta),
            *_flash_bwd_dkv_cuda(q, k, v, do, lse, delta))


def _bwd_args(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_shape(q):
    return (*q.shape, _KERNEL_DTYPES[q.dtype])


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
