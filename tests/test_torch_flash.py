"""The port's flash attention against the JAX package's.

On the CPU the port's `flash_attention` runs its plain version
(`flash_attention_reference`); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do. Inputs come from numpy, so both
sides see the same numbers. Tolerance: the reference's own f32
flash-vs-dense gate, atol = rtol = 5e-5 (tests/test_flash_schedule.py).
The CUDA kernel itself is checked against the plain version on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash as jflash
from kubeflow_tpu.ops.attention import dense_attention as jdense
from kubeflow_tpu_torch.ops import flash as tflash
from kubeflow_tpu_torch.ops.attention import dense_attention as tdense

TOL = dict(atol=5e-5, rtol=5e-5)


def _qkv(seed, b, sq, sk, h, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((b, s, h, d)).astype(dtype) for s in (sq, sk, sk)
    )


@pytest.mark.parametrize(
    "s,block",
    [(8, 64), (128, 64), (200, 40), (201, 64)],
    ids=["s8", "s128", "s200-block40", "s201-padded"],
)
def test_flash_matches_jax_flash_and_dense(s, block):
    q, k, v = _qkv(s, 2, s, s, 2, 32)
    jo, jlse = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=block, block_k=block, interpret=True, return_lse=True,
    )
    to, tlse = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, block_q=block, block_k=block, return_lse=True,
    )
    assert to.shape == q.shape and tlse.shape == (2, 2, s)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    dense = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(dense), **TOL)


@pytest.mark.parametrize(
    "causal,sq,sk,bq,bk",
    [(False, 128, 128, 64, 64), (True, 64, 128, 32, 64), (True, 128, 128, 64, 32)],
    ids=["noncausal", "cross-sq-ne-sk", "uneven-blocks"],
)
def test_plain_version_follows_rectangular_schedule(causal, sq, sk, bq, bk):
    """Cases off the compact grid: the plain version keeps the TPU
    rectangular kernel's semantics (its causal mask has no s_k - s_q
    offset), so it is held against JAX flash, not dense."""
    q, k, v = _qkv(7, 1, sq, sk, 2, 16)
    jo, jlse = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk, interpret=True, return_lse=True,
    )
    to, tlse = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=bq, block_k=bk, return_lse=True,
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    q, k, v = _qkv(3, 2, 48, 48, 3, 16)
    want = jdense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    got = tdense(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_flash_keeps_input_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(5, 1, 64, 64, 2, 16))
    o, lse = tflash.flash_attention(q, k, v, block_q=32, block_k=32, return_lse=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = tdense(q.float(), k.float(), v.float())
    # Flash keeps p in f32 and rounds once at the end: one bf16 step.
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), atol=1e-2, rtol=1e-2)


def _emulate_tensor_core_fwd(q, k, v, causal, split_p, bk=128):
    """The bf16 CUDA forward's arithmetic (csrc/flash_fwd.cu, flash_fwd_tc)
    in plain torch: s = q.k^T from bf16 inputs (exact products, float32
    sums); the online softmax over 128-key tiles in base 2, m kept in
    log2 units; p.v with p as bf16 — p_hi + p_lo, two products into one
    float32 accumulator, or (split_p=False) p rounded once — and v bf16;
    O rounded once to bf16, lse = m ln2 + log l."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    neg_inf = float("-inf")
    m = torch.full((bh, sq, 1), neg_inf)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        s = qf @ kf[:, k0:k0 + bk].transpose(1, 2)
        if causal:
            s = s.masked_fill(k0 + torch.arange(s.shape[-1])[None, :] > rows, neg_inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale_log2)
        safe_m = torch.where(m_new == neg_inf, 0.0, m_new)
        corr = torch.where(m == neg_inf, 0.0, torch.exp2(m - safe_m))
        p = torch.exp2(s * scale_log2 - safe_m)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        vb = vf[:, k0:k0 + bk]
        acc = acc * corr + hi @ vb
        if split_p:
            acc = acc + (p - hi).bfloat16().float() @ vb
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(m == neg_inf, neg_inf, m * math.log(2) + torch.log(safe_l))
    return (acc / safe_l).bfloat16(), lse[..., 0]


@pytest.mark.parametrize(
    "causal,sq,sk,d",
    [(True, 256, 256, 64), (False, 200, 333, 128), (True, 300, 130, 64)],
    ids=["causal", "rect", "causal-sq>sk"],
)
def test_bf16_kernel_needs_p_split_to_hold_its_gate(causal, sq, sk, d):
    """Why the bf16 tensor-core forward splits p into bf16 hi + lo: with
    the split its arithmetic stays inside the bf16 forward gate the card
    holds the kernel to (o: atol 1e-5, rtol 2^-7 against the plain
    version; lse: 5e-5), and with p rounded once to bf16 it does not —
    each term then carries 2^-9 of relative error, more than the gate
    allows where a row's output nearly cancels."""
    rng = np.random.default_rng(sq + sk + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, d)).astype(np.float32)).bfloat16()
               for s in (sq, sk, sk))
    ro, rlse = tflash.flash_attention_reference(q, k, v, causal=causal)
    gate = dict(atol=1e-5, rtol=2.0 ** -7)

    o, lse = _emulate_tensor_core_fwd(q, k, v, causal, split_p=True)
    torch.testing.assert_close(o.float(), ro.float(), **gate)
    torch.testing.assert_close(lse, rlse, atol=5e-5, rtol=5e-5)

    o_once, _ = _emulate_tensor_core_fwd(q, k, v, causal, split_p=False)
    assert not torch.allclose(o_once.float(), ro.float(), **gate)


@pytest.mark.parametrize("block", [1024, 512, 128, 64, 40])
def test_schedule_helpers_match_jax(block):
    for s in range(1, 4097):
        jt, tt = jflash._tileable(block, s), tflash._tileable(block, s)
        assert jt == tt, s
        if jt:
            assert jflash._pick_block(block, s) == tflash._pick_block(block, s), s
        sp = jflash._pad_to_tileable(block, s)
        assert sp == tflash._pad_to_tileable(block, s), s
        b = jflash._pick_block(block, sp)
        assert jflash._compactable(True, sp, sp, b, b) == tflash._compactable(
            True, sp, sp, b, b
        ), s
        assert jflash._grid_steps(True, sp, sp, b, b) == tflash._grid_steps(
            True, sp, sp, b, b
        ), s
        assert jflash._grid_steps(False, sp, sp, b, b) == tflash._grid_steps(
            False, sp, sp, b, b
        ), s
        assert jflash.flash_kernel_tileable(s, block) == tflash.flash_kernel_tileable(
            s, block
        )
    assert tflash.flash_usable(1, 1) and not tflash.flash_usable(0, 5)


def test_compact_cap_matches_jax():
    # nq*(nq+1)/2 steps past 65536 leave the TPU's compact grid.
    for nq in (361, 362):
        s = nq * 8
        assert jflash._compactable(True, s, s, 8, 8) == tflash._compactable(
            True, s, s, 8, 8
        )
    assert tflash._compactable(True, 361 * 8, 361 * 8, 8, 8)
    assert not tflash._compactable(True, 362 * 8, 362 * 8, 8, 8)


def _kernel_inputs(shape=(4, 64, 64), dtype=torch.bfloat16):
    return tuple(torch.zeros(shape, dtype=dtype) for _ in range(3))


@pytest.mark.parametrize(
    "case",
    ["head-dim-96", "float16", "non-contiguous", "shape-mismatch"],
)
def test_kernel_input_checks_refuse(case):
    q, k, v = _kernel_inputs()
    if case == "head-dim-96":
        q, k, v = _kernel_inputs((4, 64, 96))
    elif case == "float16":
        q, k, v = _kernel_inputs(dtype=torch.float16)
    elif case == "non-contiguous":
        q = torch.zeros(64, 4, 64, dtype=torch.bfloat16).transpose(0, 1)
    else:
        k = torch.zeros(4, 32, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tflash._check_kernel_inputs(q, k, v)


def test_kernel_input_checks_accept_supported_shapes():
    for d in (64, 128):
        for dtype in (torch.bfloat16, torch.float32):
            tflash._check_kernel_inputs(*_kernel_inputs((3, 1001, d), dtype))


def test_flash_fwd_dispatches_cpu_tensors_to_plain_version():
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
               for x in _qkv(9, 1, 96, 96, 2, 16))
    o, lse = tflash.flash_fwd(q, k, v, block_q=32, block_k=32)
    ro, rlse = tflash.flash_attention_reference(q, k, v, block_q=32, block_k=32)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
