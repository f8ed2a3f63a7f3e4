"""The port's flash-attention backward against the JAX package's.

On the CPU the port's backward runs its plain versions
(`flash_delta_reference`, `flash_bwd_reference`,
`flash_bwd_fused_reference`); the JAX side runs its Pallas kernels in
interpret mode, as its own tests do, on the same numpy inputs. The
kernels' lse/delta layouts (lane-replicated or lane-packed) are read
back as plain [BH, S] rows. Tolerances are JAX's own gradient gates:
f32 atol = rtol = 5e-5 (tests/test_flash_schedule.py), 5e-4 where a
ragged tail is padded and masked. The CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda_kernels.py and
chip_smoke.py); an emulation of the bf16 tensor-core backward's rounding
shows which form of p and ds those kernels need.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash as jflash
from kubeflow_tpu_torch.ops import flash as tflash

TOL = dict(atol=5e-5, rtol=5e-5)
RAGGED_TOL = dict(atol=5e-4, rtol=5e-4)
CASES = [(128, 64, TOL), (201, 64, RAGGED_TOL)]
IDS = ["s128-block64", "s201-ragged"]


def _arrays(seed, n, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jax_backward_inputs(s, block, packed=False):
    """q, k, v, dO at length s, and the JAX forward's o, lse and delta on
    the padded length its wrapper would use (dO zero past s, as the
    cotangent of the sliced output is)."""
    q, k, v, do = _arrays(s, 4, (2, s, 32))
    sp = jflash._pad_to_tileable(block, s)
    kv_len = s if sp != s else None
    pad = lambda x: jnp.pad(jnp.asarray(x), ((0, 0), (0, sp - s), (0, 0)))
    jq, jk, jv, jdo = map(pad, (q, k, v, do))
    o, lse = jflash._flash_fwd_impl(jq, jk, jv, True, block, block, True, kv_len, packed)
    delta = jflash._flash_delta_impl(o, jdo, block, True, packed)
    return (q, k, v, do), (jq, jk, jv, jdo, o, lse, delta, kv_len)


def _rows(layout, sp):
    """Either lse/delta layout → [BH, S] rows (numpy)."""
    return np.asarray(jflash._lse_rows(layout, sp))[..., 0]


def test_delta_matches_jax_delta_kernel():
    for s, block, packed in ((128, 64, False), (256, 128, True)):
        o, do = _arrays(s, 2, (2, s, 32))
        want = jflash._flash_delta_impl(jnp.asarray(o), jnp.asarray(do), block, True, packed)
        got = tflash.flash_delta_reference(torch.from_numpy(o), torch.from_numpy(do))
        assert got.shape == (2, s) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _rows(want, s), atol=1e-5, rtol=1e-5)
        assert torch.equal(tflash.flash_delta(torch.from_numpy(o), torch.from_numpy(do)), got)


@pytest.mark.parametrize("fused", [False, True], ids=["two-pass", "fused"])
@pytest.mark.parametrize("s,block,tol", CASES, ids=IDS)
def test_plain_backward_matches_jax_kernels(s, block, tol, fused):
    (q, k, v, do), (jq, jk, jv, jdo, o, lse, delta, kv_len) = _jax_backward_inputs(s, block)
    want = jflash._flash_bwd_kernels(
        jq, jk, jv, jdo, lse, delta, True, block, block, True, kv_len, False, fused,
    )
    sp = jq.shape[1]
    plain = tflash.flash_bwd_fused_reference if fused else tflash.flash_bwd_reference
    got = plain(
        *(torch.from_numpy(x) for x in (q, k, v, do)),
        torch.from_numpy(_rows(lse, sp)[:, :s].copy()),
        torch.from_numpy(_rows(delta, sp)[:, :s].copy()),
        causal=True, block_q=block, block_k=block,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == (2, s, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :s], err_msg=name, **tol)


@pytest.mark.parametrize("s,block", [(256, 64), (201, 64)])
def test_fused_equals_two_pass_plain_versions(s, block):
    """The fusion is a schedule change, not a numerics change: the
    column walk's dq ring adds each row's contributions in the same order
    as the row-major dq pass."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(s + 1, 4, (3, s, 16)))
    o, lse = tflash.flash_attention_reference(q, k, v, block_q=block, block_k=block)
    delta = tflash.flash_delta_reference(o, do)
    kw = dict(causal=True, block_q=block, block_k=block)
    fused = tflash.flash_bwd_fused_reference(q, k, v, do, lse, delta, **kw)
    two = tflash.flash_bwd_reference(q, k, v, do, lse, delta, **kw)
    for f, t in zip(fused, two):
        assert torch.equal(f, t)


@pytest.mark.parametrize("fused_env", ["1", "0"], ids=["fused", "two-pass"])
@pytest.mark.parametrize("s,block,tol", CASES, ids=IDS)
def test_autograd_matches_jax_grad(s, block, tol, fused_env, monkeypatch):
    monkeypatch.setenv("KFTPU_FLASH_FUSED_BWD", fused_env)
    q, k, v, do = _arrays(s + 7, 4, (2, s, 2, 32))

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=True, block_q=block,
                                   block_k=block, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tflash.flash_attention(tq, tk, tv, block_q=block, block_k=block,
                                    return_lse=True)
    assert o.requires_grad and not lse.requires_grad
    (o * torch.from_numpy(do)).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **tol)


def test_backward_dispatch_follows_the_jax_rule(monkeypatch):
    calls = []
    for name in ("flash_bwd_reference", "flash_bwd_fused_reference"):
        original = getattr(tflash, name)

        def spy(*a, _name=name, _original=original, **kw):
            calls.append(_name)
            return _original(*a, **kw)

        monkeypatch.setattr(tflash, name, spy)
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(3, 4, (1, 128, 16)))
    o, lse = tflash.flash_attention_reference(q, k, v, block_q=64, block_k=64)
    delta = tflash.flash_delta(o, do)
    run = lambda **kw: tflash.flash_bwd_kernels(q, k, v, do, lse, delta, **kw)

    run(block_q=64, block_k=64)  # compact causal grid: fused
    run(block_q=64, block_k=32)  # uneven blocks: two-pass
    run(block_q=64, block_k=64, fused=False)
    monkeypatch.setenv("KFTPU_FLASH_FUSED_BWD", "0")
    run(block_q=64, block_k=64)
    assert calls == ["flash_bwd_fused_reference"] + ["flash_bwd_reference"] * 3
    with pytest.raises(ValueError, match="compact causal grid"):
        run(block_q=64, block_k=32, fused=True)
    with pytest.raises(ValueError, match="compact causal grid"):
        run(block_q=64, block_k=64, causal=False, fused=True)


def test_bf16_gradients_keep_the_input_dtype():
    q, k, v = (torch.from_numpy(x).bfloat16().requires_grad_()
               for x in _arrays(4, 3, (1, 64, 2, 16)))
    tflash.flash_attention(q, k, v, block_q=32, block_k=32).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (q, k, v))
    want = [t.grad.float() for t in (q, k, v)]
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    tflash.flash_attention(q32, k32, v32, block_q=32, block_k=32).sum().backward()
    # bf16 inputs, f32 math, one bf16 rounding of each gradient (the
    # forward's o is rounded too, which moves delta by ~2^-8 relative).
    for g, w in zip(want, (q32.grad, k32.grad, v32.grad)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ["lse-shape", "lse-dtype", "delta-noncontiguous"])
def test_backward_row_checks_refuse(case):
    q = torch.zeros(2, 64, 64)
    lse = torch.zeros(2, 64)
    delta = torch.zeros(2, 64)
    if case == "lse-shape":
        lse = torch.zeros(2, 32)
    elif case == "lse-dtype":
        lse = lse.bfloat16()
    else:
        delta = torch.zeros(64, 2).T
    with pytest.raises(ValueError):
        tflash._check_rows(q, lse, delta)
    tflash._check_rows(q, torch.zeros(2, 64), torch.zeros(2, 64))


def _emulate_tensor_core_bwd(q, k, v, do, lse, delta, causal, terms, bq=64):
    """The bf16 tensor-core backward's arithmetic (csrc/flash_bwd_dkv.cu,
    flash_bwd_tc) in plain torch, over 64-row q tiles: s^T = k.q^T and
    dp^T = v.dO^T from bf16 inputs (exact products, float32 sums); p =
    exp2(s·scale·log2(e) − lse·log2(e)), 0 where masked; ds = p(dp −
    delta); each tile's dv = p^T.dO, dk = ds^T.q and dq = ds.k with p and
    ds as `terms` bf16 terms (hi + mid + lo for 3, each rounding what the
    ones before left over; 1 is a single rounding), added to float32 sums;
    dk and dq scaled at the end, each gradient rounded once to bf16."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    log2e = math.log2(math.e)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    dq, dk, dv = torch.zeros(bh, sq, d), torch.zeros(bh, sk, d), torch.zeros(bh, sk, d)
    keys = torch.arange(sk)[:, None]

    def parts(x):
        out = []
        for _ in range(terms):
            out.append(x.bfloat16().float())
            x = x - out[-1]
        return out

    for q0 in range(0, sq, bq):
        rows = slice(q0, q0 + bq)
        st = kf @ qf[:, rows].transpose(1, 2)  # [BH, S_k, rows]
        dpt = vf @ dof[:, rows].transpose(1, 2)
        p = torch.exp2(st * (scale * log2e) - (lse[:, rows] * log2e)[:, None])
        if causal:
            p = p.masked_fill(q0 + torch.arange(st.shape[-1])[None, :] < keys, 0.0)
        ds = p * (dpt - delta[:, None, rows])
        dv += sum(part @ dof[:, rows] for part in parts(p))
        ds_parts = parts(ds)
        dk += sum(part @ qf[:, rows] for part in ds_parts)
        dq[:, rows] += sum(part.transpose(1, 2) @ kf for part in ds_parts)
    return (dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


def _within_bwd_gate(got, want):
    """chip_smoke's bf16 backward gate: |got − want| <= atol + rtol·|want|
    with atol = 5e-5·RMS(want) and rtol = 2^-7 (one bf16 rounding)."""
    want = want.float()
    atol = 5e-5 * want.pow(2).mean().sqrt().item()
    return bool(((got.float() - want).abs() <= atol + 2.0 ** -7 * want.abs()).all())


@pytest.mark.parametrize(
    "causal,sq,sk,d",
    [(True, 256, 256, 64), (False, 200, 333, 128), (True, 300, 130, 64),
     (True, 130, 300, 128)],
    ids=["causal", "rect", "causal-sq>sk", "causal-sq<sk"],
)
def test_bf16_backward_kernel_needs_p_and_ds_split_to_hold_its_gate(causal, sq, sk, d):
    """Why the bf16 tensor-core backward splits p and ds into bf16 terms:
    with hi + mid + lo its arithmetic keeps dq, dk and dv inside the bf16
    gradient gate the card holds the kernels to, and with p and ds
    rounded once to bf16 neither dv (p) nor dk (ds) does — each term then
    carries 2^-9 of relative error, more than the gate allows where a
    gradient's sum nearly cancels. (hi + lo, 2^-18 a term, holds it at
    these lengths but not at S = 16384, as PERF.md records.)"""
    rng = np.random.default_rng(sq * 7 + sk + d)
    q, do = (torch.from_numpy(rng.standard_normal((2, sq, d)).astype(np.float32)).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, sk, d)).astype(np.float32)).bfloat16()
            for _ in range(2))
    o, lse = tflash.flash_attention_reference(q, k, v, causal=causal)
    delta = tflash.flash_delta_reference(o, do)
    want = tflash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal)

    split = _emulate_tensor_core_bwd(q, k, v, do, lse, delta, causal, terms=3)
    for got, w, name in zip(split, want, ("dq", "dk", "dv")):
        assert _within_bwd_gate(got, w), name

    once = _emulate_tensor_core_bwd(q, k, v, do, lse, delta, causal, terms=1)
    assert not _within_bwd_gate(once[1], want[1])  # dk: ds rounded once
    assert not _within_bwd_gate(once[2], want[2])  # dv: p rounded once


def _round_toward_zero(x):
    """float64 → float32, rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _emulate_tensor_core_dq(q, k, v, do, lse, delta, terms, per_tile, bk=64):
    """The bf16 tensor-core rectangular dq's arithmetic (csrc/flash_bwd_dq.cu,
    flash_bwd_dq_tc), non-causal, in plain torch: s = q.k^T and dp = dO.v^T
    from bf16 inputs; p = exp2(s·scale·log2(e) − lse·log2(e)); ds = p(dp −
    delta) as `terms` bf16 terms; then, key tile by key tile (bk keys, 16
    keys a wgmma step, terms smallest first), dq += ds.k.

    The tensor cores' float32 accumulation is modelled as adding each
    step's exact product sum to the accumulator and rounding toward zero:
    a bias that grows with the number of steps one accumulator takes,
    which is what the card showed where one accumulator summed a long
    walk (PERF.md). ``per_tile`` sums each key tile's steps in a zeroed
    accumulator and adds the tile to dq with a float32 add (round to
    nearest), as the kernel does; otherwise the whole walk stays in one
    accumulator. dq is scaled and rounded once to bf16."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    log2e = math.log2(math.e)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    p = torch.exp2((qf @ kf.transpose(1, 2)) * (scale * log2e) - (lse * log2e)[..., None])
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    parts = []
    for _ in range(terms):
        parts.append(ds.bfloat16().float())
        ds = ds - parts[-1]
    steps = sk // 16
    k16 = kf.double().view(steps, 16, d)
    # step n's exact product sum, [steps, BH, S_q, D] per term
    sums = [torch.einsum("bqnk,nkd->nbqd", part.double().view(bh, sq, steps, 16), k16)
            for part in parts]
    dq = torch.zeros(bh, sq, d)
    per = bk // 16
    for t in range(sk // bk):
        acc = torch.zeros(bh, sq, d) if per_tile else dq
        for i in reversed(range(terms)):
            for kt in range(per):
                acc = _round_toward_zero(acc.double() + sums[i][t * per + kt])
        dq = dq + acc if per_tile else acc
    return (dq * scale).bfloat16()


def _bwd_gate_ratio(got, want):
    """The worst |got − want| over the bf16 gate's allowance (above 1: out
    of the gate)."""
    want = want.float()
    atol = 5e-5 * want.pow(2).mean().sqrt().item()
    return ((got.float() - want).abs() / (atol + 2.0 ** -7 * want.abs())).max().item()


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dq_kernel_needs_the_split_and_a_per_tile_sum_over_16384_keys(d):
    """Why the bf16 tensor-core rectangular dq splits ds into bf16 terms
    and sums each key tile in a zeroed accumulator, at S_k = 16384 (the
    long rect shape chip_smoke checks): with both, three terms hold the
    gate; ds rounded once leaves it many times over; and the three terms
    summed over all 16384 keys in one accumulator (3072 rounded steps)
    leave it under the tensor cores' rounding model. On these inputs hi +
    lo holds it too (the kernel keeps the dk/dv kernels' three terms;
    PERF.md leaves two as an open question)."""
    rng = np.random.default_rng(16384 + d)
    draw = lambda n: torch.from_numpy(
        rng.standard_normal((1, n, d)).astype(np.float32)).bfloat16()
    q, do, k, v = draw(64), draw(64), draw(16384), draw(16384)
    o, lse = tflash.flash_attention_reference(q, k, v, causal=False)
    delta = tflash.flash_delta_reference(o, do)
    want = tflash.flash_bwd_reference(q, k, v, do, lse, delta, causal=False)[0]
    args = (q, k, v, do, lse, delta)
    ratio = {
        (terms, per_tile): _bwd_gate_ratio(_emulate_tensor_core_dq(*args, terms, per_tile), want)
        for terms, per_tile in ((1, True), (2, True), (3, True), (3, False))
    }
    assert ratio[3, True] <= 1.0 and ratio[2, True] <= 1.0
    assert ratio[1, True] > 1.0
    assert ratio[3, False] > 1.0
