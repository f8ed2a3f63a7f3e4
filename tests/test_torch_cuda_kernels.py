"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU with nvcc and skip without one. They
import neither JAX nor the JAX package, so on a GPU machine without JAX
they run with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""

import pytest
import torch

from kubeflow_tpu_torch.ops import _kernels
from kubeflow_tpu_torch.ops import flash


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(cuda, bh, s, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(
        torch.randn(bh, s, d, generator=gen, device=cuda).to(dtype)
        for _ in range(3)
    )


def _assert_fwd_close(o, lse, ro, rlse, dtype):
    # f32: the reference gate; bf16: one bf16 rounding step (2^-7 relative).
    atol, rtol = (5e-5, 5e-5) if dtype == "float32" else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s,d", [
    (1, 64), (128, 64), (1001, 128), (2048, 128),
    # below one 64-key tile, and just past one 128-row block
    (17, 64), (63, 128), (129, 128), (1001, 64),
])
def test_flash_fwd_matches_plain_version(cuda, dtype, s, d):
    q, k, v = _qkv(cuda, 8, s, d, getattr(torch, dtype), seed=s)
    o, lse = flash.flash_fwd(q, k, v)
    ro, rlse = flash.flash_attention_reference(q, k, v)
    _assert_fwd_close(o, lse, ro, rlse, dtype)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(flash, "flash_attention_reference", refuse)
    q, k, v = _qkv(cuda, 2, 64, 64, torch.bfloat16, seed=0)
    before = _kernels.launches["flash_fwd"]
    o = flash.flash_attention(
        q.view(1, 2, 64, 64).transpose(1, 2), k.view(1, 2, 64, 64).transpose(1, 2),
        v.view(1, 2, 64, 64).transpose(1, 2),
    )
    torch.cuda.synchronize()
    assert o.shape == (1, 64, 2, 64) and o.is_cuda
    assert _kernels.launches["flash_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["head-dim-96"])
def test_kernel_refuses_what_it_does_not_cover(cuda, case):
    q, k, v = _qkv(cuda, 2, 64, 96, torch.bfloat16, seed=1)
    with pytest.raises(ValueError):
        flash.flash_fwd(q, k, v)


def _rect(cuda, bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    draw = lambda s: torch.randn(bh, s, d, generator=gen, device=cuda).to(dtype)
    return draw(sq), draw(sk), draw(sk), draw(sq)


RECT_CASES = [  # causal, s_q, s_k, d
    (False, 128, 128, 64),
    (False, 1001, 777, 128),
    (True, 1001, 777, 128),
    (True, 300, 1500, 64),
    (False, 64, 2048, 128),
]
RECT_IDS = ["noncausal", "ragged", "ragged-causal", "causal-sq<sk", "cross"]
# Forward-only edges: causal with s_q > s_k past several key tiles, q and k
# below one tile, one row and one key.
FWD_RECT_EDGES = [
    (True, 2048, 300, 128),
    (True, 17, 63, 64),
    (False, 63, 17, 128),
    (False, 1, 1, 64),
]
FWD_RECT_EDGE_IDS = ["causal-sq>sk", "causal-sub-tile", "sub-tile", "one-key"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,sq,sk,d", RECT_CASES + FWD_RECT_EDGES,
                         ids=RECT_IDS + FWD_RECT_EDGE_IDS)
def test_flash_fwd_rect_matches_plain_version(cuda, dtype, causal, sq, sk, d):
    """Non-causal and s_q != s_k launch the rectangular kernel (and only
    it) and agree with the plain version on the predicated rectangular
    grid, top-left causal mask included."""
    q, k, v, _ = _rect(cuda, 4, sq, sk, d, getattr(torch, dtype), seed=sq + sk)
    before = dict(_kernels.launches)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    grew = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c != before.get(n, 0)}
    assert grew == {"flash_fwd_rect": 1}
    ro, rlse = flash.flash_attention_reference(q, k, v, causal=causal)
    _assert_fwd_close(o, lse, ro, rlse, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 1001, 1001, 128), (False, 1001, 777, 128), (True, 513, 1500, 64),
    (True, 1500, 513, 64),
], ids=["causal", "noncausal-ragged", "causal-sq<sk", "causal-sq>sk"])
def test_flash_fwd_matches_plain_version_on_sharp_logits(cuda, dtype, causal, sq, sk, d):
    """q scaled x8, so the logits are 8x (a standard deviation of 8 after
    the 1/sqrt(d) scale): the running max moves often and far, which
    drives the online softmax's rescaling, and rows near the diagonal see
    few keys. Both kernels, at the unchanged tolerances. (Scaling q and k
    both by 8, logits x64 and s near 500, puts ~3e-5 of float32 rounding
    into s itself, and then even the float32 kernel leaves the 5e-5 gate
    against the plain version, which rounds s in another order.)"""
    q, k, v, _ = _rect(cuda, 4, sq, sk, d, getattr(torch, dtype), seed=sq * 7 + sk)
    q = (q.float() * 8).to(q.dtype)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    ro, rlse = flash.flash_attention_reference(q, k, v, causal=causal)
    _assert_fwd_close(o, lse, ro, rlse, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,sq,sk", [(True, 2048, 2048), (False, 1001, 777)],
                         ids=["causal", "rect"])
def test_bf16_flash_fwd_is_bitwise_deterministic(cuda, causal, sq, sk):
    """The bf16 forward gives the same bits on every run (no atomics, a
    fixed order of sums): the ring over NCCL relies on it to reproduce
    the in-process ring's o exactly."""
    q, k, v, _ = _rect(cuda, 16, sq, sk, 128, torch.bfloat16, seed=3)
    first = flash.flash_fwd(q, k, v, causal=causal)
    for _ in range(3):
        again = flash.flash_fwd(q, k, v, causal=causal)
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def _close_bwd(got, want, dtype):
    """|kernel − plain| <= atol + rtol·|plain|. Gradients grow with S, so
    atol is JAX's 5e-5 gate relative to the plain result's RMS; bf16
    outputs add one rounding step of the same float32 value (2^-7)."""
    want = want.float()
    atol = 5e-5 * want.pow(2).mean().sqrt().item()
    rtol = 5e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s,d", [(1, 64), (128, 64), (1001, 128), (2048, 128)])
def test_flash_delta_matches_plain_version(cuda, dtype, s, d):
    o, do, _ = _qkv(cuda, 8, s, d, getattr(torch, dtype), seed=s + 1)
    before = _kernels.launches["flash_delta"]
    got = flash.flash_delta(o, do)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_delta"] == before + 1
    _close_bwd(got, flash.flash_delta_reference(o, do), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "two-pass"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s,d", [(1, 64), (128, 64), (1001, 128), (2048, 128)])
def test_flash_bwd_kernels_match_plain_version(cuda, dtype, s, d, fused):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(cuda, 8, s, d, dt, seed=s + 2)
    do = _qkv(cuda, 8, s, d, dt, seed=s + 3)[0]
    o, lse = flash.flash_fwd(q, k, v)
    delta = flash.flash_delta(o, do)
    names = ("flash_bwd_fused",) if fused else ("flash_bwd_dq", "flash_bwd_dkv")
    before = {n: _kernels.launches[n] for n in names}
    got = flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=fused)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == before[n] + 1 for n in names)
    plain = flash.flash_bwd_fused_reference if fused else flash.flash_bwd_reference
    want = plain(q, k, v, do, lse, delta)
    for g, w in zip(got, want):
        assert g.dtype == dt and torch.isfinite(g).all()
        _close_bwd(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gradients_reach_q_k_v_through_flash_attention(cuda, dtype):
    """The backward kernels are in autograd: q, k and v get gradients
    through `flash_attention` on CUDA, equal to the plain backward's on
    the same o, lse and dO."""
    dt = getattr(torch, dtype)
    q, k, v = (x.view(2, 4, 256, 128).transpose(1, 2).detach().requires_grad_()
               for x in _qkv(cuda, 8, 256, 128, dt, seed=5))
    w = _qkv(cuda, 8, 256, 128, dt, seed=7)[0]
    bhsd = lambda x: x.detach().transpose(1, 2).reshape(8, 256, 128).contiguous()
    before = _kernels.launches["flash_bwd_fused"]
    (flash.flash_attention(q, k, v) * w.view(2, 4, 256, 128).transpose(1, 2)).sum().backward()
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_fused"] == before + 1
    o, lse = flash.flash_fwd(bhsd(q), bhsd(k), bhsd(v))
    want = flash.flash_bwd_fused_reference(
        bhsd(q), bhsd(k), bhsd(v), w, lse, flash.flash_delta_reference(o, w)
    )
    for t, expected in zip((q, k, v), want):
        assert t.grad is not None
        _close_bwd(bhsd(t.grad), expected, dtype)


@pytest.mark.cuda
def test_fused_env_zero_pins_the_two_pass_kernels(cuda, monkeypatch):
    monkeypatch.setenv("KFTPU_FLASH_FUSED_BWD", "0")
    q, k, v = (x.view(1, 2, 128, 64).transpose(1, 2).detach().requires_grad_()
               for x in _qkv(cuda, 2, 128, 64, torch.bfloat16, seed=6))
    before = dict(_kernels.launches)
    flash.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    grew = {n for n in _kernels.launches if _kernels.launches[n] != before.get(n, 0)}
    assert grew == {"flash_fwd", "flash_delta", "flash_bwd_dq", "flash_bwd_dkv"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("causal,sq,sk,d", RECT_CASES, ids=RECT_IDS)
def test_flash_bwd_rect_kernels_match_plain_version(cuda, dtype, causal, sq, sk, d):
    """The rectangular dq and dk/dv kernels, on the rectangular
    forward's lse and the delta kernel's delta, against the plain
    two-pass backward; fused=None never takes the fused kernel here."""
    dt = getattr(torch, dtype)
    q, k, v, do = _rect(cuda, 4, sq, sk, d, dt, seed=sq * 3 + sk)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    delta = flash.flash_delta(o, do)
    before = dict(_kernels.launches)
    got = flash.flash_bwd_kernels(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    grew = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c != before.get(n, 0)}
    assert grew == {"flash_bwd_dq_rect": 1, "flash_bwd_dkv_rect": 1}
    want = flash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal)
    for g, w, shape in zip(got, want, (q.shape, k.shape, k.shape)):
        assert g.dtype == dt and g.shape == shape and torch.isfinite(g).all()
        _close_bwd(g, w, dtype)
    with pytest.raises(ValueError, match="compact causal grid"):
        flash.flash_bwd_kernels(q, k, v, do, lse, delta, causal=causal, fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_on_the_card_matches_the_plain_ring(cuda, causal):
    """An in-process sp=4 ring on the card (one launch per hop kind: the
    diagonal on the causal kernels, full hops on the rectangular ones)
    against the same ring on the CPU, which runs the plain versions, in
    f32: forward and the q/k/v gradients."""
    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(sp=4))
    gen = torch.Generator().manual_seed(11)
    q, k, v, w = (torch.randn(2, 512, 4, 64, generator=gen) for _ in range(4))
    results = []
    for device in ("cpu", cuda):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        before = dict(_kernels.launches)
        o = ring_flash_attention(*ts, mesh, causal=causal)
        (o * w.to(device)).sum().backward()
        results.append([x.detach().cpu() for x in (o, *(t.grad for t in ts))])
    grew = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c != before.get(n, 0)}
    if causal:
        assert grew == {"flash_fwd": 1, "flash_fwd_rect": 3, "flash_delta": 1,
                        "flash_bwd_fused": 1, "flash_bwd_dq_rect": 3,
                        "flash_bwd_dkv_rect": 3}
    else:
        assert grew == {"flash_fwd_rect": 4, "flash_delta": 1,
                        "flash_bwd_dq_rect": 4, "flash_bwd_dkv_rect": 4}
    for got, want in zip(results[1], results[0]):
        _close_bwd(got, want, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_on_the_card_takes_a_chunk_that_does_not_tile(cuda, causal):
    """On the card the ring takes chunks that the CPU ring refuses as
    JAX's does (201 tokens: no 8-aligned block divides it), because the
    kernels mask their own ragged edges. Forward and the q/k/v gradients
    of an sp=4 ring against dense attention over the whole sequence on
    the CPU, in f32. The LM's sp branch takes ring flash for such chunks
    on the card, not the dense-hop ring."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig, _attend
    from kubeflow_tpu_torch.ops.attention import dense_attention
    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(sp=4))
    assert not flash.flash_kernel_tileable(201)
    gen = torch.Generator().manual_seed(12)
    q, k, v, w = (torch.randn(1, 4 * 201, 2, 64, generator=gen) for _ in range(4))
    results = []
    for device, attend in (
        ("cpu", lambda *ts: dense_attention(*ts, causal=causal)),
        (cuda, lambda *ts: ring_flash_attention(*ts, mesh, causal=causal)),
    ):
        ts = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        before = dict(_kernels.launches)
        o = attend(*ts)
        (o * w.to(device)).sum().backward()
        results.append([x.detach().cpu() for x in (o, *(t.grad for t in ts))])
    grew = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c != before.get(n, 0)}
    assert grew["flash_fwd_rect"] == 3 + (not causal)
    assert grew["flash_bwd_dq_rect"] == grew["flash_bwd_dkv_rect"] == 3 + (not causal)
    for got, want in zip(results[1], results[0]):
        _close_bwd(got, want, "float32")

    cfg = TransformerConfig(n_heads=2, head_dim=64, dtype=torch.float32,
                            attention_impl="auto")
    before = _kernels.launches.get("flash_fwd_rect", 0)
    with torch.no_grad():
        o = _attend(*(t.to(cuda) for t in (q, k, v)), mesh, cfg)
    assert _kernels.launches.get("flash_fwd_rect", 0) == before + 3
    _close_bwd(o.cpu(), dense_attention(q, k, v), "float32")
