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


def _close_bwd(got, want, dtype, scale=None):
    """|kernel − plain| <= atol + rtol·|plain|. Gradients grow with S, so
    atol is JAX's 5e-5 gate relative to the gradient's scale, the plain
    result's RMS unless `scale` is given; bf16 outputs add one rounding
    step of the same float32 value (2^-7)."""
    want = want.float()
    if scale is None:
        scale = want.pow(2).mean().sqrt().item()
    atol = 5e-5 * scale
    rtol = 5e-5 if dtype == "float32" else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def _close_bwd_one_key(got, want):
    """The bf16 tensor-core backward where every row sees one key (S_k = 1,
    or causal with S_q = 1): p = 1 and dp = delta, so dq and dk are 0 in
    exact arithmetic and the kernel and the plain version each return
    float32 rounding noise, summed in different orders, whose own RMS is
    no scale. Each of them is held to 5e-5 of dv's RMS, against the plain
    version and in absolute value (noise, not a gradient); dv (last) is
    held to the gate as everywhere."""
    scale = want[-1].float().pow(2).mean().sqrt().item()
    for g, w in zip(got[:-1], want[:-1]):
        _close_bwd(g, w, "bfloat16", scale)
        assert g.float().abs().max().item() <= 5e-5 * scale
    _close_bwd(got[-1], want[-1], "bfloat16")


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
@pytest.mark.parametrize("s,d", [
    (1, 64), (128, 64), (1001, 128), (2048, 128),
    # below one 64-row tile, just past one 128-key block, ragged
    (1, 128), (17, 64), (17, 128), (63, 128), (129, 64), (129, 128), (1001, 64),
])
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
    for g in got:
        assert g.dtype == dt and torch.isfinite(g).all()
    if fused and dtype == "bfloat16" and s == 1:
        _close_bwd_one_key(got, want)
    elif dtype == "bfloat16" and s == 1:
        # The compact dq runs on the CUDA cores, dk/dv on the tensor cores.
        _close_bwd(got[0], want[0], dtype)
        _close_bwd_one_key(got[1:], want[1:])
    else:
        for g, w in zip(got, want):
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


# The bf16 dk/dv (rectangular and compact) and fused backward run on the
# tensor cores (csrc/flash_bwd_dkv.cu, flash_bwd_tc: 128-key blocks, 64-row
# q tiles), and so does the bf16 rectangular dq (csrc/flash_bwd_dq.cu,
# flash_bwd_dq_tc: 128-row blocks, 64-key tiles); ragged edges are masked
# in the kernels.
TC_EDGES = [(1, 1), (17, 63), (63, 17), (129, 129), (129, 1001), (1001, 129)]
# The compact kernels' lengths: every length of TC_EDGES, as S_q = S_k.
TC_LENGTHS = sorted({n for edge in TC_EDGES for n in edge})


def _bwd_inputs(cuda, bh, sq, sk, d, dtype, seed, causal, sharp=False):
    q, k, v, do = _rect(cuda, bh, sq, sk, d, dtype, seed)
    if sharp:  # logits x8, as in the forward's sharp-logits test
        q = (q.float() * 8).to(dtype)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    return q, k, v, do, lse, flash.flash_delta(o, do)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("sq,sk", TC_EDGES, ids=[f"{a}x{b}" for a, b in TC_EDGES])
def test_bf16_dkv_rect_at_sub_tile_and_ragged_lengths(cuda, sq, sk, causal, d):
    """The rectangular dk/dv kernel below one 64-row tile and one 128-key
    block, just past them, and ragged, causal with s_q > s_k and
    s_q < s_k, against the plain two-pass backward."""
    args = _bwd_inputs(cuda, 3, sq, sk, d, torch.bfloat16, sq * 5 + sk, causal)
    before = _kernels.launches["flash_bwd_dkv_rect"]
    dk, dv = flash._flash_bwd_dkv_rect_cuda(*args, causal)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dkv_rect"] == before + 1
    want = flash.flash_bwd_reference(*args, causal=causal)[1:]
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    if sk == 1 or (causal and sq == 1):
        _close_bwd_one_key((dk, dv), want)
    else:
        for g, w in zip((dk, dv), want):
            _close_bwd(g, w, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sq,sk,d", [
    ("rect", 1001, 777, 128), ("rect-causal", 513, 1500, 64),
    ("rect-causal", 1500, 513, 128), ("fused", 1001, 1001, 128), ("fused", 2048, 2048, 64),
    ("dq-rect", 1001, 777, 128), ("dq-rect-causal", 513, 1500, 64),
    ("dq-rect-causal", 1500, 513, 128), ("dkv", 1001, 1001, 128), ("dkv", 2048, 2048, 64),
], ids=["rect", "rect-causal-sq<sk", "rect-causal-sq>sk", "fused", "fused-d64",
        "dq-rect", "dq-rect-causal-sq<sk", "dq-rect-causal-sq>sk", "dkv", "dkv-d64"])
def test_bf16_tensor_core_bwd_on_sharp_logits(cuda, kind, sq, sk, d):
    """q x 8: p is near 0 or 1 over most of a row and ds is spiky, which
    tests the split of p and ds into bf16 terms where a few large terms
    dominate a sum. "rect" kinds are the rectangular dk/dv, "dq-rect" the
    rectangular dq, "dkv" the compact dk/dv."""
    causal = kind not in ("rect", "dq-rect")
    args = _bwd_inputs(cuda, 4, sq, sk, d, torch.bfloat16, sq + 3 * sk, causal, sharp=True)
    if kind == "fused":
        got = flash.flash_bwd_kernels(*args, fused=True)
        want = flash.flash_bwd_fused_reference(*args)
    elif kind.startswith("dq-rect"):
        got = (flash._flash_bwd_dq_rect_cuda(*args, causal),)
        want = flash.flash_bwd_reference(*args, causal=causal)[:1]
    elif kind == "dkv":
        got = flash._flash_bwd_dkv_cuda(*args)
        want = flash.flash_bwd_reference(*args)[1:]
    else:
        got = flash._flash_bwd_dkv_rect_cuda(*args, causal)
        want = flash.flash_bwd_reference(*args, causal=causal)[1:]
    for g, w in zip(got, want):
        _close_bwd(g, w, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
def test_bf16_dkv_rect_is_bitwise_deterministic(cuda, causal):
    """dk and dv add in a fixed order (no atomics), so every run gives the
    same bits; the ring over NCCL reproduces the in-process ring's dk and
    dv exactly on that."""
    args = _bwd_inputs(cuda, 8, 1001, 2048, 128, torch.bfloat16, 21, causal)
    first = flash._flash_bwd_dkv_rect_cuda(*args, causal)
    for _ in range(3):
        again = flash._flash_bwd_dkv_rect_cuda(*args, causal)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(1001, 128), (2048, 64)])
def test_bf16_fused_matches_the_two_pass_kernels(cuda, s, d):
    """The tensor-core fused kernel against the two-pass kernels (the
    compact dq on the CUDA cores, the compact dk/dv on the tensor cores,
    both deterministic) on the same inputs: within one bf16 rounding of
    each other."""
    args = _bwd_inputs(cuda, 8, s, s, d, torch.bfloat16, s + 5, True)
    fused = flash.flash_bwd_kernels(*args, fused=True)
    two = flash.flash_bwd_kernels(*args, fused=False)
    for f, t in zip(fused, two):
        _close_bwd(f, t, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("sq,sk", TC_EDGES, ids=[f"{a}x{b}" for a, b in TC_EDGES])
def test_bf16_dq_rect_at_sub_tile_and_ragged_lengths(cuda, sq, sk, causal, d):
    """The tensor-core rectangular dq below one 64-key tile and one
    128-row block, just past them, and ragged, causal with s_q > s_k and
    s_q < s_k, against the plain two-pass backward. Where every row sees
    one key, dq is held to dv's scale (`_close_bwd_one_key`)."""
    args = _bwd_inputs(cuda, 3, sq, sk, d, torch.bfloat16, sq * 7 + sk, causal)
    before = _kernels.launches["flash_bwd_dq_rect"]
    dq = flash._flash_bwd_dq_rect_cuda(*args, causal)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dq_rect"] == before + 1
    want = flash.flash_bwd_reference(*args, causal=causal)
    assert dq.shape == args[0].shape and torch.isfinite(dq).all()
    if sk == 1 or (causal and sq == 1):
        _close_bwd_one_key((dq, want[2]), (want[0], want[2]))
    else:
        _close_bwd(dq, want[0], "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_bf16_dq_rect_sums_16384_keys(cuda, d):
    """The tensor-core rectangular dq where each row's sum runs over 16384
    keys (256 key tiles, each added to dq with float32 adds), against the
    plain version at the unchanged gate."""
    args = _bwd_inputs(cuda, 4, 256, 16384, d, torch.bfloat16, 16384 + d, False)
    dq = flash._flash_bwd_dq_rect_cuda(*args, False)
    _close_bwd(dq, flash.flash_bwd_reference(*args, causal=False)[0], "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", TC_LENGTHS)
def test_bf16_dkv_compact_at_sub_tile_and_ragged_lengths(cuda, s, d):
    """The compact (causal self-attention) dk/dv, now on the tensor cores,
    at every length of TC_EDGES, against the plain two-pass backward."""
    args = _bwd_inputs(cuda, 3, s, s, d, torch.bfloat16, s * 11 + d, True)
    before = _kernels.launches["flash_bwd_dkv"]
    dk, dv = flash._flash_bwd_dkv_cuda(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dkv"] == before + 1
    want = flash.flash_bwd_reference(*args)[1:]
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
    if s == 1:
        _close_bwd_one_key((dk, dv), want)
    else:
        for g, w in zip((dk, dv), want):
            _close_bwd(g, w, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dq-rect", "dq-rect-causal", "dkv"])
def test_bf16_dq_rect_and_dkv_compact_are_bitwise_deterministic(cuda, kernel):
    """The tensor-core rectangular dq and compact dk/dv add in a fixed
    order (no atomics), so every run gives the same bits: the two-pass
    backward stays the deterministic path."""
    if kernel == "dkv":
        args = _bwd_inputs(cuda, 8, 2048, 2048, 128, torch.bfloat16, 22, True)
        run = lambda: flash._flash_bwd_dkv_cuda(*args)
    else:
        causal = kernel == "dq-rect-causal"
        args = _bwd_inputs(cuda, 8, 1001, 2048, 128, torch.bfloat16, 23, causal)
        run = lambda: (flash._flash_bwd_dq_rect_cuda(*args, causal),)
    first = run()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(run(), first))


# One row past gridDim.y's 65535: every kernel folds (tile, BH) into
# gridDim.x, and ring flash folds its ring positions into BH.
BIG_BH = 65537


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("entry", [
    "flash_fwd", "flash_fwd_rect", "flash_delta", "flash_bwd_fused", "flash_bwd_dq",
    "flash_bwd_dkv", "flash_bwd_dq_rect", "flash_bwd_dkv_rect",
])
def test_every_kernel_takes_more_than_65535_rows(cuda, entry, dtype):
    """Each of the eight entry points at BH = 65537 (S = 64, D = 64)
    against its plain version on the same inputs, the rows past 65535
    included."""
    dt = getattr(torch, dtype)
    causal = entry in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")
    q, k, v, do = _rect(cuda, BIG_BH, 64, 64, 64, dt, seed=BIG_BH)
    o, lse = flash.flash_attention_reference(q, k, v, causal=causal)
    delta = flash.flash_delta_reference(o, do)
    args = (q, k, v, do, lse, delta)
    before = _kernels.launches[entry]
    if entry == "flash_fwd":
        _assert_fwd_close(*flash._flash_fwd_cuda(q, k, v), o, lse, dtype)
    elif entry == "flash_fwd_rect":
        _assert_fwd_close(*flash._flash_fwd_rect_cuda(q, k, v, False), o, lse, dtype)
    elif entry == "flash_delta":
        _close_bwd(flash._flash_delta_cuda(o, do), delta, "float32")
    else:
        got = {
            "flash_bwd_fused": lambda: flash._flash_bwd_fused_cuda(*args),
            "flash_bwd_dq": lambda: (flash._flash_bwd_dq_cuda(*args),),
            "flash_bwd_dkv": lambda: flash._flash_bwd_dkv_cuda(*args),
            "flash_bwd_dq_rect": lambda: (flash._flash_bwd_dq_rect_cuda(*args, False),),
            "flash_bwd_dkv_rect": lambda: flash._flash_bwd_dkv_rect_cuda(*args, False),
        }[entry]()
        plain = (flash.flash_bwd_fused_reference if entry == "flash_bwd_fused"
                 else flash.flash_bwd_reference)
        want = plain(*args, causal=causal)
        want = want[:1] if "_dq" in entry else want[1:] if "_dkv" in entry else want
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_bwd(g, w, dtype)
    torch.cuda.synchronize()
    assert _kernels.launches[entry] == before + 1


def _lm_step(cuda, impl, head_dim):
    """A 2-layer f32 LM's logits, loss and parameter gradients under
    `impl`, and the names of the flash kernels it launched."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=2,
                            head_dim=head_dim, d_ff=256, dtype=torch.float32,
                            remat=False, attention_impl=impl)
    model = TransformerLM(cfg, device=cuda, seed=0)
    tokens = torch.randint(0, 256, (2, 200), generator=torch.Generator().manual_seed(1))
    tokens = tokens.to(cuda)
    before = dict(_kernels.launches)
    logits = model(tokens)
    loss = softmax_cross_entropy(logits, tokens.roll(-1, dims=1))
    loss.backward()
    torch.cuda.synchronize()
    grew = {n for n, c in _kernels.launches.items() if c != before.get(n, 0)}
    return logits.detach(), loss.detach(), {n: p.grad for n, p in model.named_parameters()}, grew


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 256])
def test_lm_at_a_head_dim_the_kernels_lack_trains_on_dense_under_auto(cuda, head_dim):
    """On the card "auto" takes dense attention where the kernels do not
    take the head dim (`use_flash`), so the LM runs and trains there:
    forward, loss and every gradient equal to attention_impl="dense"
    (summation order aside), and no flash kernel launched. "flash" asks
    for the kernels and raises."""
    logits, loss, grads, grew = _lm_step(cuda, "auto", head_dim)
    d_logits, d_loss, d_grads, _ = _lm_step(cuda, "dense", head_dim)
    assert grew == set()
    torch.testing.assert_close(logits, d_logits, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(loss, d_loss, atol=1e-6, rtol=1e-5)
    assert grads.keys() == d_grads.keys()
    for name, g in grads.items():
        torch.testing.assert_close(g, d_grads[name], atol=1e-6, rtol=1e-5, msg=name)
    with pytest.raises(ValueError, match="head dim"):
        _lm_step(cuda, "flash", head_dim)


@pytest.mark.cuda
def test_lm_at_head_dim_128_takes_the_kernels_under_auto(cuda):
    """At a head dim the kernels take, "auto" launches them, forward and
    backward."""
    *_, grew = _lm_step(cuda, "auto", 128)
    assert grew == {"flash_fwd", "flash_delta", "flash_bwd_fused"}


@pytest.mark.cuda
def test_ring_at_a_head_dim_the_kernels_lack_takes_the_dense_ring(cuda):
    """On an sp ring on the card, "auto" takes the dense-hop ring where
    the kernels lack the head dim (`ring_flash_usable`), as it does on the
    CPU for chunks that do not tile."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig, _attend
    from kubeflow_tpu_torch.ops.attention import ring_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(sp=2))
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(1, 256, 2, 32, generator=gen).to(cuda) for _ in range(3))
    cfg = TransformerConfig(n_heads=2, head_dim=32, dtype=torch.float32,
                            attention_impl="auto")
    assert not flash.ring_flash_usable(q, 128)
    before = dict(_kernels.launches)
    with torch.no_grad():
        o = _attend(q, k, v, mesh, cfg)
    assert _kernels.launches == before
    torch.testing.assert_close(o, ring_attention(q, k, v, mesh, causal=True))
