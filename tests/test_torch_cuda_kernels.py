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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s,d", [(1, 64), (128, 64), (1001, 128), (2048, 128)])
def test_flash_fwd_matches_plain_version(cuda, dtype, s, d):
    q, k, v = _qkv(cuda, 8, s, d, getattr(torch, dtype), seed=s)
    o, lse = flash.flash_fwd(q, k, v)
    ro, rlse = flash.flash_attention_reference(q, k, v)
    # f32: the reference gate; bf16: one bf16 rounding step (2^-7 relative).
    atol, rtol = (5e-5, 5e-5) if dtype == "float32" else (1e-5, 2.0 ** -7)
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, rlse, atol=5e-5, rtol=5e-5)


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
@pytest.mark.parametrize("case", ["noncausal", "cross", "head-dim-96"])
def test_kernel_refuses_what_it_does_not_cover(cuda, case):
    q, k, v = _qkv(cuda, 2, 64, 64, torch.bfloat16, seed=1)
    if case == "noncausal":
        with pytest.raises(NotImplementedError):
            flash.flash_fwd(q, k, v, causal=False)
    elif case == "cross":
        with pytest.raises(NotImplementedError):
            flash.flash_fwd(q, k[:, :32].contiguous(), v[:, :32].contiguous())
    else:
        q, k, v = _qkv(cuda, 2, 64, 96, torch.bfloat16, seed=1)
        with pytest.raises(ValueError):
            flash.flash_fwd(q, k, v)


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
