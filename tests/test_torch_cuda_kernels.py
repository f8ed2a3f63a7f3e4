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
