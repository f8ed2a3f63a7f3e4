"""The port's rectangular flash attention against the JAX package's.

Off the compact causal grid — non-causal attention, and causal attention
with s_q != s_k, whose mask is the TPU kernels' top-left one (q_pos >=
k_pos, no s_k - s_q offset) — JAX runs `_fwd_kernel`, `_dq_kernel` and
`_dkv_kernel` on the predicated rectangular grid. Here the port's
`flash_attention` runs its plain versions on the CPU, and JAX its Pallas
kernels in interpret mode, on the same numpy inputs, forward and
gradients. Tolerance: the reference's own f32 flash-vs-dense gate,
atol = rtol = 5e-5 (tests/test_flash_schedule.py:250-253). The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py); their dispatch is
checked here with the launches recorded instead of made.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import flash as jflash
from kubeflow_tpu_torch.ops import flash as tflash

TOL = dict(atol=5e-5, rtol=5e-5)
CASES = [  # causal, s_q, s_k
    (False, 128, 128),
    (True, 64, 192),
    (True, 192, 64),
    (False, 128, 201),  # s_k pads to 256 with the kv_len tail mask
    (True, 256, 201),
]
IDS = ["noncausal", "causal-sq<sk", "causal-sq>sk", "ragged-sk", "ragged-sk-causal"]


def _inputs(seed, sq, sk, d, b=1, h=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,sq,sk", CASES, ids=IDS)
def test_rect_flash_and_grads_match_jax(causal, sq, sk, d):
    q, k, v, do = _inputs(sq * 7 + sk + d, sq, sk, d)
    kw = dict(causal=causal, block_q=64, block_k=64)

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, interpret=True, **kw)
        return jnp.sum(o * jnp.asarray(do))

    jo, jlse = jflash.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True, return_lse=True, **kw
    )
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to, tlse = tflash.flash_attention(tq, tk, tv, return_lse=True, **kw)
    (to * torch.from_numpy(do)).sum().backward()
    assert to.shape == q.shape and tlse.shape == (1, 2, sq)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"d{name}", **TOL)


def test_causal_rect_mask_is_top_left():
    """Causal with s_q < s_k: row i sees keys 0..i (no offset), so keys
    past the last row get no weight and no gradient."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 64, 128, 64))
    k, v = k.requires_grad_(), v.requires_grad_()
    o = tflash.flash_attention(q, k, v, causal=True, block_q=64, block_k=64)
    (o * do).sum().backward()
    assert k.grad[:, 64:].abs().max() == 0 and v.grad[:, 64:].abs().max() == 0
    assert k.grad[:, :64].abs().max() > 0
    # Row 0 attends to key 0 alone.
    torch.testing.assert_close(o[:, 0], v[:, 0].detach(), atol=1e-6, rtol=0)


def test_fused_backward_refuses_the_rectangular_grid():
    q, k, v, do = (torch.from_numpy(x[0].transpose(1, 0, 2).copy())
                   for x in _inputs(5, 128, 128, 64))
    o, lse = tflash.flash_attention_reference(q, k, v, causal=False)
    delta = tflash.flash_delta(o, do)
    with pytest.raises(ValueError, match="compact causal grid"):
        tflash.flash_bwd_kernels(q, k, v, do, lse, delta, causal=False, fused=True)
    with pytest.raises(ValueError, match="compact causal grid"):
        tflash.flash_bwd_kernels(q, k[:, :64].contiguous(), v[:, :64].contiguous(),
                                 do, lse, delta, causal=True, fused=True)


def _record_launches(monkeypatch):
    """Route CPU tensors down the CUDA dispatch and record each launch's
    (library, entry, counter, trailing int args) instead of making it."""
    launched = []
    monkeypatch.setattr(tflash, "_on_cpu", lambda x: False)
    monkeypatch.setattr(
        tflash, "_launch",
        lambda lib, entry, counter, device, *args: launched.append(
            (lib, entry, counter, args[-6:])),
    )
    return launched


@pytest.mark.parametrize("fused_env", ["1", "0"])
def test_cuda_dispatch_takes_the_rect_kernels_off_the_compact_case(
    monkeypatch, fused_env
):
    monkeypatch.setenv("KFTPU_FLASH_FUSED_BWD", fused_env)
    launched = _record_launches(monkeypatch)
    q = torch.zeros(4, 96, 64, dtype=torch.bfloat16)
    k = torch.zeros(4, 160, 64, dtype=torch.bfloat16)
    lse, delta = torch.zeros(4, 96), torch.zeros(4, 96)
    counters = lambda: [c for _, _, c, _ in launched]

    tflash.flash_fwd(q, q, q)
    tflash.flash_fwd(q, q, q, causal=False)
    tflash.flash_fwd(q, k, k)
    assert counters() == ["flash_fwd", "flash_fwd_rect", "flash_fwd_rect"]
    # (bh, s_q, s_k, d, causal, dtype) of the two rectangular launches.
    assert [a for *_, a in launched[1:]] == [(4, 96, 96, 64, 0, 1), (4, 96, 160, 64, 1, 1)]

    launched.clear()
    tflash.flash_bwd_kernels(q, q, q, q, lse, delta)
    self_attn = ["flash_bwd_fused"] if fused_env == "1" else ["flash_bwd_dq", "flash_bwd_dkv"]
    assert counters() == self_attn
    launched.clear()
    tflash.flash_bwd_kernels(q, q, q, q, lse, delta, causal=False)
    tflash.flash_bwd_kernels(q, k, k, q, lse, delta, causal=True)
    assert counters() == ["flash_bwd_dq_rect", "flash_bwd_dkv_rect"] * 2
    with pytest.raises(ValueError, match="compact causal grid"):
        tflash.flash_bwd_kernels(q, k, k, q, lse, delta, fused=True)


@pytest.mark.parametrize(
    "case", ["q-do-mismatch", "k-v-mismatch", "batch-heads", "head-dim"]
)
def test_kernel_input_checks_take_rectangles_and_refuse_the_rest(case):
    q, do = torch.zeros(4, 96, 64), torch.zeros(4, 96, 64)
    k, v = torch.zeros(4, 160, 64), torch.zeros(4, 160, 64)
    names = ("q", "k", "v", "dO")
    tflash._check_kernel_inputs(q, k, v, do, names=names)
    if case == "q-do-mismatch":
        do = torch.zeros(4, 95, 64)
    elif case == "k-v-mismatch":
        v = torch.zeros(4, 161, 64)
    elif case == "batch-heads":
        k, v = torch.zeros(3, 160, 64), torch.zeros(3, 160, 64)
    else:
        k, v = torch.zeros(4, 160, 128), torch.zeros(4, 160, 128)
    with pytest.raises(ValueError):
        tflash._check_kernel_inputs(q, k, v, do, names=names)
