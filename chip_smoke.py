#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Phases, each printed as one
JSON line; any failure raises and the exit code is non-zero:

1. device: the card (nvidia-smi's name and power limit), torch and CUDA.
2. build: every kernel under kubeflow_tpu_torch/ops/csrc, built with
   nvcc for sm_90a (one nvcc per source, all at once, or found built),
   with ptxas's resource report (registers, spills, and the dynamic
   shared memory of every flash_fwd, flash_bwd_dq and flash_bwd_dkv
   instantiation).
3. kernel: flash_fwd against its plain PyTorch version on the card, in
   bf16 and f32, at small, ragged and serving shapes, with the stated
   tolerance; then its time beside the plain version's, one PyTorch
   library call's and the card's bound.
4. bwd_kernel: the backward kernels (flash_delta, flash_bwd_fused,
   flash_bwd_dq, flash_bwd_dkv) against their plain versions at small,
   ragged, training and long shapes in bf16 and f32; then every
   kernel's time at the training shape (B=8, S=2048, H=8, D=128, bf16).
5. rect_kernel: the rectangular kernels (flash_fwd_rect,
   flash_bwd_dq_rect, flash_bwd_dkv_rect) against their plain versions
   in bf16 and f32 at (1, 128x128, 2, 64) non-causal, ragged
   (2, 1001 q x 777 k, 4, 128) causal and not, a long key side
   (1, 1024 q x 16384 k, 8, 128) non-causal, and one full ring hop
   (1, 4096x4096, 8, 128) non-causal; then rect_kernel_timing: their
   times at the hop shape beside the plain versions', SDPA's
   (is_causal=False) and the bound.
6. serve, main path 1: the full-width TransformerLM (vocab 32000,
   d_model 1024, 16 layers, 8x128 heads, d_ff 4096, bf16; random
   weights from seed 0) behind Servable -> ModelRepository ->
   ModelServerApp -> HTTP, three :predict requests (JSON and binary
   frame, S=2048 and S=1001). The launch counters are zeroed just
   before the requests and read just after: 16 flash launches per
   forward.
7. check: the served answers against the same module run directly with
   attention through the plain version (bf16, and the same weights in
   f32), with the tolerances stated in `check_phase`.
8. forward: forward time per request shape, the 4 x 2048 bucket with
   the kernel and with the plain version, and a profile of its device
   time by kernel.
9. train, main path 2: the same LM trained as `bench.py --workload lm`
   trains it (remat "none", adamw lr 3e-4, loss-only metrics) on
   SyntheticTokens, batch 8 at S=2048: 2 warm-up steps, then timed
   steps with the launch counters zeroed just before and read just
   after (16 flash_fwd + 16 flash_delta + 16 flash_bwd_fused a step),
   one more step with the two-pass backward pinned
   (KFTPU_FLASH_FUSED_BWD=0: 16 flash_bwd_dq + 16 flash_bwd_dkv), step
   time, tokens/s, MFU and profiles of one step and of one two-pass
   step.
10. train_check: one step's loss and every parameter's gradient on the
   kernel path against the same step with attention through the plain
   versions, in bf16 and in f32, with the tolerances stated in
   `train_check_phase`.
11. ring_train, main path 3: the same LM with sequence parallelism, its
   attention on ring flash over an in-process sp ring of 4 on the card,
   batch 1 at S=16384 (chunks of 4096), adamw lr 3e-4: one warm-up
   step, then timed steps with the counters zeroed just before and read
   just after (a step: 16 flash_fwd + 48 flash_fwd_rect + 16
   flash_delta + 16 flash_bwd_fused + 48 flash_bwd_dq_rect + 48
   flash_bwd_dkv_rect), step time, tokens/s, MFU, a profile of one
   step, and the flat LM's step at the same S beside it.
12. ring_check: one ring step's loss and gradients against the flat
   LM's in f32, and against the same ring on the plain versions in
   bf16, with the tolerances stated in `ring_check_phase`.
13. ring_nccl: with two or more cards, the ring over an NCCL process
   group against the in-process ring; with one card it prints
   {"run": false} and counts as nothing.
14. kernels: one line per ported kernel (launches, error, times, bound).
15. the last line: {"ok": true, "device": {...}}.

Without a GPU, or outside a checkout (copied alone, where
`kubeflow_tpu_torch` does not import), it says why on stderr and exits
non-zero before printing any result.

    python3 chip_smoke.py --loss-seeds N

runs only the device and build phases, then train_check and ring_check
for the seeds 0..N-1 of weights and tokens without failing on them, and
prints each seed's bf16 loss statistics: the readings `LOSS_Z` is set
from.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

SEED = 0
DEVICE = "cuda"
KERNEL_SHAPES = [  # (B, S, H, D)
    (1, 128, 2, 64),
    (2, 1000, 4, 128),  # tiles into 8-row blocks without padding
    (2, 1001, 4, 128),  # ragged: the plain version pads to 1024
    (4, 2048, 8, 128),  # the serving shape
]
MAIN_SHAPE = KERNEL_SHAPES[-1]
BWD_SHAPES = [  # (B, S, H, D)
    (1, 128, 2, 64),
    (2, 1001, 4, 128),  # ragged: the plain versions pad to 1024
    (8, 2048, 8, 128),  # the training shape
    (1, 16384, 8, 128),  # long context
]
TRAIN_SHAPE = BWD_SHAPES[2]
# Tolerances, as in numpy's allclose: |kernel - plain| <= atol + rtol*|plain|.
# f32: the reference's own flash-vs-dense gate (tests/test_flash_schedule.py,
# atol = rtol = 5e-5); kernel and plain version sum in other orders.
# bf16 outputs: both round one float32 result to bf16, so where the two f32
# results straddle a rounding boundary they differ by one bf16 ulp, at most
# 2^-7 of the value. The lse is float32 in both dtypes.
TOL = {
    "float32": {"o": (5e-5, 5e-5), "lse": (5e-5, 5e-5)},
    "bfloat16": {"o": (1e-5, 2.0 ** -7), "lse": (5e-5, 5e-5)},
}
# Backward kernels, as in tests/test_torch_cuda_kernels.py: gradients
# grow with S, so atol is JAX's 5e-5 grad gate relative to the plain
# result's RMS; rtol 5e-5 in f32 (sums in another order), 2^-7 on bf16
# outputs (one rounding of the same float32 value). delta is float32 in
# both dtypes.
BWD_RTOL = {"float32": 5e-5, "bfloat16": 2.0 ** -7}
BWD_ATOL_PER_RMS = 5e-5
LM = dict(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
          head_dim=128, d_ff=4096)
TRAIN = dict(batch=8, seq=2048, lr=3e-4, warmup_steps=2, timed_steps=5)
# Sequence parallelism: the same LM on an in-process sp ring of 4 at
# S = 16384 (chunks of 4096), batch 1: the 16384 tokens a step of TRAIN.
RING = dict(sp=4, batch=1, seq=16384, lr=3e-4, warmup_steps=1, timed_steps=3)
# The bf16 checks' mean-loss limit (`bf16_loss_ok`), in standard errors of
# the per-token loss differences. Set from the readings of
# `chip_smoke.py --loss-seeds 8` over 8 seeds of weights and tokens
# (PERF.md, section 6).
LOSS_Z = 5.0
RECT_SHAPES = [  # (B, S_q, S_k, H, D, causal)
    (1, 128, 128, 2, 64, False),
    (2, 1001, 777, 4, 128, False),  # ragged: the plain versions pad
    (2, 1001, 777, 4, 128, True),  # top-left causal mask, s_q > s_k
    (1, 1024, 16384, 8, 128, False),  # dq sums over 16384 keys
    (1, 4096, 4096, 8, 128, False),  # one full hop of RING
]
HOP_SHAPE = RECT_SHAPES[-1]
KERNEL_ROWS = {  # name → (CUDA source, the TPU kernel it replaces)
    "flash_fwd": ("flash_fwd.cu", "kubeflow_tpu/ops/flash.py:533 (_fwd_kernel_compact)"),
    "flash_fwd_rect": ("flash_fwd.cu", "kubeflow_tpu/ops/flash.py:515 (_fwd_kernel)"),
    "flash_delta": ("flash_delta.cu", "kubeflow_tpu/ops/flash.py:549 (_delta_kernel)"),
    "flash_bwd_fused": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:714 (_dqkv_kernel_fused)"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "kubeflow_tpu/ops/flash.py:618 (_dq_kernel_compact)"),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:696 (_dkv_kernel_compact)"),
    "flash_bwd_dq_rect": ("flash_bwd_dq.cu", "kubeflow_tpu/ops/flash.py:602 (_dq_kernel)"),
    "flash_bwd_dkv_rect": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:679 (_dkv_kernel)"),
}
RECT_KERNELS = ("flash_fwd_rect", "flash_bwd_dq_rect", "flash_bwd_dkv_rect")
REQUESTS = [  # (wire format, batch, sequence length)
    ("json", 1, 2048),
    ("json", 3, 2048),  # padded to bucket 4
    ("binary", 2, 1001),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(a, b, atol: float, rtol: float) -> bool:
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def device_phase(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "capability": list(torch.cuda.get_device_capability(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


def ptxas_report(log: str, smem=None) -> list[str]:
    """One line per compiled kernel: its (mangled) name, registers, static
    shared memory and spills, from nvcc -Xptxas -v, and any ptxas warning
    (a serialised wgmma pipeline shows there). `smem(name)` adds the
    kernel's dynamic shared memory where it gives one."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            dynamic = smem(name) if smem else None
            extra = f"; {dynamic} bytes dynamic smem" if dynamic else ""
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}{extra}")
            name = None
        elif "warning" in line.lower():
            out.append(line.strip())
    return out


def kernel_smem(name: str):
    """The dynamic shared memory of a flash_fwd, flash_bwd_dq or
    flash_bwd_dkv instantiation (tensor-core bf16 body or CUDA-core body,
    read from its mangled template arguments), from the library itself."""
    import re

    from kubeflow_tpu_torch.ops import _kernels

    fwd = re.search(r"flash_fwd_(tc|simt)ILi(\d+)E", name)
    if fwd is not None:
        dtype = 1 if fwd.group(1) == "tc" else 0
        return _kernels.library("flash_fwd").kftpu_flash_fwd_smem_bytes(int(fwd.group(2)), dtype)
    dq = re.search(r"flash_bwd_dq_(tc|simt)I(?:(13__nv_bfloat16|f))?Li(\d+)E", name)
    if dq is not None:
        tensor_cores = dq.group(1) == "tc"
        dtype = 1 if tensor_cores or dq.group(2) != "f" else 0
        return _kernels.library("flash_bwd_dq").kftpu_flash_bwd_dq_smem_bytes(
            int(dq.group(3)), dtype, int(tensor_cores))
    bwd = _kernels.library("flash_bwd_dkv").kftpu_flash_bwd_dkv_smem_bytes
    tc = re.search(r"flash_bwd_tcILi(\d+)ELb[01]ELb[01]ELb([01])E", name)
    if tc is not None:
        return bwd(int(tc.group(1)), 1, 1, int(tc.group(2)))
    simt = re.search(r"flash_bwd_dkv_kernelIfLi(\d+)ELb[01]ELb[01]ELb([01])E", name)
    if simt is not None:
        return bwd(int(simt.group(1)), 0, 0, int(simt.group(2)))
    return None


def build_phase() -> None:
    from kubeflow_tpu_torch.ops import _kernels

    built = _kernels.build()
    emit({
        "phase": "build",
        "kernels": {
            name: {
                "cached": b["cached"],
                "seconds": round(b["seconds"], 3),
                "ptxas": ptxas_report(b["ptxas"], kernel_smem),
            }
            for name, b in built.items()
        },
    })


def kernel_phase(torch) -> dict:
    """flash_fwd vs flash_attention_reference on the card; returns the
    kernel's entry for the kernels line (launches filled in later)."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    failures, max_err = [], 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, s, h, d in KERNEL_SHAPES:
            q, k, v = (
                torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
                for _ in range(3)
            )
            o, lse = flash.flash_fwd(q, k, v)
            torch.cuda.synchronize()
            ro, rlse = flash.flash_attention_reference(q, k, v)
            o, ro = o.float(), ro.float()
            err_o = (o - ro).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            ok = (
                close(o, ro, *TOL[dname]["o"])
                and close(lse, rlse, *TOL[dname]["lse"])
                and bool(torch.isfinite(o).all())
            )
            if dtype == torch.bfloat16:
                max_err = max(max_err, err_o)
            emit({
                "phase": "kernel", "kernel": "flash_fwd", "dtype": dname,
                "shape_bshd": [b, s, h, d], "max_abs_err_o": err_o,
                "max_abs_err_lse": err_lse,
                "tol_o_atol_rtol": TOL[dname]["o"],
                "tol_lse_atol_rtol": TOL[dname]["lse"], "ok": ok,
            })
            if not ok:
                failures.append((dname, (b, s, h, d)))
    if failures:
        raise AssertionError(f"flash_fwd disagrees with its plain version: {failures}")

    b, s, h, d = MAIN_SHAPE
    q, k, v = (
        torch.randn(b * h, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
        for _ in range(3)
    )
    kernel_ms = cuda_ms(torch, lambda: flash.flash_fwd(q, k, v), iters=20)
    plain_ms = cuda_ms(
        torch, lambda: flash.flash_attention_reference(q, k, v), iters=3, warmup=1
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    library_ms = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), iters=20)
    # The work the function needs: q.k and p.v over the causal triangle,
    # q/k/v read once, o and the f32 lse written once.
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    nbytes = 4 * b * h * s * d * q.element_size() + b * h * s * 4
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "kubeflow_tpu/ops/flash.py:533 (_fwd_kernel_compact)",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
        "shape_bshd": list(MAIN_SHAPE),
        "dtype": "bfloat16",
        "achieved_tflops": flops / (kernel_ms * 1e-3) / 1e12,
        "bound_share": max(t_ops, t_bytes) / kernel_ms,
    }
    emit({"phase": "kernel_timing", **entry})
    return entry


def bwd_close(got, want, dtype: str):
    """(ok, max |got - want|, atol, rtol) under the BWD_* tolerances."""
    want = want.float()
    atol = BWD_ATOL_PER_RMS * want.pow(2).mean().sqrt().item()
    rtol = BWD_RTOL[dtype]
    err = (got.float() - want).abs().max().item()
    return close(got.float(), want, atol, rtol), err, atol, rtol


def bwd_kernel_phase(torch, card: str) -> dict:
    """The backward kernels against their plain versions on the card at
    BWD_SHAPES in bf16 and f32 (each on the same inputs: the kernel
    forward's o and lse, the kernel delta), then all five kernels' times
    at the training shape. Returns the entries of the kernels line."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    failures = []
    max_err = dict.fromkeys(KERNEL_ROWS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, s, h, d in BWD_SHAPES:
            q, k, v, do = (
                torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
                for _ in range(4)
            )
            o, lse = flash.flash_fwd(q, k, v)
            delta = flash.flash_delta(o, do)
            fused = flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=True)
            two = flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=False)
            torch.cuda.synchronize()
            checks = {"flash_delta": [bwd_close(delta, flash.flash_delta_reference(o, do), "float32")]}
            plain = flash.flash_bwd_fused_reference(q, k, v, do, lse, delta)
            checks["flash_bwd_fused"] = [bwd_close(g, w, dname) for g, w in zip(fused, plain)]
            plain = flash.flash_bwd_reference(q, k, v, do, lse, delta)
            checks["flash_bwd_dq"] = [bwd_close(two[0], plain[0], dname)]
            checks["flash_bwd_dkv"] = [bwd_close(g, w, dname) for g, w in zip(two[1:], plain[1:])]
            del plain
            for name, results in checks.items():
                ok = all(r[0] for r in results) and all(
                    bool(torch.isfinite(t).all()) for t in (delta, *fused, *two)
                )
                err = max(r[1] for r in results)
                if dtype == torch.bfloat16:
                    max_err[name] = max(max_err[name], err)
                emit({
                    "phase": "bwd_kernel", "kernel": name, "dtype": dname,
                    "shape_bshd": [b, s, h, d], "max_abs_err": err,
                    "tol_atol_rtol": [[r[2], r[3]] for r in results], "ok": ok,
                })
                if not ok:
                    failures.append((name, dname, (b, s, h, d)))
    if failures:
        raise AssertionError(f"backward kernels disagree with their plain versions: {failures}")

    # Times at the training shape, bf16.
    b, s, h, d = TRAIN_SHAPE
    bh, n = b * h, b * h * s * d
    q, k, v, do = (
        torch.randn(bh, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
        for _ in range(4)
    )
    o, lse = flash.flash_fwd(q, k, v)
    delta = flash.flash_delta(o, do)
    bwd = lambda fused: flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=fused)
    kernel_ms = {
        "flash_fwd": cuda_ms(torch, lambda: flash.flash_fwd(q, k, v), iters=10),
        "flash_delta": cuda_ms(torch, lambda: flash.flash_delta(o, do), iters=20),
        "flash_bwd_fused": cuda_ms(torch, lambda: bwd(True), iters=5),
    }
    kernel_ms["flash_bwd_dq"] = cuda_ms(
        torch, lambda: flash._flash_bwd_dq_cuda(q, k, v, do, lse, delta), iters=5)
    kernel_ms["flash_bwd_dkv"] = cuda_ms(
        torch, lambda: flash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta), iters=5)
    two_pass_ref = cuda_ms(torch, lambda: flash.flash_bwd_reference(
        q, k, v, do, lse, delta), iters=2, warmup=1)
    plain_ms = {
        "flash_fwd": cuda_ms(torch, lambda: flash.flash_attention_reference(q, k, v), iters=2, warmup=1),
        "flash_delta": cuda_ms(torch, lambda: flash.flash_delta_reference(o, do), iters=10),
        "flash_bwd_fused": cuda_ms(torch, lambda: flash.flash_bwd_fused_reference(
            q, k, v, do, lse, delta), iters=2, warmup=1),
        "flash_bwd_dq": two_pass_ref,
        "flash_bwd_dkv": two_pass_ref,
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, s, d).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, s, d)
    sdpa_fwd = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True), iters=20)
    sdpa_both = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=True).backward(do4), iters=20
    )
    sdpa_bwd = sdpa_both - sdpa_fwd
    library = {
        "flash_fwd": (sdpa_fwd, "scaled_dot_product_attention(is_causal=True), forward"),
        "flash_delta": (None, "no single PyTorch call computes delta alone; SDPA's "
                        "backward includes it (see flash_bwd_fused)"),
        **{name: (sdpa_bwd, "backward of scaled_dot_product_attention(is_causal=True), "
                  "timed as forward+backward minus forward; it covers delta plus "
                  "dq, dk and dv together") for name in
           ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")},
    }
    # The work each function needs at this shape: FLOP per causal pair per
    # head dim (q.k and p.v forward: 4; dq pass: 6; dk/dv pass: 8; fused:
    # 10), each input read once, each output written once.
    pairs = bh * d * (s * (s + 1) / 2)
    el = q.element_size()
    rows = bh * s * 4  # one float32 per row: lse or delta
    work = {
        "flash_fwd": (4 * pairs, 3 * n * el + n * el + rows),
        "flash_delta": (2.0 * n, 2 * n * el + rows),
        "flash_bwd_fused": (10 * pairs, 4 * n * el + 2 * rows + 3 * n * el),
        "flash_bwd_dq": (6 * pairs, 4 * n * el + 2 * rows + n * el),
        "flash_bwd_dkv": (8 * pairs, 4 * n * el + 2 * rows + 2 * n * el),
    }
    entries = {}
    for name, (src, replaces) in KERNEL_ROWS.items():
        if name in RECT_KERNELS:
            continue
        flops, nbytes = work[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib_ms, lib_note = library[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_err[name], "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library": lib_note,
            "shape_bshd": list(TRAIN_SHAPE), "dtype": "bfloat16",
            "achieved_tflops": flops / (kernel_ms[name] * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / kernel_ms[name],
            "over_library": kernel_ms[name] / lib_ms if lib_ms else None,
            "card": card,
        }
        emit({"phase": "bwd_kernel_timing", **entries[name]})
    return entries


def unmasked_pairs(causal: bool, sq: int, sk: int) -> int:
    """(query, key) pairs the rectangular grid computes: all of them, or
    those with q_pos >= k_pos (the top-left causal mask)."""
    if not causal:
        return sq * sk
    full = max(0, sq - sk)  # rows that see every key
    diag = min(sq, sk)  # rows 0..diag-1 see keys 0..row
    return diag * (diag + 1) // 2 + full * sk


def rect_kernel_phase(torch, card: str) -> dict:
    """The rectangular kernels (flash_fwd_rect, flash_bwd_dq_rect,
    flash_bwd_dkv_rect) against their plain versions at RECT_SHAPES in
    bf16 and f32, each on the same inputs (the kernel forward's o and
    lse, the kernel delta), with the forward's and the backward's
    tolerances; then, at the hop shape, their times beside the plain
    versions', SDPA's (is_causal=False) and the bound. Returns the
    entries of the kernels line."""
    from kubeflow_tpu_torch.ops import flash

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    failures, max_err = [], dict.fromkeys(RECT_KERNELS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for b, sq, sk, h, d, causal in RECT_SHAPES:
            draw = lambda s: torch.randn(b * h, s, d, generator=gen, device=DEVICE).to(dtype)
            q, k, v, do = draw(sq), draw(sk), draw(sk), draw(sq)
            o, lse = flash.flash_fwd(q, k, v, causal=causal)
            delta = flash.flash_delta(o, do)
            dq, dk, dv = flash.flash_bwd_kernels(q, k, v, do, lse, delta, causal=causal)
            torch.cuda.synchronize()
            ro, rlse = flash.flash_attention_reference(q, k, v, causal=causal)
            plain = flash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal)
            checks = {
                "flash_fwd_rect": [
                    (close(o.float(), ro.float(), *TOL[dname]["o"]),
                     (o.float() - ro.float()).abs().max().item(), *TOL[dname]["o"]),
                    (close(lse, rlse, *TOL[dname]["lse"]),
                     (lse - rlse).abs().max().item(), *TOL[dname]["lse"]),
                ],
                "flash_bwd_dq_rect": [bwd_close(dq, plain[0], dname)],
                "flash_bwd_dkv_rect": [bwd_close(g, w, dname) for g, w in zip((dk, dv), plain[1:])],
            }
            finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
            for name, results in checks.items():
                ok = finite and all(r[0] for r in results)
                err = max(r[1] for r in results)
                if dtype == torch.bfloat16:
                    max_err[name] = max(max_err[name], err)
                emit({
                    "phase": "rect_kernel", "kernel": name, "dtype": dname,
                    "shape_b_sq_sk_h_d": [b, sq, sk, h, d], "causal": causal,
                    "max_abs_err": err,
                    "tol_atol_rtol": [[r[2], r[3]] for r in results], "ok": ok,
                })
                if not ok:
                    failures.append((name, dname, (b, sq, sk, h, d, causal)))
            del plain, ro
    if failures:
        raise AssertionError(f"rectangular kernels disagree with their plain versions: {failures}")

    # Times at the hop shape, bf16.
    b, sq, sk, h, d, causal = HOP_SHAPE
    bh = b * h
    draw = lambda s: torch.randn(bh, s, d, generator=gen, device=DEVICE, dtype=torch.bfloat16)
    q, k, v, do = draw(sq), draw(sk), draw(sk), draw(sq)
    o, lse = flash.flash_fwd(q, k, v, causal=causal)
    delta = flash.flash_delta(o, do)
    kernel_ms = {
        "flash_fwd_rect": cuda_ms(torch, lambda: flash.flash_fwd(q, k, v, causal=causal), iters=10),
        "flash_bwd_dq_rect": cuda_ms(torch, lambda: flash._flash_bwd_dq_rect_cuda(
            q, k, v, do, lse, delta, causal), iters=5),
        "flash_bwd_dkv_rect": cuda_ms(torch, lambda: flash._flash_bwd_dkv_rect_cuda(
            q, k, v, do, lse, delta, causal), iters=5),
    }
    two_pass_ref = cuda_ms(torch, lambda: flash.flash_bwd_reference(
        q, k, v, do, lse, delta, causal=causal), iters=2, warmup=1)
    plain_ms = {
        "flash_fwd_rect": cuda_ms(torch, lambda: flash.flash_attention_reference(
            q, k, v, causal=causal), iters=2, warmup=1),
        "flash_bwd_dq_rect": two_pass_ref,
        "flash_bwd_dkv_rect": two_pass_ref,
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = (x.view(b, h, -1, d).detach().requires_grad_() for x in (q, k, v))
    do4 = do.view(b, h, sq, d)
    sdpa_fwd = cuda_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=causal), iters=20)
    sdpa_bwd = cuda_ms(
        torch, lambda: sdpa(q4, k4, v4, is_causal=causal).backward(do4), iters=20
    ) - sdpa_fwd
    bwd_note = ("backward of scaled_dot_product_attention(is_causal=False), timed as "
                "forward+backward minus forward; it covers delta plus dq, dk and dv together")
    library = {
        "flash_fwd_rect": (sdpa_fwd, "scaled_dot_product_attention(is_causal=False), forward"),
        "flash_bwd_dq_rect": (sdpa_bwd, bwd_note),
        "flash_bwd_dkv_rect": (sdpa_bwd, bwd_note),
    }
    # The work each function needs: FLOP per unmasked pair per head dim
    # (forward 4, dq 6, dk/dv 8); each input read once, each output
    # written once.
    pairs = bh * d * unmasked_pairs(causal, sq, sk)
    el = q.element_size()
    nq, nk, rows = bh * sq * d * el, bh * sk * d * el, bh * sq * 4
    work = {
        "flash_fwd_rect": (4 * pairs, 2 * nq + 2 * nk + rows),
        "flash_bwd_dq_rect": (6 * pairs, 3 * nq + 2 * nk + 2 * rows),
        "flash_bwd_dkv_rect": (8 * pairs, 2 * nq + 4 * nk + 2 * rows),
    }
    entries = {}
    for name in RECT_KERNELS:
        src, replaces = KERNEL_ROWS[name]
        flops, nbytes = work[name]
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        lib_ms, lib_note = library[name]
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"kubeflow_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_err[name], "ms": kernel_ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "library": lib_note,
            "shape_b_sq_sk_h_d": [b, sq, sk, h, d], "causal": causal,
            "dtype": "bfloat16",
            "achieved_tflops": flops / (kernel_ms[name] * 1e-3) / 1e12,
            "bound_share": max(t_ops, t_bytes) / kernel_ms[name],
            "over_library": kernel_ms[name] / lib_ms if lib_ms else None,
            "card": card,
        }
        emit({"phase": "rect_kernel_timing", **entries[name]})
    return entries


def last_logits(model, tokens):
    """The servable's function: next-token logits [n, V] (f32) at the
    last position."""
    from kubeflow_tpu_torch.models.transformer import lm_head

    h = model.features(tokens)[:, -1:]
    return lm_head(h, model.embedding, dtype=model.config.dtype)[:, 0]


def dense_attend(q, k, v, *, causal=True, **_):
    from kubeflow_tpu_torch.ops.attention import dense_attention

    return dense_attention(q, k, v, causal=causal)


@contextlib.contextmanager
def plain_kernels():
    """flash_fwd, flash_delta and flash_bwd_kernels through their plain
    versions on CUDA tensors meanwhile (the port itself never takes them
    for a CUDA tensor): the flat and the ring paths alike."""
    from kubeflow_tpu_torch.ops import flash

    def fwd(q, k, v, *, causal=True, block_q=1024, block_k=1024):
        return flash.flash_attention_reference(q, k, v, causal=causal,
                                               block_q=block_q, block_k=block_k)

    def bwd(q, k, v, do, lse, delta, *, causal=True, block_q=1024, block_k=1024,
            fused=None):
        del fused  # the plain fused and two-pass versions are bit-identical
        return flash.flash_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                         block_q=block_q, block_k=block_k)

    saved = (flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels)
    flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels = (
        fwd, flash.flash_delta_reference, bwd)
    try:
        yield
    finally:
        flash.flash_fwd, flash.flash_delta, flash.flash_bwd_kernels = saved


@contextlib.contextmanager
def attention_via(attend):
    """Route the model's flash attention through `attend` meanwhile."""
    from kubeflow_tpu_torch.models import transformer

    original = transformer.flash_attention
    transformer.flash_attention = attend
    try:
        yield
    finally:
        transformer.flash_attention = original


def post(url: str, body: bytes, content_type: str, accept: str):
    req = urllib.request.Request(
        url, data=body, method="POST",
        headers={"Content-Type": content_type, "Accept": accept},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def serve_phase(torch):
    """The main path: three :predict requests over HTTP at full width.
    Returns (servable, the request batches, the predictions, the result)."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.serving import ModelRepository, ModelServerApp, Servable
    from kubeflow_tpu_torch.serving import wire
    from kubeflow_tpu_torch.web import serve

    cfg = TransformerConfig(**LM, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    servable = Servable("lm", last_logits, model, max_batch=4, device=DEVICE)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    servable.warmup_with(rng.integers(0, cfg.vocab_size, 2048))
    warmup_s = time.perf_counter() - t0

    batches = [rng.integers(0, cfg.vocab_size, (n, s)) for _, n, s in REQUESTS]
    server, thread = serve(
        ModelServerApp(ModelRepository([servable])), host="127.0.0.1", port=0
    )
    url = f"http://127.0.0.1:{server.server_port}/v1/models/lm:predict"
    served, rows = [], []
    try:
        _kernels.launches.clear()
        for (fmt, n, s), tokens in zip(REQUESTS, batches):
            t0 = time.perf_counter()
            if fmt == "json":
                body = json.dumps({"instances": tokens.tolist()}).encode()
                status, ctype, raw = post(url, body, "application/json",
                                          "application/json")
                pred = np.asarray(json.loads(raw)["predictions"], np.float32)
            else:
                status, ctype, raw = post(
                    url, wire.encode_tensor(tokens.astype(np.int32)),
                    wire.TENSOR_CONTENT_TYPE, wire.TENSOR_CONTENT_TYPE,
                )
                pred = wire.decode_tensor(raw)
            latency = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"{fmt} predict answered {status}: {raw[:500]!r}")
            if pred.shape != (n, cfg.vocab_size) or not np.isfinite(pred).all():
                raise AssertionError(f"bad prediction: shape {pred.shape}")
            served.append(pred)
            rows.append({"format": fmt, "batch": n, "seq": s,
                         "status": status, "latency_s": latency,
                         "tokens_per_s": n * s / latency})
        launches = dict(_kernels.launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)

    forwards = len(REQUESTS)  # each request fits one bucket: one forward
    want = cfg.n_layers * forwards
    if launches.get("flash_fwd", 0) != want:
        raise AssertionError(
            f"flash_fwd launched {launches.get('flash_fwd', 0)} times over "
            f"{forwards} forwards; expected {want}"
        )
    result = {
        "phase": "serve", "model": {**LM, "dtype": "bfloat16"},
        "model_init_s": init_s, "warmup_s": warmup_s, "requests": rows,
        "launches": launches, "forwards": forwards,
    }
    emit(result)
    return servable, batches, served, result


def check_phase(torch, servable, batches, served) -> None:
    """The served answers against the same module run directly with
    attention through the plain version.

    bf16: the kernel and the plain version round differently (one bf16
    ulp in an attention output, now and then), and 16 bf16 layers carry
    that on, so the bound is a second bf16 path's own distance: the
    served logits must lie within twice the plain path's distance from
    the dense path (dense_attention rounds p to bf16 before PV), as the
    CPU tests hold the port against JAX. f32: the same weights in f32,
    kernel path vs plain path at full width, atol = rtol = 1e-4 (the
    kernel's 5e-5 gate, carried through 16 layers)."""
    import dataclasses

    from kubeflow_tpu_torch.models import TransformerLM

    model = servable.variables
    rows, ok = [], True
    with torch.inference_mode():
        for (fmt, n, s), tokens, pred in zip(REQUESTS, batches, served):
            t = torch.tensor(tokens, device=DEVICE)
            with plain_kernels():
                plain = last_logits(model, t).cpu().numpy()
            with attention_via(dense_attend):
                dense = last_logits(model, t).cpu().numpy()
            err = float(np.abs(pred - plain).max())
            gap = float(np.abs(plain - dense).max())
            ok &= err <= 2 * gap
            rows.append({"dtype": "bfloat16", "batch": n, "seq": s,
                         "max_abs_err_vs_plain_path": err,
                         "plain_vs_dense_gap": gap, "tol": 2 * gap})
        model32 = TransformerLM(
            dataclasses.replace(model.config, dtype=torch.float32),
            device=DEVICE, seed=SEED,
        )
        for tokens in (batches[0], batches[2]):
            t = torch.tensor(tokens, device=DEVICE)
            kernel = last_logits(model32, t)
            with plain_kernels():
                plain = last_logits(model32, t)
            err = float((kernel - plain).abs().max())
            ok &= close(kernel, plain, 1e-4, 1e-4)
            rows.append({"dtype": "float32", "batch": tokens.shape[0],
                         "seq": tokens.shape[1],
                         "max_abs_err_vs_plain_path": err,
                         "tol_atol_rtol": [1e-4, 1e-4]})
        del model32
    emit({"phase": "check", "rows": rows, "ok": ok,
          "logit_std": float(np.std(served[0]))})
    if not ok:
        raise AssertionError(f"served logits off the plain path: {rows}")


def profile_device(torch, fn) -> dict:
    """Device time by kernel group over one call of fn (torch.profiler),
    after one call to warm up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    # matmul_f32: float32 products on the CUDA cores — the tied head's
    # f32 logits (`lm_head`) and their gradients.
    groups = {"flash_fwd": 0.0, "flash_bwd": 0.0, "matmul": 0.0,
              "matmul_f32": 0.0, "optimizer": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_fwd"] += ms
        elif any(t in low for t in ("flash_delta", "flash_bwd", "flash_dq")):
            groups["flash_bwd"] += ms
        elif "sgemm" in low or "f32f32" in low:
            groups["matmul_f32"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            groups["matmul"] += ms
        elif "multi_tensor" in low or "foreach" in low:
            groups["optimizer"] += ms
        else:
            groups["other"] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / wall_ms),
        "device_ms_by_group": groups,
        "top_kernels_ms": [[name[:90], ms] for name, ms in top],
    }


def timing_phase(torch, servable, batches) -> None:
    """Forward time per request shape (servable.predict, synchronous),
    the 4 x 2048 bucket with the kernel and with the plain version, and
    where that forward's device time goes."""

    def forward_s(batch, reps: int) -> float:
        servable.predict(batch)
        t0 = time.perf_counter()
        for _ in range(reps):
            servable.predict(batch)
        return (time.perf_counter() - t0) / reps

    per_request = [
        {"batch": n, "seq": s, "forward_s": forward_s(tokens, 3)}
        for (_, n, s), tokens in zip(REQUESTS, batches)
    ]
    full = batches[1][:1].repeat(4, axis=0)
    kernel_s = forward_s(full, 5)
    with plain_kernels():
        plain_s = forward_s(full, 2)
    emit({
        "phase": "forward", "per_request": per_request,
        "forward_4x2048_s": kernel_s,
        "forward_tokens_per_s": 4 * 2048 / kernel_s,
        "plain_path_forward_4x2048_s": plain_s,
        "profile_4x2048": profile_device(torch, lambda: servable.predict(full)),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    })


def flops_per_token(seq: int) -> float:
    """bench.py:3627-3643: 6 FLOP per matmul parameter per token (the
    tied head counted once) plus 6·S·d_attn per layer for causal
    attention; remat recompute is not counted."""
    d_attn = LM["n_heads"] * LM["head_dim"]
    layer_params = LM["n_layers"] * (
        4 * LM["d_model"] * d_attn + 3 * LM["d_model"] * LM["d_ff"]
    )
    head_params = LM["vocab_size"] * LM["d_model"]
    return 6 * (layer_params + head_params) + 6 * LM["n_layers"] * seq * d_attn


def train_model(torch, dtype, seed: int = SEED):
    """The bench's LM (remat "none", bf16 or f32 compute over f32
    params), random weights from `seed`, and its adamw trainer."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    cfg = TransformerConfig(**LM, dtype=dtype, remat_policy="none")
    config = TrainConfig(
        batch_size=TRAIN["batch"], learning_rate=TRAIN["lr"],
        total_steps=10_000, optimizer="adamw", label_smoothing=0.0,
        fsdp_params=False, train_metrics="loss",
    )
    model = TransformerLM(cfg, device=DEVICE, seed=seed)
    return Trainer(model, config, input_key="tokens", label_key="labels",
                   device=DEVICE)


@contextlib.contextmanager
def two_pass_backward():
    """KFTPU_FLASH_FUSED_BWD=0 meanwhile (read at every backward)."""
    old = os.environ.get("KFTPU_FLASH_FUSED_BWD")
    os.environ["KFTPU_FLASH_FUSED_BWD"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["KFTPU_FLASH_FUSED_BWD"]
        else:
            os.environ["KFTPU_FLASH_FUSED_BWD"] = old


def train_phase(torch, card: str) -> dict:
    """Main path 2: the bench's train step at full width on one card.
    Returns the launch counts of the timed steps and of the two-pass
    step."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import SyntheticTokens

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train_model(torch, torch.bfloat16)
    state = trainer.init_state()
    data = iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                seed=SEED, device=DEVICE))
    step = trainer.make_train_step()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN["warmup_steps"]):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0

    n = TRAIN["timed_steps"]
    _kernels.launches.clear()
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    launches = dict(_kernels.launches)

    _kernels.launches.clear()
    with two_pass_backward():
        state, metrics = step(state, next(data))
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        two_pass = dict(_kernels.launches)
        two_pass_profile = profile_device(torch, lambda: step(state, next(data)))

    losses = [float(x) for x in losses]
    layers = LM["n_layers"]
    want = {"flash_fwd": layers * n, "flash_delta": layers * n,
            "flash_bwd_fused": layers * n}
    want_two = {"flash_fwd": layers, "flash_delta": layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    if launches != want or two_pass != want_two:
        raise AssertionError(
            f"train launches {launches} over {n} steps (want {want}); "
            f"two-pass step {two_pass} (want {want_two})"
        )
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    tokens = TRAIN["batch"] * TRAIN["seq"]
    tokens_per_s = tokens / step_s
    profile = profile_device(torch, lambda: step(state, next(data)))
    result = {
        "phase": "train", "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "batch": TRAIN["batch"], "seq": TRAIN["seq"], "optimizer": "adamw",
        "learning_rate": TRAIN["lr"], "init_s": init_s, "warmup_s": warmup_s,
        "timed_steps": n, "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "flops_per_token": flops_per_token(TRAIN["seq"]),
        "mfu": tokens_per_s * flops_per_token(TRAIN["seq"]) / PEAK_FLOPS["bfloat16"],
        "losses": losses,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "launches_two_pass_step": two_pass,
        "profile_one_step": profile,
        "profile_one_two_pass_step": two_pass_profile,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": card,
    }
    emit(result)
    del trainer, state, step
    torch.cuda.empty_cache()
    return {"train": launches, "train_two_pass": two_pass}


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def step_grads(torch, model, batch):
    """One forward and backward of the train step's loss, the port's
    `softmax_cross_entropy` as Trainer computes it: (loss, its [B, S]
    float32 per-token terms, {name: gradient}), with the parameters left
    as they were."""
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    model.zero_grad(set_to_none=True)
    logits = model(batch["tokens"])
    loss = softmax_cross_entropy(logits, batch["labels"])
    with torch.no_grad():
        logits = logits.float()
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, batch["labels"][..., None])[..., 0]
    del logits
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), nll, grads


def ratio(a: float, b: float) -> float:
    return abs(a) / max(abs(b), 1e-30)


def loss_gap(nll_a, nll_b) -> dict:
    """Two paths' per-token losses compared: the difference of their mean
    losses (summed in float64), its standard error (the spread of the
    per-token differences over the square root of the token count), the
    two as a z-score, and the per-token relative norm."""
    d = (nll_a - nll_b).double().flatten()
    mean, se = float(d.mean()), float(d.std() / d.numel() ** 0.5)
    return {"mean_diff": mean, "se": se, "z": mean / max(se, 1e-30),
            "token_rel": rel(nll_a, nll_b)}


def bf16_loss_ok(checked: dict, reference: dict) -> bool:
    """The bf16 loss limits of train_check and ring_check. The checked
    pair's per-token losses lie within twice the reference pair's
    relative norm, and its mean-loss difference within LOSS_Z of its own
    standard errors: a shift of the mean beyond its rounding noise."""
    return (checked["token_rel"] <= 2 * reference["token_rel"]
            and abs(checked["z"]) <= LOSS_Z)


def train_check_phase(torch, seed: int = SEED, strict: bool = True):
    """The kernel path's loss and gradients against the same step with
    attention through the plain versions, on the same weights and batch.

    bf16: kernel and plain versions round differently (one bf16 ulp in an
    attention output or gradient, now and then), and 16 bf16 layers carry
    that on, so the bound is a second bf16 path's own distance, as the
    forward check's: for every parameter's gradient (relative Frobenius
    norm), the kernel path must lie within twice the plain path's
    distance from the dense path; the loss is held by `bf16_loss_ok`,
    against the plain-vs-dense pair. f32: the same weights in f32, kernel
    path vs plain path, |loss difference| <= 1e-4·|loss| and every
    gradient within relative norm 1e-4: the kernels' 5e-5 gate, carried
    through 16 layers forward and back."""
    from kubeflow_tpu_torch.train import SyntheticTokens

    batch = next(iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                      seed=seed, device=DEVICE)))
    rows, ok = [], True

    def run():
        return step_grads(torch, trainer.model, batch)

    trainer = train_model(torch, torch.bfloat16, seed)
    loss_k, nll_k, g_k = run()
    with plain_kernels():
        loss_p, nll_p, g_p = run()
    with attention_via(dense_attend):
        loss_d, nll_d, g_d = run()
    kp, pd = loss_gap(nll_k, nll_p), loss_gap(nll_p, nll_d)
    ok &= bf16_loss_ok(kp, pd)
    worst = {"name": None, "ratio": 0.0}
    for name in g_k:
        err, gap = rel(g_k[name], g_p[name]), rel(g_p[name], g_d[name])
        ok &= err <= 2 * gap and bool(torch.isfinite(g_k[name]).all())
        if err / max(gap, 1e-30) > worst["ratio"]:
            worst = {"name": name, "ratio": err / max(gap, 1e-30),
                     "rel_err_vs_plain": err, "plain_vs_dense_rel_gap": gap}
    qkv = [n for n in g_k if n.endswith(("attn.wq", "attn.wk", "attn.wv"))]
    rows.append({
        "dtype": "bfloat16", "loss_kernel": float(loss_k),
        "loss_plain": float(loss_p), "loss_dense": float(loss_d),
        "loss_kernel_vs_plain": kp, "loss_plain_vs_dense": pd,
        "loss_tol": {"token_rel": 2 * pd["token_rel"], "abs_z": LOSS_Z},
        "mean_loss_ratio_kp_over_pd": ratio(kp["mean_diff"], pd["mean_diff"]),
        "params": len(g_k), "wq_wk_wv_with_grads": len(qkv),
        "max_rel_err_vs_plain": max(rel(g_k[n], g_p[n]) for n in g_k),
        "max_rel_err_param": max(g_k, key=lambda n: rel(g_k[n], g_p[n])),
        "worst_param_vs_its_tol": worst,
    })
    del trainer, g_k, g_p, g_d
    torch.cuda.empty_cache()

    trainer = train_model(torch, torch.float32, seed)
    loss_k, _, g_k = run()
    with plain_kernels():
        loss_p, _, g_p = run()
    loss_err = abs(float(loss_k - loss_p))
    ok &= loss_err <= 1e-4 * abs(float(loss_p))
    errs = {n: rel(g_k[n], g_p[n]) for n in g_k}
    ok &= max(errs.values()) <= 1e-4
    rows.append({
        "dtype": "float32", "loss_kernel": float(loss_k),
        "loss_plain": float(loss_p), "loss_err_vs_plain": loss_err,
        "loss_tol_rel": 1e-4, "max_rel_err_vs_plain": max(errs.values()),
        "worst_param": max(errs, key=errs.get), "grad_tol_rel": 1e-4,
    })
    del trainer, g_k, g_p
    torch.cuda.empty_cache()
    emit({"phase": "train_check", "seed": seed, "rows": rows, "ok": ok})
    if strict and not ok:
        raise AssertionError(f"train step off the plain path: {rows}")
    return ok, rows


def ring_model(torch, dtype, *, mesh=True, remat="none", seed: int = SEED):
    """The LM at full width on an in-process sp ring of RING["sp"] (or
    flat, mesh=False), random weights from `seed`: the same weights
    either way."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    cfg = TransformerConfig(**LM, dtype=dtype, remat=remat != "none",
                            remat_policy=remat)
    ring = build_mesh(MeshSpec(sp=RING["sp"])) if mesh else None
    return TransformerLM(cfg, mesh=ring, device=DEVICE, seed=seed)


def ring_tokens(seed: int = SEED):
    from kubeflow_tpu_torch.train import SyntheticTokens

    return iter(SyntheticTokens(RING["batch"], RING["seq"], LM["vocab_size"],
                                seed=seed, device=DEVICE))


def ring_launches_per_step() -> dict:
    """What one ring train step launches, with the ring positions of one
    hop kind folded into one launch: per layer, the diagonal hop (causal
    kernels, fused backward) once and each of the sp - 1 later hops
    (rectangular kernels) once, plus one delta."""
    layers, full = LM["n_layers"], RING["sp"] - 1
    return {"flash_fwd": layers, "flash_fwd_rect": layers * full,
            "flash_delta": layers, "flash_bwd_fused": layers,
            "flash_bwd_dq_rect": layers * full, "flash_bwd_dkv_rect": layers * full}


def ring_train_phase(torch, card: str) -> dict:
    """Main path 3: the LM trained with sequence parallelism, on an
    in-process sp ring of 4 on one card (ring flash attention: every
    hop's kernels), batch 1 at S = 16384, adamw lr 3e-4; one warm-up
    step, then timed steps with the launch counters zeroed just before
    and read just after. Then the flat LM at the same S, for the cost of
    the ring on one card. Returns the launch counts of the timed steps."""
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    torch.cuda.reset_peak_memory_stats()
    config = TrainConfig(
        batch_size=RING["batch"], learning_rate=RING["lr"], total_steps=10_000,
        optimizer="adamw", label_smoothing=0.0, fsdp_params=False,
        train_metrics="loss",
    )
    tokens = RING["batch"] * RING["seq"]

    def run(model, warmup: int, timed: int):
        trainer = Trainer(model, config, input_key="tokens", label_key="labels",
                          device=DEVICE)
        state, step, data = trainer.init_state(), trainer.make_train_step(), ring_tokens()
        losses = []
        for _ in range(warmup):
            state, metrics = step(state, next(data))
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        _kernels.launches.clear()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, metrics = step(state, next(data))
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
        return trainer, state, step, data, losses, step_s, dict(_kernels.launches)

    t0 = time.perf_counter()
    model = ring_model(torch, torch.bfloat16)
    init_s = time.perf_counter() - t0
    n = RING["timed_steps"]
    trainer, state, step, data, losses, step_s, launches = run(
        model, RING["warmup_steps"], n)
    want = {k: v * n for k, v in ring_launches_per_step().items()}
    if launches != want:
        raise AssertionError(f"ring train launches {launches} over {n} steps (want {want})")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite ring loss: {losses}")
    profile = profile_device(torch, lambda: step(state, next(data)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainer, state, step, model
    torch.cuda.empty_cache()

    flat = run(ring_model(torch, torch.bfloat16, mesh=False), 1, 2)
    flat_step_s = flat[5]
    del flat
    torch.cuda.empty_cache()
    tokens_per_s = tokens / step_s
    result = {
        "phase": "ring_train",
        "model": {**LM, "dtype": "bfloat16", "remat": "none"},
        "mesh": {"sp": RING["sp"], "in_process": True}, "batch": RING["batch"],
        "seq": RING["seq"], "chunk": RING["seq"] // RING["sp"], "optimizer": "adamw",
        "learning_rate": RING["lr"], "init_s": init_s, "timed_steps": n,
        "step_ms": step_s * 1e3, "tokens_per_s": tokens_per_s,
        "flops_per_token": flops_per_token(RING["seq"]),
        "mfu": tokens_per_s * flops_per_token(RING["seq"]) / PEAK_FLOPS["bfloat16"],
        "losses": losses,
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "profile_one_step": profile, "peak_memory_gib": peak,
        "flat_same_seq_step_ms": flat_step_s * 1e3,
        "flat_same_seq_tokens_per_s": tokens / flat_step_s,
        "ring_over_flat_step": step_s / flat_step_s,
        "card": card,
    }
    emit(result)
    return launches


def ring_check_phase(torch, seed: int = SEED, strict: bool = True):
    """One ring train step's loss and every parameter's gradient, on the
    same weights and tokens (batch 1 x 16384), with remat "full" to keep
    the f32 activations in memory.

    f32: the ring (rectangular kernels on full hops, causal kernels on
    the diagonal) against the flat LM (causal kernels over the whole
    sequence): |loss difference| <= 1e-4·|loss| and every gradient within
    relative norm 1e-4 — the kernels' 5e-5 gate carried through 16
    layers, as train_check holds the flat path. bf16: the ring rounds
    each hop's output to bf16 before the merge, as JAX's does, so it is
    not held to the flat path. The ring on the kernels is held against
    the same ring with the plain versions in place of the kernels, with
    the flat kernel path against the flat plain-version path as the
    reference pair (as train_check does): every gradient within twice
    the reference's relative norm, and the loss by `bf16_loss_ok`. The
    ring's distance to the flat path is printed too."""
    batch = next(ring_tokens(seed))
    rows, ok = [], True

    def run(model, plain=False):
        with plain_kernels() if plain else contextlib.nullcontext():
            return step_grads(torch, model, batch)

    ring, flat = (ring_model(torch, torch.float32, mesh=m, remat="full", seed=seed)
                  for m in (True, False))
    loss_r, nll_r, g_r = run(ring)
    loss_f, nll_f, g_f = run(flat)
    loss_r, loss_f = float(loss_r), float(loss_f)
    errs = {n: rel(g_r[n], g_f[n]) for n in g_r}
    ok &= abs(loss_r - loss_f) <= 1e-4 * abs(loss_f) and max(errs.values()) <= 1e-4
    ok &= all(bool(torch.isfinite(g).all()) for g in g_r.values())
    rows.append({
        "dtype": "float32", "layers": LM["n_layers"], "loss_ring": loss_r,
        "loss_flat": loss_f, "loss_err_vs_flat": abs(loss_r - loss_f),
        "loss_tol_rel": 1e-4, "token_loss_rel_err_vs_flat": rel(nll_r, nll_f),
        "max_rel_err_vs_flat": max(errs.values()), "worst_param": max(errs, key=errs.get),
        "grad_tol_rel": 1e-4, "params": len(g_r),
    })
    del ring, flat, g_r, g_f
    torch.cuda.empty_cache()

    ring, flat = (ring_model(torch, torch.bfloat16, mesh=m, remat="full", seed=seed)
                  for m in (True, False))
    loss_rk, nll_rk, g_rk = run(ring)
    loss_rp, nll_rp, g_rp = run(ring, plain=True)
    loss_fk, nll_fk, g_fk = run(flat)
    loss_fp, nll_fp, g_fp = run(flat, plain=True)
    ring_kp, flat_kp = loss_gap(nll_rk, nll_rp), loss_gap(nll_fk, nll_fp)
    ok &= bf16_loss_ok(ring_kp, flat_kp)
    worst = {"name": None, "ratio": 0.0}
    for name in g_rk:
        err, gap = rel(g_rk[name], g_rp[name]), rel(g_fk[name], g_fp[name])
        ok &= err <= 2 * gap and bool(torch.isfinite(g_rk[name]).all())
        if err / max(gap, 1e-30) > worst["ratio"]:
            worst = {"name": name, "ratio": err / max(gap, 1e-30),
                     "rel_err_ring_kernel_vs_plain": err,
                     "rel_gap_flat_kernel_vs_plain": gap}
    rows.append({
        "dtype": "bfloat16", "loss_ring_kernel": float(loss_rk),
        "loss_ring_plain": float(loss_rp), "loss_flat_kernel": float(loss_fk),
        "loss_flat_plain": float(loss_fp),
        "loss_ring_kernel_vs_plain": ring_kp, "loss_flat_kernel_vs_plain": flat_kp,
        "loss_tol": {"token_rel": 2 * flat_kp["token_rel"], "abs_z": LOSS_Z},
        "mean_loss_ratio_ring_over_flat": ratio(ring_kp["mean_diff"], flat_kp["mean_diff"]),
        "max_rel_err_ring_vs_plain": max(rel(g_rk[n], g_rp[n]) for n in g_rk),
        "max_rel_gap_flat_vs_plain": max(rel(g_fk[n], g_fp[n]) for n in g_fk),
        "worst_param_vs_its_tol": worst,
        "loss_ring_vs_flat": loss_gap(nll_rk, nll_fk),
        "max_rel_dist_ring_vs_flat": max(rel(g_rk[n], g_fk[n]) for n in g_rk),
    })
    del ring, flat, g_rk, g_rp, g_fk, g_fp
    torch.cuda.empty_cache()
    emit({"phase": "ring_check", "seed": seed, "rows": rows, "ok": ok})
    if strict and not ok:
        raise AssertionError(f"ring step off its references: {rows}")
    return ok, rows


def ring_inputs(torch, n: int):
    """q, k, v, dO of the hop shape's width over a ring of n chunks:
    [1, n·4096, 8, 128] float32, drawn on the CPU from SEED."""
    b, c, _, h, d, _ = HOP_SHAPE
    gen = torch.Generator().manual_seed(SEED + 3)
    return [torch.randn(b, n * c, h, d, generator=gen) for _ in range(4)]


def ring_nccl_worker(out_dir: str) -> int:
    """One rank of the NCCL ring (chip_smoke.py --ring-nccl-worker DIR,
    with the TPUJOB_* env contract): its chunk of ring_inputs through
    ring_flash_attention, forward and backward, saved for the parent."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env

    pe = initialize_from_env()
    try:
        mesh = build_mesh(MeshSpec(sp=-1))
        n, r = pe.num_processes, pe.process_id
        c = HOP_SHAPE[1]
        q, k, v, do = (x[:, r * c:(r + 1) * c].cuda() for x in ring_inputs(torch, n))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        o = ring_flash_attention(q, k, v, mesh, causal=True)
        o.backward(do)
        torch.cuda.synchronize()
        torch.save({"o": o.detach().cpu(), "dq": q.grad.cpu(), "dk": k.grad.cpu(),
                    "dv": v.grad.cpu()}, os.path.join(out_dir, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def ring_nccl_phase(torch) -> None:
    """With two or more cards: min(4, count) processes on an NCCL sp
    group (one card each) run ring flash attention at the hop shape's
    chunk, forward and backward, and each rank's output and gradients
    must match the in-process ring's on the same inputs, with the
    backward kernels' f32 tolerance. In f32, because the fused kernel's
    atomics add in an order that changes from run to run: in bf16 each
    hop's dq is rounded before the hops are summed, so that order can
    flip one bf16 ulp of a hop's dq, more than a relative bound on the
    smaller total allows. On one card it prints that it did not run."""
    import socket
    import tempfile

    from kubeflow_tpu_torch.ops.flash import ring_flash_attention
    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh

    count = torch.cuda.device_count()
    if count < 2:
        emit({"phase": "ring_nccl", "run": False, "gpus": count})
        return
    n = min(4, count)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        env = dict(os.environ, TPUJOB_COORDINATOR=f"localhost:{port}",
                   TPUJOB_NUM_PROCESSES=str(n))
        procs = [
            subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--ring-nccl-worker", out_dir],
                             env=dict(env, TPUJOB_PROCESS_ID=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)
        ]
        t0 = time.perf_counter()
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        seconds = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise AssertionError("ring_nccl workers failed:\n" + "\n".join(logs))
        parts = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=True)
                 for r in range(n)]
    q, k, v, do = (x.cuda() for x in ring_inputs(torch, n))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = ring_flash_attention(q, k, v, build_mesh(MeshSpec(sp=n)), causal=True)
    o.backward(do)
    want = {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    rows, ok = {}, True
    for key, w in want.items():
        got = torch.cat([p[key] for p in parts], dim=1).cuda()
        good, err, atol, rtol = bwd_close(got, w, "float32")
        ok &= good
        rows[key] = {"max_abs_err": err, "tol_atol_rtol": [atol, rtol]}
    emit({"phase": "ring_nccl", "run": True, "gpus": count, "ranks": n,
          "shape_b_s_h_d": list(q.shape), "seconds": seconds, "rows": rows, "ok": ok})
    if not ok:
        raise AssertionError(f"NCCL ring off the in-process ring: {rows}")


def loss_seeds(torch, n: int) -> None:
    """chip_smoke.py --loss-seeds N: train_check and ring_check for the
    seeds 0..N-1 of weights and tokens, none of them raising, then one
    line with each seed's bf16 loss statistics: the z-scores that
    `bf16_loss_ok` holds to LOSS_Z, the per-token norm ratios it holds
    to 2, and the mean-loss ratios of the pairs (checked over reference),
    for the readings LOSS_Z is set from."""
    seeds = []
    for seed in range(n):
        t_ok, (t_row, _) = train_check_phase(torch, seed, strict=False)
        r_ok, (_, r_row) = ring_check_phase(torch, seed, strict=False)
        kp, pd = t_row["loss_kernel_vs_plain"], t_row["loss_plain_vs_dense"]
        rkp, fkp = r_row["loss_ring_kernel_vs_plain"], r_row["loss_flat_kernel_vs_plain"]
        seeds.append({
            "seed": seed, "train_check_ok": t_ok, "ring_check_ok": r_ok,
            "train_z_kernel_vs_plain": kp["z"], "train_z_plain_vs_dense": pd["z"],
            "train_token_rel_ratio": ratio(kp["token_rel"], pd["token_rel"]),
            "train_mean_loss_ratio": ratio(kp["mean_diff"], pd["mean_diff"]),
            "ring_z_kernel_vs_plain": rkp["z"], "flat_z_kernel_vs_plain": fkp["z"],
            "ring_token_rel_ratio": ratio(rkp["token_rel"], fkp["token_rel"]),
            "ring_mean_loss_ratio": ratio(rkp["mean_diff"], fkp["mean_diff"]),
        })
    z_keys = [k for k in seeds[0] if "_z_" in k]
    emit({"phase": "loss_seeds", "seeds": seeds, "loss_z": LOSS_Z,
          "max_abs_z": max(abs(row[k]) for row in seeds for k in z_keys),
          "max_token_rel_ratio": max(max(row["train_token_rel_ratio"],
                                         row["ring_token_rel_ratio"]) for row in seeds)})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import kubeflow_tpu_torch  # noqa: F401
    except ImportError as err:  # the script alone, outside a checkout
        print(f"chip_smoke: {err}; run it from the root of a checkout",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = device_phase(torch)["nvidia_smi"]
    build_phase()
    if sys.argv[1:2] == ["--loss-seeds"]:
        loss_seeds(torch, int(sys.argv[2]))
        return 0
    serving_fwd = kernel_phase(torch)
    entries = bwd_kernel_phase(torch, card)
    rect_entries = rect_kernel_phase(torch, card)
    servable, batches, served, result = serve_phase(torch)
    check_phase(torch, servable, batches, served)
    timing_phase(torch, servable, batches)
    del servable
    torch.cuda.empty_cache()
    by_path = {"serve": result["launches"], **train_phase(torch, card)}
    train_check_phase(torch)
    entries.update(rect_entries)
    by_path["ring_train"] = ring_train_phase(torch, card)
    ring_check_phase(torch)
    ring_nccl_phase(torch)
    for name, entry in entries.items():
        counts = {path: launches.get(name, 0) for path, launches in by_path.items()}
        entry["launches"] = sum(counts.values())
        entry["launches_by_path"] = counts
        if entry["launches"] == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    entries["flash_fwd"]["max_abs_err"] = serving_fwd["max_abs_err"]
    entries["flash_fwd"]["serving_shape"] = {
        key: serving_fwd[key] for key in (
            "shape_bshd", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "achieved_tflops", "bound_share")
    }
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)  # nvidia-smi's name and power limit
    emit({"kernels": [entries[name] for name in KERNEL_ROWS]})
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ring-nccl-worker"]:
        sys.exit(ring_nccl_worker(sys.argv[2]))
    sys.exit(main())
