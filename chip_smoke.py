#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Phases, each printed as one
JSON line; any failure raises and the exit code is non-zero:

1. device: the card (nvidia-smi's name and power limit), torch and CUDA.
2. build: every kernel under kubeflow_tpu_torch/ops/csrc, built with
   nvcc for sm_90a (one nvcc per source, all at once, or found built),
   with ptxas's resource report.
3. kernel: flash_fwd against its plain PyTorch version on the card, in
   bf16 and f32, at small, ragged and serving shapes, with the stated
   tolerance; then its time beside the plain version's, one PyTorch
   library call's and the card's bound.
4. bwd_kernel: the backward kernels (flash_delta, flash_bwd_fused,
   flash_bwd_dq, flash_bwd_dkv) against their plain versions at small,
   ragged, training and long shapes in bf16 and f32; then every
   kernel's time at the training shape (B=8, S=2048, H=8, D=128, bf16).
5. serve, main path 1: the full-width TransformerLM (vocab 32000,
   d_model 1024, 16 layers, 8x128 heads, d_ff 4096, bf16; random
   weights from seed 0) behind Servable -> ModelRepository ->
   ModelServerApp -> HTTP, three :predict requests (JSON and binary
   frame, S=2048 and S=1001). The launch counters are zeroed just
   before the requests and read just after: 16 flash launches per
   forward.
6. check: the served answers against the same module run directly with
   attention through the plain version (bf16, and the same weights in
   f32), with the tolerances stated in `check_phase`.
7. forward: forward time per request shape, the 4 x 2048 bucket with
   the kernel and with the plain version, and a profile of its device
   time by kernel.
8. train, main path 2: the same LM trained as `bench.py --workload lm`
   trains it (remat "none", adamw lr 3e-4, loss-only metrics) on
   SyntheticTokens, batch 8 at S=2048: 2 warm-up steps, then timed
   steps with the launch counters zeroed just before and read just
   after (16 flash_fwd + 16 flash_delta + 16 flash_bwd_fused a step),
   one more step with the two-pass backward pinned
   (KFTPU_FLASH_FUSED_BWD=0: 16 flash_bwd_dq + 16 flash_bwd_dkv), step
   time, tokens/s, MFU and a profile of one step.
9. train_check: one step's loss and every parameter's gradient on the
   kernel path against the same step with attention through the plain
   versions, in bf16 and in f32, with the tolerances stated in
   `train_check_phase`.
10. kernels: one line per ported kernel (launches, error, times, bound).
11. the last line: {"ok": true, "device": {...}}.

Without a GPU it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import functools
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
KERNEL_ROWS = {  # name → (CUDA source, the TPU kernel it replaces)
    "flash_fwd": ("flash_fwd.cu", "kubeflow_tpu/ops/flash.py:533 (_fwd_kernel_compact)"),
    "flash_delta": ("flash_delta.cu", "kubeflow_tpu/ops/flash.py:549 (_delta_kernel)"),
    "flash_bwd_fused": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:714 (_dqkv_kernel_fused)"),
    "flash_bwd_dq": ("flash_bwd_dq.cu", "kubeflow_tpu/ops/flash.py:618 (_dq_kernel_compact)"),
    "flash_bwd_dkv": ("flash_bwd_dkv.cu", "kubeflow_tpu/ops/flash.py:696 (_dkv_kernel_compact)"),
}
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


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel: its (mangled) name, registers and
    spills, from nvcc -Xptxas -v."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def build_phase() -> None:
    from kubeflow_tpu_torch.ops import _kernels

    built = _kernels.build()
    emit({
        "phase": "build",
        "kernels": {
            name: {
                "cached": b["cached"],
                "seconds": round(b["seconds"], 3),
                "ptxas": ptxas_report(b["ptxas"]),
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
            "card": card,
        }
        emit({"phase": "bwd_kernel_timing", **entries[name]})
    return entries


def last_logits(model, tokens):
    """The servable's function: next-token logits [n, V] (f32) at the
    last position."""
    from kubeflow_tpu_torch.models.transformer import lm_head

    h = model.features(tokens)[:, -1:]
    return lm_head(h, model.embedding, dtype=model.config.dtype)[:, 0]


@functools.cache
def plain_flash_function():
    """An autograd Function over the plain versions alone: the plain
    forward, and delta plus the two-pass plain backward on CUDA tensors
    (the port itself never takes them for a CUDA tensor)."""
    import torch

    from kubeflow_tpu_torch.ops import flash

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, block_q, block_k):
            o, lse = flash.flash_attention_reference(
                q, k, v, block_q=block_q, block_k=block_k
            )
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.blocks = (block_q, block_k)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            do = do.contiguous()
            block_q, block_k = ctx.blocks
            grads = flash.flash_bwd_reference(
                q, k, v, do, lse, flash.flash_delta_reference(o, do),
                block_q=block_q, block_k=block_k,
            )
            return (*grads, None, None)

    return PlainFlash


def plain_attend(q, k, v, *, causal=True, block_q=1024, block_k=1024, **_):
    """`flash_attention` with the plain versions in place of the kernels."""
    assert causal
    b, s, h, d = q.shape
    bhsd = lambda x: x.transpose(1, 2).contiguous().view(b * h, s, d)
    o = plain_flash_function().apply(bhsd(q), bhsd(k), bhsd(v), block_q, block_k)
    return o.view(b, h, s, d).transpose(1, 2)


def dense_attend(q, k, v, *, causal=True, **_):
    from kubeflow_tpu_torch.ops.attention import dense_attention

    return dense_attention(q, k, v, causal=causal)


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
            with attention_via(plain_attend):
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
            with attention_via(plain_attend):
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
    with attention_via(plain_attend):
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


def train_model(torch, dtype):
    """The bench's LM (remat "none", bf16 or f32 compute over f32
    params), random weights from SEED, and its adamw trainer."""
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.train import TrainConfig, Trainer

    cfg = TransformerConfig(**LM, dtype=dtype, remat_policy="none")
    config = TrainConfig(
        batch_size=TRAIN["batch"], learning_rate=TRAIN["lr"],
        total_steps=10_000, optimizer="adamw", label_smoothing=0.0,
        fsdp_params=False, train_metrics="loss",
    )
    model = TransformerLM(cfg, device=DEVICE, seed=SEED)
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


def step_grads(torch, trainer, batch):
    """One forward and backward of the train step's loss: (loss,
    {name: gradient}), with the parameters left as they were."""
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    model = trainer.model
    model.zero_grad(set_to_none=True)
    loss = softmax_cross_entropy(model(batch["tokens"]), batch["labels"])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def train_check_phase(torch) -> None:
    """The kernel path's loss and gradients against the same step with
    attention through the plain versions, on the same weights and batch.

    bf16: kernel and plain versions round differently (one bf16 ulp in an
    attention output or gradient, now and then), and 16 bf16 layers carry
    that on, so the bound is a second bf16 path's own distance, as the
    forward check's: for the loss and for every parameter's gradient
    (relative Frobenius norm), the kernel path must lie within twice the
    plain path's distance from the dense path. f32: the same weights in
    f32, kernel path vs plain path, |loss difference| <= 1e-4·|loss| and
    every gradient within relative norm 1e-4: the kernels' 5e-5 gate,
    carried through 16 layers forward and back."""
    from kubeflow_tpu_torch.train import SyntheticTokens

    batch = next(iter(SyntheticTokens(TRAIN["batch"], TRAIN["seq"], LM["vocab_size"],
                                      seed=SEED, device=DEVICE)))
    rows, ok = [], True
    trainer = train_model(torch, torch.bfloat16)
    loss_k, g_k = step_grads(torch, trainer, batch)
    with attention_via(plain_attend):
        loss_p, g_p = step_grads(torch, trainer, batch)
    with attention_via(dense_attend):
        loss_d, g_d = step_grads(torch, trainer, batch)
    loss_err, loss_gap = abs(float(loss_k - loss_p)), abs(float(loss_p - loss_d))
    ok &= loss_err <= 2 * loss_gap
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
        "loss_err_vs_plain": loss_err, "loss_tol": 2 * loss_gap,
        "params": len(g_k), "wq_wk_wv_with_grads": len(qkv),
        "max_rel_err_vs_plain": max(rel(g_k[n], g_p[n]) for n in g_k),
        "max_rel_err_param": max(g_k, key=lambda n: rel(g_k[n], g_p[n])),
        "worst_param_vs_its_tol": worst,
    })
    del trainer, g_k, g_p, g_d
    torch.cuda.empty_cache()

    trainer = train_model(torch, torch.float32)
    loss_k, g_k = step_grads(torch, trainer, batch)
    with attention_via(plain_attend):
        loss_p, g_p = step_grads(torch, trainer, batch)
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
    emit({"phase": "train_check", "rows": rows, "ok": ok})
    if not ok:
        raise AssertionError(f"train step off the plain path: {rows}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import kubeflow_tpu_torch  # noqa: F401  (fails here, outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = device_phase(torch)["nvidia_smi"]
    build_phase()
    serving_fwd = kernel_phase(torch)
    entries = bwd_kernel_phase(torch, card)
    servable, batches, served, result = serve_phase(torch)
    check_phase(torch, servable, batches, served)
    timing_phase(torch, servable, batches)
    del servable
    torch.cuda.empty_cache()
    by_path = {"serve": result["launches"], **train_phase(torch, card)}
    train_check_phase(torch)
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
            "max_abs_err")
    }
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)  # nvidia-smi's name and power limit
    emit({"kernels": list(entries.values())})
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
    sys.exit(main())
