#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`kubeflow_tpu_torch`) on one GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with an NVIDIA H100, the CUDA
toolkit (nvcc) and PyTorch built for CUDA. Phases, each printed as one
JSON line; any failure raises and the exit code is non-zero:

1. device: the card (nvidia-smi's name and power limit), torch and CUDA.
2. build: every kernel under kubeflow_tpu_torch/ops/csrc, built with
   nvcc for sm_90a (or found built), with ptxas's resource report.
3. kernel: each kernel against its plain PyTorch version on the card,
   in bf16 and f32, at small, ragged and serving shapes, with the stated
   tolerance; then its time beside the plain version's, one PyTorch
   library call's and the card's bound.
4. serve, the main path: the full-width TransformerLM (vocab 32000,
   d_model 1024, 16 layers, 8x128 heads, d_ff 4096, bf16; random
   weights from seed 0) behind Servable -> ModelRepository ->
   ModelServerApp -> HTTP, three :predict requests (JSON and binary
   frame, S=2048 and S=1001). The launch counters are zeroed just
   before the requests and read just after: 16 flash launches per
   forward.
5. check: the served answers against the same module run directly with
   attention through the plain version (bf16, and the same weights in
   f32), with the tolerances stated in `check_phase`.
6. forward: forward time per request shape, the 4 x 2048 bucket with
   the kernel and with the plain version, and a profile of its device
   time by kernel.
7. kernels: one line per ported kernel (launches, error, times, bound).
8. the last line: {"ok": true, "device": {...}}.

Without a GPU it exits non-zero before printing any result.
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
LM = dict(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
          head_dim=128, d_ff=4096)
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


def build_phase() -> None:
    from kubeflow_tpu_torch.ops import _kernels

    built = _kernels.build()
    emit({
        "phase": "build",
        "kernels": {
            name: {
                "cached": b["cached"],
                "seconds": round(b["seconds"], 3),
                "ptxas": [
                    line.strip() for line in b["ptxas"].splitlines()
                    if "registers" in line or "spill" in line
                ],
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


def last_logits(model, tokens):
    """The servable's function: next-token logits [n, V] (f32) at the
    last position."""
    from kubeflow_tpu_torch.models.transformer import lm_head

    h = model.features(tokens)[:, -1:]
    return lm_head(h, model.embedding, dtype=model.config.dtype)[:, 0]


def plain_attend(q, k, v, *, causal=True, block_q=1024, block_k=1024):
    """`flash_attention` with the plain version in place of the kernel."""
    from kubeflow_tpu_torch.ops import flash

    b, s, h, d = q.shape
    bhsd = lambda x: x.transpose(1, 2).contiguous().view(b * h, s, d)
    o, _ = flash.flash_attention_reference(
        bhsd(q), bhsd(k), bhsd(v), causal=causal, block_q=block_q,
        block_k=block_k,
    )
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


def profile_forward(torch, servable, batch) -> dict:
    """Device time by kernel over one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    servable.predict(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        servable.predict(batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + evt.self_device_time_total / 1e3
    if not kernels:
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    groups = {"flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        low = name.lower()
        if "flash_fwd" in low:
            groups["flash_fwd"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
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
        "profile_4x2048": profile_forward(torch, servable, full),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    })


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
    device_phase(torch)
    build_phase()
    entry = kernel_phase(torch)
    servable, batches, served, result = serve_phase(torch)
    entry["launches"] = result["launches"].get("flash_fwd", 0)
    check_phase(torch, servable, batches, served)
    timing_phase(torch, servable, batches)
    emit({"kernels": [entry]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
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
