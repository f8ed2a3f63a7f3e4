#!/usr/bin/env python3
"""Times the start of an LM job worker in a fresh process, stage by stage.

    python3 tools/worker_start.py [N] [--cprofile]

starts N (default 2) fresh Python processes one after another. Each does
what `kubeflow_tpu_torch/testing/workers/lm_job.py` does up to and
through its first steps, at the bench's full width (vocab 32000,
d_model 1024, 16 layers, 8 x 128 heads, d_ff 4096, bf16 over f32
params, AdamW, batch 8 x 2048), with no apiserver, and prints one JSON
line of the seconds from its spawn to the end of each stage: the
interpreter, ``import torch``, the worker's imports of the port, the
CUDA context, the flash kernels' libraries, the model, the trainer, the
stream and checkpointer, then fit()'s first three steps (each step's
line is printed as it ends). chip_smoke's job paths spend this between a
pod's spawn and its worker's first step. Builds the kernels first in
this process (nvcc), so no child builds. With ``--cprofile`` each child
also prints the 30 functions of fit()'s host time with the most time of
their own (cProfile). Needs a CUDA device.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(t0: float, cprofile: bool) -> int:
    stamps = {"interpreter": time.time() - t0}
    mark = lambda name: stamps.__setitem__(name, time.time() - t0)
    import torch
    mark("import_torch")
    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.models import TransformerConfig, TransformerLM
    from kubeflow_tpu_torch.ops import _kernels
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient  # noqa: F401
    from kubeflow_tpu_torch.train import (
        AnomalyGuard, Checkpointer, SyntheticTokens, TrainConfig, Trainer, fit)
    mark("import_port")
    device = torch.device("cuda")
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    mark("cuda_context")
    for name in ("flash_fwd", "flash_delta", "flash_bwd_dkv"):
        _kernels.library(name)
    mark("kernel_libraries")
    cfg = TransformerConfig(vocab_size=32000, d_model=1024, n_layers=16, n_heads=8,
                            head_dim=128, d_ff=4096, dtype=torch.bfloat16,
                            remat_policy="none")
    model = TransformerLM(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    mark("model")
    trainer = Trainer(
        model,
        TrainConfig(batch_size=8, learning_rate=3e-4, total_steps=10_000,
                    optimizer="adamw", adam_mu_dtype="bfloat16", label_smoothing=0.0,
                    fsdp_params=False, train_metrics="loss"),
        input_key="tokens", label_key="labels", device=device, guard=AnomalyGuard())
    torch.cuda.synchronize()
    mark("trainer")
    data = SyntheticTokens(8, 2048, 32000, seed=0, vary_per_step=True, device=device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, save_interval_steps=1000)
        mark("stream_and_checkpointer")
        run = lambda: fit(trainer, data, 3, rng=0, checkpointer=ckpt, log_every=1,
                          on_metrics=lambda step, rec: mark(f"step_{step}"))
        if cprofile:
            import cProfile
            import io
            import pstats

            prof = cProfile.Profile()
            prof.runcall(run)
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(30)
            print(text.getvalue(), flush=True)
        else:
            run()
        ckpt.close()
    print(json.dumps({"pid": os.getpid(), "seconds_from_spawn": stamps}), flush=True)
    return 0


def main(n: int, cprofile: bool) -> int:
    sys.path.insert(0, ROOT)
    from kubeflow_tpu_torch.ops import _kernels

    _kernels.build()
    for _ in range(n):
        t0 = time.time()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               repr(t0), *(["--cprofile"] if cprofile else [])],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
    return 0


if __name__ == "__main__":
    flag = "--cprofile" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--cprofile"]
    if args[:1] == ["--child"]:
        sys.exit(child(float(args[1]), flag))
    sys.exit(main(int(args[0]) if args else 2, flag))
