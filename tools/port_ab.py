#!/usr/bin/env python3
"""Times the PyTorch/CUDA port of one checkout on one GPU, for A/B runs.

    python3 tools/port_ab.py ROOT

imports `kubeflow_tpu_torch` and `chip_smoke.py` from the checkout at
ROOT, builds its kernels, and prints one JSON line: the device time of
each of the eight flash kernels at the shapes of PERF.md's kernel table
(bf16; B=8, S=2048, H=8, D=128 causal, or the ring hop B=1, S_q = S_k =
4096, H=8, D=128 non-causal), by CUDA events, and the host time of the
full-width LM's train steps as chip_smoke.py builds them: the flat step
at batch 8 x 2048, the same step with the two-pass backward pinned
(KFTPU_FLASH_FUSED_BWD=0), and the in-process sp = 4 ring step at batch
1 x 16384. To compare a change with its parent on one card, unpack the
parent into a directory that .gitignore lists and run parent, change,
change, parent in one command:

    git archive <parent> | tar -x -C archive_check/parent
    for r in archive_check/parent . . archive_check/parent; do
        python3 tools/port_ab.py $r
    done

Each run is its own process, so each checkout builds and loads its own
kernels. Needs a CUDA device.
"""

import json
import os
import sys
import time


def main(root: str) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from kubeflow_tpu_torch.ops import _kernels, flash
    from kubeflow_tpu_torch.train import SyntheticTokens, TrainConfig, Trainer

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        print(f"port_ab: chip_smoke.py did not load from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device="cuda").manual_seed(5)

    def draw(bh, s):
        return torch.randn(bh, s, 128, generator=gen, device="cuda", dtype=torch.bfloat16)

    q, k, v, do = (draw(64, 2048) for _ in range(4))
    o, lse = flash.flash_fwd(q, k, v)
    delta = flash.flash_delta(o, do)
    out["flash_fwd"] = cs.cuda_ms(torch, lambda: flash.flash_fwd(q, k, v), iters=20)
    out["flash_delta"] = cs.cuda_ms(torch, lambda: flash.flash_delta(o, do), iters=20)
    out["flash_bwd_fused"] = cs.cuda_ms(
        torch, lambda: flash.flash_bwd_kernels(q, k, v, do, lse, delta, fused=True), iters=10)
    out["flash_bwd_dq"] = cs.cuda_ms(
        torch, lambda: flash._flash_bwd_dq_cuda(q, k, v, do, lse, delta), iters=5)
    out["flash_bwd_dkv"] = cs.cuda_ms(
        torch, lambda: flash._flash_bwd_dkv_cuda(q, k, v, do, lse, delta), iters=5)
    q, k, v, do = (draw(8, 4096) for _ in range(4))
    o, lse = flash.flash_fwd(q, k, v, causal=False)
    delta = flash.flash_delta(o, do)
    out["flash_fwd_rect"] = cs.cuda_ms(
        torch, lambda: flash.flash_fwd(q, k, v, causal=False), iters=20)
    out["flash_bwd_dq_rect"] = cs.cuda_ms(
        torch, lambda: flash._flash_bwd_dq_rect_cuda(q, k, v, do, lse, delta, False), iters=5)
    out["flash_bwd_dkv_rect"] = cs.cuda_ms(
        torch, lambda: flash._flash_bwd_dkv_rect_cuda(q, k, v, do, lse, delta, False), iters=10)
    del q, k, v, do, o, lse, delta

    def step_ms(trainer, data, timed: int, warmup: int) -> float:
        state, step = trainer.init_state(), trainer.make_train_step()
        for _ in range(warmup):
            state, _ = step(state, next(data))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = step(state, next(data))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / timed * 1e3

    trainer = cs.train_model(torch, torch.bfloat16)
    data = iter(SyntheticTokens(cs.TRAIN["batch"], cs.TRAIN["seq"], cs.LM["vocab_size"],
                                seed=cs.SEED, device="cuda"))
    out["flat_step_ms"] = step_ms(trainer, data, 4, 2)
    with cs.two_pass_backward():
        out["two_pass_step_ms"] = step_ms(trainer, data, 4, 1)
    del trainer
    torch.cuda.empty_cache()
    config = TrainConfig(batch_size=cs.RING["batch"], learning_rate=cs.RING["lr"],
                         total_steps=10_000, optimizer="adamw", label_smoothing=0.0,
                         fsdp_params=False, train_metrics="loss")
    trainer = Trainer(cs.ring_model(torch, torch.bfloat16), config, input_key="tokens",
                      label_key="labels", device="cuda")
    out["ring_step_ms"] = step_ms(trainer, cs.ring_tokens(), 3, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
