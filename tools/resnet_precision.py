#!/usr/bin/env python3
"""Where ResNet-50's f32 training step departs from float64, on the CPU.

    python3 tools/resnet_precision.py [--init flax|unit] [--batch 8]

Runs chip_smoke.py's resnet_check step (resnet50 at 224, a training-mode
forward and backward of the loss with smoothing 0.1) on the CPU in f32
and in float64 (up to the logits, which the model returns in f32), and
the bf16 forward, on the same weights and batch, and prints one JSON
line:

- the f32 logits' and the bf16 logits' relative-norm distance from the
  float64 and the f32 logits;
- the f32 gradients' relative-norm distance from float64, worst and
  median over the tensors;
- `first_departure`: walking from the logits toward the input over the
  BatchNorm outputs, the first whose gradient lies 1e-4 or more from
  float64, the number of its outputs whose sign differs between f32 and
  float64 (a ReLU takes most of them next), and the gradient distance
  at the BatchNorm after it.

`--init flax` (the default) takes `chip_smoke.resnet_check_model`'s
weights; `--init unit` then sets every BatchNorm's scale to 1 +- 0.2,
the zero-initialised last one of each block included, so that every
residual branch enters at full strength. Needs no GPU; about 10 s and
4 GB at batch 8.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--init", choices=("flax", "unit"), default="flax")
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from kubeflow_tpu_torch.models import resnet
    from kubeflow_tpu_torch.train import softmax_cross_entropy

    f32 = cs.resnet_check_model(torch)
    if args.init == "unit":
        gen = torch.Generator().manual_seed(cs.SEED)
        with torch.no_grad():
            for bn in f32.modules():
                if isinstance(bn, resnet.BatchNorm):
                    bn.weight.copy_(1 + 0.2 * torch.randn(bn.weight.shape, generator=gen))
    f64 = cs.resnet_model(torch, torch.float64, device="cpu").double()
    f64.load_state_dict({k: v.double() for k, v in f32.state_dict().items()})
    bf16 = cs.resnet_model(torch, torch.bfloat16, device="cpu")
    bf16.load_state_dict(f32.state_dict())
    x, y = cs.resnet_check_batch(args.batch)
    x, y = torch.tensor(x), torch.tensor(y)

    def step(model):
        model.train()
        outs = {}

        def keep(name):
            def hook(module, inputs, out):
                out.retain_grad()
                outs[name] = out
            return hook

        hooks = [m.register_forward_hook(keep(n)) for n, m in model.named_modules()
                 if isinstance(m, resnet.BatchNorm)]
        try:
            logits = model(x)
            softmax_cross_entropy(logits, y, 0.1).backward()
        finally:
            for hook in hooks:
                hook.remove()
        grads = {k: p.grad for k, p in model.named_parameters()}
        return logits.detach(), grads, {k: (v.detach(), v.grad) for k, v in outs.items()}

    rel = lambda a, b: float((a.double() - b.double()).norm() / b.double().norm())
    logits32, grads32, bn32 = step(f32)
    logits64, grads64, bn64 = step(f64)
    with torch.no_grad():
        logits16 = bf16(x).float()
    grad_rel = [rel(grads32[k], g) for k, g in grads64.items()]
    names = list(bn64)  # forward order
    departure = None
    for i in range(len(names) - 1, -1, -1):
        name = names[i]
        if rel(bn32[name][1], bn64[name][1]) >= 1e-4:
            after = names[i + 1] if i + 1 < len(names) else None
            departure = {
                "batch_norm": name,
                "grad_vs_f64": rel(bn32[name][1], bn64[name][1]),
                "sign_flips": int(((bn32[name][0] > 0) != (bn64[name][0] > 0)).sum()),
                "outputs": bn64[name][0].numel(),
                "next_batch_norm": after,
                "next_grad_vs_f64": rel(bn32[after][1], bn64[after][1]) if after else None,
            }
            break
    print(json.dumps({
        "init": args.init, "batch": args.batch, "image": cs.RESNET["image"],
        "f32_vs_f64_logits_rel_norm": rel(logits32, logits64),
        "bf16_vs_f32_logits_rel_norm": rel(logits16, logits32),
        "f32_vs_f64_grad_max": max(grad_rel),
        "f32_vs_f64_grad_median": float(np.median(grad_rel)),
        "first_departure": departure,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
