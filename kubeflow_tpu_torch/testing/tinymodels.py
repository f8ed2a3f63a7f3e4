"""Tiny test-support models for the resilience suites.

Counterpart of `kubeflow_tpu/testing/tinymodels.py`. `TinyMLP` is
deliberately normalization-free: BatchNorm/LayerNorm models normalize a
scaled poison batch away before it reaches the loss, so fault-injection
suites would never see their scheduled loss spikes. Keep this model
free of any normalization layer.
"""

from __future__ import annotations

import torch
from torch import nn

from kubeflow_tpu_torch._device import resolve_device


class TinyMLP(nn.Module):
    """flatten → Dense(hidden) → ReLU → Dense(num_classes), float32, as
    the flax module computes it. Layer names follow flax's (``Dense_0``,
    ``Dense_1``; weights (out, in) as `nn.Linear` keeps them, so
    `models.convert.tinymlp_from_flax` transposes flax's kernels). The
    weights are drawn from `seed`: fan-in variance-scaling normal
    kernels and zero biases, as `models.convert.init_params` draws the
    LM's; `in_features` is what flax infers from the first input.
    `device` defaults to CUDA."""

    def __init__(self, in_features: int, num_classes: int = 10, hidden: int = 16, *,
                 device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.Dense_0 = nn.Linear(in_features, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)
        with torch.no_grad():
            for dense in (self.Dense_0, self.Dense_1):
                fan_in = dense.weight.shape[1]
                dense.weight.copy_(torch.randn(dense.weight.shape, generator=gen)
                                   * fan_in ** -0.5)
                dense.bias.zero_()
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        return self.Dense_1(torch.relu(self.Dense_0(x))).float()
