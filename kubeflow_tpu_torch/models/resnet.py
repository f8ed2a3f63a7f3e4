"""ResNet v1.5: the platform's benchmark image model.

Counterpart of `kubeflow_tpu/models/resnet.py`, with the same modules,
widths and numerics: bf16 compute over float32 parameters (each weight is
cast to the compute dtype at use), the v1.5 bottleneck (the stride on
the 3x3), explicit ``kernel // 2`` padding, a 3/2 max pool with padding
1 after the stem, the last BatchNorm of each block initialised to a zero
scale, and float32 logits from the mean over H and W through a bf16
Dense.

Inputs arrive NHWC, as flax takes them and as serving instances come:
they are cast to the compute dtype, then viewed as NCHW with
``permute(0, 3, 1, 2)``, which has channels_last strides and copies
nothing. On CUDA the 4-D weights are kept channels_last too, so cuDNN
runs every convolution in NHWC; on the CPU the view is made contiguous
NCHW.

Module names are flax's auto-names (``conv_stem``, ``BatchNorm_0``,
``BottleneckBlock_3``, ``Conv_1``, ``Dense_0``), so a JAX ResNet's
``params`` and ``batch_stats`` map onto the state dict by renaming
(`models/convert.resnet_from_flax`).

`BatchNorm` follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``,
not ``nn.BatchNorm2d``: the running statistics move by 0.1 of the batch's
a step and take the *biased* batch variance, the statistics are float32,
and there is no ``num_batches_tracked``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from kubeflow_tpu_torch._device import resolve_device

BN_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
BN_EPS = 1e-5
# jax.nn.initializers' truncated normal: the std of a unit normal cut at
# +-2, which the draw is divided by.
_TRUNC_STD = 0.87962566103423978


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding=k // 2 on each
    side, use_bias=False)``: an OIHW float32 weight, cast at use."""

    def __init__(self, in_features: int, features: int, kernel: int, stride: int = 1,
                 *, dtype, device=None):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, kernel // 2
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel, device=device))

    def forward(self, x):
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=self.padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis of an NCHW tensor.

    Training mode normalises by the batch's statistics and moves the
    running ones toward them: ``running = 0.9 * running + 0.1 * batch``
    with the biased batch variance (flax's max(0, E[x^2] - E[x]^2)).
    The normalisation is PyTorch's ``native_batch_norm`` without running
    buffers, in float32 whatever the input dtype; the batch variance is
    read back from its saved inverse std. Eval mode normalises by the
    running statistics. The output has the input's dtype."""

    def __init__(self, features: int, *, zero_init: bool = False, device=None):
        super().__init__()
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(features, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(0.0 if self.zero_init else 1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=BN_EPS)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            # invstd = (var + eps)^-1/2; the subtraction in float64 adds
            # no rounding of its own.
            var = (invstd.double().pow(-2) - BN_EPS).clamp_(min=0.0).float()
            self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense``: float32 weight (out, in) and bias, cast at use."""

    def __init__(self, in_features: int, features: int, *, dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1, *,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_features, features, 3, strides, **kw)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.Conv_1 = Conv(features, features, 3, **kw)
        # Zero-init the last BN scale so that blocks start as identity.
        self.BatchNorm_1 = BatchNorm(features, zero_init=True, device=device)
        self.project = in_features != features or strides != 1
        if self.project:
            self.Conv_2 = Conv(in_features, features, 1, strides, **kw)
            self.BatchNorm_2 = BatchNorm(features, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 reduce, 3x3 (carries the stride: v1.5), 1x1 expand x4."""

    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1, *,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = features * 4
        self.Conv_0 = Conv(in_features, features, 1, **kw)
        self.BatchNorm_0 = BatchNorm(features, device=device)
        self.Conv_1 = Conv(features, features, 3, strides, **kw)
        self.BatchNorm_1 = BatchNorm(features, device=device)
        self.Conv_2 = Conv(features, out, 1, **kw)
        self.BatchNorm_2 = BatchNorm(out, zero_init=True, device=device)
        self.project = in_features != out or strides != 1
        if self.project:
            self.Conv_3 = Conv(in_features, out, 1, strides, **kw)
            self.BatchNorm_3 = BatchNorm(out, device=device)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet(nn.Module):
    """forward(images [N, H, W, 3]) → float32 logits [N, num_classes].
    Weights are drawn from `seed` at construction (`reset_parameters`);
    load others (e.g. `convert.resnet_from_flax`) with
    `load_state_dict`."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block: type,
        num_classes: int = 1000,
        width: int = 64,
        dtype=torch.bfloat16,
        stem_kernel: int = 7,
        stem_pool: bool = True,
        *,
        device=None,
        seed: int | torch.Generator = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.stem_pool = dtype, stem_pool
        self.conv_stem = Conv(3, width, stem_kernel, 2 if stem_pool else 1,
                              dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(width, device=device)
        features, index = width, 0
        blocks = []
        for stage, n_blocks in enumerate(stage_sizes):
            for block_idx in range(n_blocks):
                strides = 2 if stage > 0 and block_idx == 0 else 1
                out = width * 2**stage
                name = f"{block.__name__}_{index}"
                self.add_module(name, block(features, out, strides, dtype=dtype,
                                            device=device))
                blocks.append(name)
                features, index = out * block.expansion, index + 1
        self.block_names = tuple(blocks)
        self.Dense_0 = Dense(features, num_classes, dtype=dtype, device=device)
        if device.type == "cuda":
            self.to(memory_format=torch.channels_last)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int | torch.Generator) -> None:
        """Draw every weight anew from `seed` (an int seeds a generator on
        the model's device) with flax's initializers, in place: convs
        variance-scaling 2.0 fan-out normal, the Dense 1.0 fan-in
        truncated normal, BN scales 1 (0 where zero-initialised), biases
        0, running mean 0 and variance 1. The numbers differ from JAX's
        threefry draws from the same seed; the distributions are the
        same."""
        device = self.Dense_0.weight.device
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator(device=device).manual_seed(seed))
        for module in self.modules():
            if isinstance(module, Conv):
                w = module.weight
                fan_out = w.shape[0] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=gen, device=gen.device)
                        * math.sqrt(2.0 / fan_out))
            elif isinstance(module, Dense):
                w = module.weight
                std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
                draw = torch.empty(w.shape, device=gen.device)
                nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
                w.copy_(draw)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.reset_parameters()

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC → NCHW, channels_last
        if x.device.type != "cuda":
            # oneDNN's channels_last conv backward in PyTorch's CPU build
            # aborts (a double free) at some batch sizes; the CPU runs
            # NCHW.
            x = x.contiguous()
        x = F.relu(self.BatchNorm_0(self.conv_stem(x)))
        if self.stem_pool:
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        # Logits in f32: the loss is tiny FLOPs but precision-sensitive.
        return self.Dense_0(x).float()


def resnet50(num_classes: int = 1000, dtype=torch.bfloat16, *, device=None,
             seed: int | torch.Generator = 0) -> ResNet:
    return ResNet((3, 4, 6, 3), BottleneckBlock, num_classes=num_classes, dtype=dtype,
                  device=device, seed=seed)


def resnet18(num_classes: int = 1000, dtype=torch.bfloat16, *, device=None,
             seed: int | torch.Generator = 0) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes, dtype=dtype,
                  device=device, seed=seed)


def tiny_resnet(num_classes: int = 10, dtype=torch.float32, *, device=None,
                seed: int | torch.Generator = 0) -> ResNet:
    """CPU-test-sized variant: 8-wide, no stem pool, for 32x32 inputs."""
    return ResNet((1, 1), BasicBlock, num_classes=num_classes, width=8, dtype=dtype,
                  stem_kernel=3, stem_pool=False, device=device, seed=seed)
