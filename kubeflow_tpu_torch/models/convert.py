"""Weights for the port's models: converted or freshly drawn.

`from_flax` renames a JAX `TransformerLM`'s ``variables["params"]``
tree (a switch-MoE model's ``moe/{router/kernel, w_in, w_out}`` too)
into this package's state-dict keys. The layouts already agree, so no
array is transposed. `resnet_from_flax` does the same for a JAX
`ResNet`'s ``params`` and ``batch_stats``: the module names are flax's,
conv kernels go from HWIO to OIHW and the Dense kernel from (in, out)
to (out, in). `tinymlp_from_flax` and `policy_from_flax` convert a JAX
`TinyMLP`'s and an RL policy's Dense layers the same way
(`dense_from_flax`). The caller hands over plain numpy arrays
(unboxing flax's ``LogicallyPartitioned`` wrappers on its side, e.g.
``jax.tree.map(np.asarray, flax.linen.unbox(variables["params"]))``):
this package never imports flax.

`init_params` draws new weights from a seeded `torch.Generator` with
flax's initializers: normal(0.02) for the embedding, fan-in
variance-scaling normal for the dense kernels, ones for norm scales.
The numbers differ from JAX's threefry draws from the same seed; the
distributions are the same.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path: tuple) -> str:
    """("layer_3", "attn", "wq", "kernel") → "layers.3.attn.wq"."""
    parts = list(path)
    if parts[-1] == "kernel":
        parts.pop()
    if parts[0].startswith("layer_"):
        parts[0:1] = ["layers", parts[0][len("layer_"):]]
    return ".".join(parts)


def from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX `TransformerLM`'s ``params`` tree (nested dicts of numpy
    arrays) → the port's state dict, float32 tensors on the CPU."""
    return {
        _torch_key(path): torch.from_numpy(np.array(value, np.float32))
        for path, value in _flatten(params)
    }


_BN_KEYS = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}


def resnet_from_flax(params: Mapping, batch_stats: Mapping | None = None
                     ) -> dict[str, torch.Tensor]:
    """A JAX `ResNet`'s ``params`` (and ``batch_stats``) trees, nested
    dicts of numpy arrays, → the port's `ResNet` state dict, float32
    tensors on the CPU. A tree shaped like ``params`` (its gradients)
    converts the same way."""
    out = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            value = np.array(value, np.float32)
            *module, leaf = path
            if leaf == "kernel":
                # HWIO → OIHW; a Dense's (in, out) → (out, in).
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
                leaf = "weight"
            else:
                leaf = _BN_KEYS.get(leaf, leaf)
            out[".".join((*module, leaf))] = torch.from_numpy(
                np.ascontiguousarray(value))
    return out


def param_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """State-dict key → shape, for a `TransformerConfig`."""
    dm, h, d, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    e = cfg.num_experts
    shapes = {"embedding": (cfg.vocab_size, dm)}
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        shapes.update({
            p + "ln_attn.scale": (dm,),
            p + "attn.wq": (dm, h, d),
            p + "attn.wk": (dm, h, d),
            p + "attn.wv": (dm, h, d),
            p + "attn.wo": (h, d, dm),
            p + "ln_mlp.scale": (dm,),
        })
        if e > 0:
            shapes.update({
                p + "moe.router": (dm, e),
                p + "moe.w_in": (e, dm, ff),
                p + "moe.w_out": (e, ff, dm),
            })
        else:
            shapes.update({
                p + "mlp.wi_gate": (dm, ff),
                p + "mlp.wi_up": (dm, ff),
                p + "mlp.wo": (ff, dm),
            })
    shapes["ln_final.scale"] = (dm,)
    return shapes


def _fan_in(key: str, shape: tuple[int, ...]) -> int:
    # flax's DenseGeneral contracts the input axes: one for the
    # projections into heads, the MLP and the router, (h, d) for attn.wo.
    # The experts' (E, in, out) weights are plain params, whose fan-in
    # flax's variance scaling takes as in × E (the leading axis is a
    # receptive field).
    if key.endswith("attn.wo") or key.endswith(("moe.w_in", "moe.w_out")):
        return shape[0] * shape[1]
    return shape[0]


def init_params(cfg, seed: int | torch.Generator = 0, *, device=None) -> dict[str, torch.Tensor]:
    """Fresh float32 weights for `cfg` on `device`, drawn from `seed`: an
    int seeds a generator on `device`; a `torch.Generator` is drawn from
    on its own device."""
    device = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith(".scale"):
            out[key] = torch.ones(shape, device=device)
            continue
        std = 0.02 if key == "embedding" else math.sqrt(1.0 / _fan_in(key, shape))
        out[key] = (torch.randn(shape, generator=gen, device=gen.device) * std).to(device)
    return out


def dense_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A tree of flax Dense layers (nested dicts of numpy arrays) → the
    state dict of the same module names with `nn.Linear`s, float32
    tensors on the CPU: each kernel (in, out) → weight (out, in), biases
    as they are. Submodule levels become dotted prefixes."""
    out = {}
    for path, value in _flatten(params):
        *module, leaf = path
        value = np.array(value, np.float32)
        if leaf == "kernel":
            value, leaf = value.T, "weight"
        out[".".join((*module, leaf))] = torch.from_numpy(np.ascontiguousarray(value))
    return out


# A JAX `TinyMLP`'s ``params`` → `testing.tinymodels.TinyMLP`'s state dict.
tinymlp_from_flax = dense_from_flax
# A JAX `PolicyMLP`'s ``params`` → `rl.policy.PolicyMLP`'s state dict, or
# a `PolicyWithLoss`'s (its ``policy`` level) → `rl.policy.PolicyWithLoss`'s.
policy_from_flax = dense_from_flax
