"""Servable: a loaded model behind a bucketed predict function.

Counterpart of `kubeflow_tpu/serving/servable.py`. The JAX servable
pads requests to power-of-two batch buckets so XLA compiles one program
per bucket. PyTorch compiles nothing, but the buckets stay: they bound
the set of batch shapes the device sees (and that `warmup_with` has
exercised before traffic arrives), and they keep predictions identical
to the JAX server's, padding included. Weights are placed on the device
once; a request moves only its own batch. Requests above ``max_batch``
are split into chunks and re-batched through the same buckets. A
module is served in eval mode (a ResNet's BatchNorm normalises by its
running statistics, as JAX's serves with ``train=False``).

`from_checkpoint` restores the parameters and batch statistics that
`train.fit` saved (the port's `Checkpointer`; orbax checkpoints of the
JAX package are not read) and serves them as the checkpoint's step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device
from kubeflow_tpu_torch.train.checkpoint import Checkpointer
from kubeflow_tpu_torch.train.trainer import TensorSpec, batch_stats, map_tensors


def _buckets(max_batch: int) -> list[int]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _place(variables, device: torch.device):
    """A module (in eval mode) or a dict of tensors, on `device`."""
    if isinstance(variables, torch.nn.Module):
        return variables.to(device).eval()
    return {k: v.to(device) for k, v in variables.items()}


@dataclasses.dataclass
class Servable:
    """One model version the server can execute.

    ``apply_fn(variables, batch)`` maps a batch tensor on `device` to a
    tensor whose first axis is the batch; `variables` is the module, or
    a dict of its tensors, moved to `device` once at construction.
    `device` defaults to CUDA (`_device.resolve_device`)."""

    name: str
    apply_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    variables: Any
    version: int = 1
    max_batch: int = 64
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.variables = _place(self.variables, self.device)
        self._bucket_sizes = _buckets(self.max_batch)

    @classmethod
    def from_module(
        cls,
        name: str,
        module: torch.nn.Module,
        *,
        version: int = 1,
        max_batch: int = 64,
        warmup_example=None,
        device=None,
    ) -> "Servable":
        """Wrap a module (``module(batch)``) as a servable, in eval mode;
        the module carries its own weights. Pass ``warmup_example`` (one
        instance, no batch dim) to run every bucket before traffic."""
        module.eval()
        servable = cls(
            name, lambda module, batch: module(batch), module, version=version,
            max_batch=max_batch, device=device,
        )
        if warmup_example is not None:
            servable.warmup_with(warmup_example)
        return servable

    @classmethod
    def from_checkpoint(
        cls,
        name: str,
        module: torch.nn.Module,
        ckpt_dir,
        example_input,
        *,
        max_batch: int = 64,
        device=None,
        step: int | None = None,
    ) -> "Servable":
        """Restore `module`'s parameters and batch statistics from the
        newest valid step of a checkpoint directory that the training
        loop (`train.fit`) wrote, opened read-only (the optimizer's file
        is not loaded); with `step`, from that step while the directory
        holds it valid. The version is the checkpoint's step (at least
        1), so clients see which step is live; every bucket is warmed
        with ``example_input[0]`` before this returns."""
        template = {"params": dict(module.named_parameters())}
        stats = batch_stats(module)
        if stats:
            template["batch_stats"] = stats
        live = template
        template = map_tensors(
            lambda t: TensorSpec(tuple(t.shape), t.dtype, t.device), template)
        # read_only: serving never renames a training run's steps.
        ckpt = Checkpointer(ckpt_dir, read_only=True)
        try:
            restored = ckpt.restore_latest(template, prefer_step=step)
        finally:
            ckpt.close()
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        with torch.no_grad():
            for key, tensors in live.items():
                for tname, t in tensors.items():
                    t.copy_(restored.state[key][tname])
        return cls.from_module(
            name, module, version=max(restored.step, 1), max_batch=max_batch,
            warmup_example=np.asarray(example_input)[0], device=device,
        )

    def _bucket_for(self, n: int) -> int:
        for b in self._bucket_sizes:
            if n <= b:
                return b
        return self.max_batch

    def _run(self, batch: np.ndarray) -> np.ndarray:
        # inference_mode is thread-local, and the threaded HTTP server
        # calls predict from many threads: enter it here, per call.
        with torch.inference_mode():
            out = self.apply_fn(
                self.variables, torch.tensor(batch, device=self.device)
            )
            if out.dtype == torch.bfloat16:  # numpy has no bfloat16
                out = out.float()
            return out.cpu().numpy()

    def predict(self, instances: Sequence) -> np.ndarray:
        """Run inference on a list of instances (one array-like each).

        Pads to the nearest bucket, runs, slices the padding back off.
        Oversized requests are chunked at max_batch."""
        batch = np.asarray(instances)
        if batch.shape[0] == 0:
            raise ValueError("empty instances")
        if batch.shape[0] > self.max_batch:
            parts = [
                self.predict(batch[i : i + self.max_batch])
                for i in range(0, batch.shape[0], self.max_batch)
            ]
            return np.concatenate(parts, axis=0)
        n = batch.shape[0]
        bucket = self._bucket_for(n)
        if bucket != n:
            pad = np.zeros((bucket - n, *batch.shape[1:]), batch.dtype)
            batch = np.concatenate([batch, pad], axis=0)
        return self._run(batch)[:n]

    def warmup_with(self, example_instance) -> None:
        """Run every bucket once before serving traffic, so first-call
        costs (kernel build, allocator growth) never land on a request."""
        one = np.asarray(example_instance)[None]
        for b in self._bucket_sizes:
            self._run(np.repeat(one, b, axis=0))
