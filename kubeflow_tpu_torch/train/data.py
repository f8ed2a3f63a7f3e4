"""Synthetic input streams, made on the device.

Counterpart of `kubeflow_tpu/train/data.py`'s `_SyntheticStream` and
`SyntheticImages` and `SyntheticTokens`, with the same resumable-data protocol: ``state_dict``
(the number of batches yielded and the salt), ``load_state_dict``,
``perturb(salt)`` (new future batches, same position; ``None`` on a
fixed stream, whose every batch is the same), and ``vary_per_step``.
Batches are drawn on the device from an explicit `torch.Generator`
seeded from (seed, salt, position), so a position always yields the
same batch; the numbers differ from JAX's threefry draws. Tokens and
labels are int64, PyTorch's index type (JAX's are int32).

Not ported yet: ``rebind(mesh)`` (the multi-device layer, ROADMAP
Queue 1 item 12).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from kubeflow_tpu_torch._device import resolve_device


class _SyntheticStream:
    """Position/salt bookkeeping and the per-step-vs-fixed dispatch.
    Subclasses call `_init_stream` with `make(generator)`, which draws
    one batch."""

    def _init_stream(self, make, seed: int, vary_per_step: bool) -> None:
        self.vary_per_step = vary_per_step
        self._make, self._seed = make, seed
        self._position = 0
        self._salt = 0
        if not vary_per_step:
            # A fixed stream cannot honour perturb(): every position
            # yields the same batch, so callers see no perturb at all.
            self.perturb = None
            self.batch = self._batch_at(0, 0)

    def _batch_at(self, position: int, salt: int) -> dict:
        seed = np.random.SeedSequence([self._seed, salt, position])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
        return self._make(gen)

    def state_dict(self) -> dict:
        return {"position": self._position, "salt": self._salt}

    def load_state_dict(self, state: dict) -> None:
        self._position = int(state["position"])
        self._salt = int(state.get("salt", 0))

    def perturb(self, salt: int) -> None:
        """Reseed the future sequence without moving the position
        (divergence rollback's escape hatch)."""
        self._salt = int(salt)

    def __iter__(self) -> Iterator[dict]:
        while True:
            if self.vary_per_step:
                batch = self._batch_at(self._position, self._salt)
            else:
                batch = self.batch
            self._position += 1
            yield batch


class SyntheticImages(_SyntheticStream):
    """Synthetic image batches: NHWC images from a standard normal in
    `dtype`, and int64 labels in [0, num_classes), on `device`. The
    default yields one batch forever (device-throughput benchmarking);
    ``vary_per_step=True`` draws each batch from its position."""

    def __init__(
        self,
        batch_size: int,
        image_size: int = 224,
        num_classes: int = 1000,
        seed: int = 0,
        dtype=torch.float32,
        vary_per_step: bool = False,
        *,
        device=None,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = batch_size

        def make(gen):
            images = torch.randn(
                (batch_size, image_size, image_size, 3), generator=gen,
                device=self.device, dtype=dtype,
            )
            labels = torch.randint(0, num_classes, (batch_size,), generator=gen,
                                   device=self.device)
            return {"image": images, "label": labels}

        self._init_stream(make, seed, vary_per_step)


class SyntheticTokens(_SyntheticStream):
    """Synthetic LM batches: random token ids [B, S] and their
    next-token labels, both int64 on `device`."""

    def __init__(
        self,
        batch_size: int,
        seq_len: int,
        vocab_size: int,
        seed: int = 0,
        vary_per_step: bool = False,
        *,
        device=None,
    ):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.device = resolve_device(device)
        self.batch_size = batch_size

        def make(gen):
            tokens = torch.randint(
                0, vocab_size, (batch_size, seq_len + 1), generator=gen,
                device=self.device,
            )
            return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

        self._init_stream(make, seed, vary_per_step)
