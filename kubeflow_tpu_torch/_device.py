"""The port's device rule, in one place.

Entry points (`TransformerLM`, `init_params`, `Servable`) run on CUDA
unless the caller names another device. Without a GPU and without an
explicit device they raise: the port never carries on quietly on the
CPU, where every number it produced would be a CPU number.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`device` as a `torch.device`; None means CUDA, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'"
        )
    return torch.device("cuda")
