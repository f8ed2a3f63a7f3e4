"""Attention ops: the dense oracle and the flash kernel with its plain
version (`ops/flash.py`, `ops/csrc/`)."""

from kubeflow_tpu_torch.ops.attention import dense_attention
from kubeflow_tpu_torch.ops.flash import flash_attention, flash_usable

__all__ = ["dense_attention", "flash_attention", "flash_usable"]
