"""Attention ops: the dense oracle, the flash kernels with their plain
versions (`ops/flash.py`, `ops/csrc/`), and ring (sequence-parallel)
attention over a mesh's sp axis."""

from kubeflow_tpu_torch.ops.attention import dense_attention, ring_attention
from kubeflow_tpu_torch.ops.flash import flash_attention, flash_usable, ring_flash_attention

__all__ = [
    "dense_attention",
    "flash_attention",
    "flash_usable",
    "ring_attention",
    "ring_flash_attention",
]
