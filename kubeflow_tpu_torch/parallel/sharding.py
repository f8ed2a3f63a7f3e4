"""Batch-axis helpers.

Counterpart of `batch_axes` in `kubeflow_tpu/parallel/sharding.py`. The
rest of that module (logical rules, NamedShardings, pytree placement)
waits for the tensor- and FSDP-parallel port (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES


def batch_axes(mesh) -> tuple[str, ...]:
    """The batch axes present in `mesh`, in BATCH_AXES order."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)
