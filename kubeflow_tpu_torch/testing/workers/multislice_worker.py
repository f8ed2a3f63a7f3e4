"""A TpuJob worker of a two-slice gang that checks the hybrid mesh.

Counterpart of the JAX package's ``tests/e2e/multislice_worker.py``: a
2-slice x 2-process TpuJob whose members build a hybrid mesh, dp split
across slices (the dcn axis) and within each (the ici axis), and agree
on a global sum and mean over it. The operator's TPUJOB_NUM_SLICES and
TPUJOB_SLICE_ID must say which slice a process is in (consecutive
ranks); libtpu's MEGASCALE_* variables have no counterpart here. Prints
``rank <r> (slice <s>): hybrid psum ok (<total>)``.

    python -m kubeflow_tpu_torch.testing.workers.multislice_worker
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    import torch

    from kubeflow_tpu_torch.parallel import MeshSpec, build_hybrid_mesh, initialize_from_env
    from kubeflow_tpu_torch.parallel import collectives, distributed

    pe = initialize_from_env(device=os.environ.get("KFTPU_DEVICE") or None)
    assert pe.num_slices == 2, pe
    assert pe.slice_id == pe.process_id // (pe.num_processes // pe.num_slices)
    # dp = 2 (across slices) x 2 (within each) = 4 global.
    mesh = build_hybrid_mesh(MeshSpec(dp=-1), MeshSpec(dp=2))
    assert mesh.shape["dp"] == 4, mesh.shape
    # The dp index is the slice boundary's: slice s holds dp 2s and 2s + 1.
    assert mesh.index("dp") // 2 == pe.slice_id, (mesh.index("dp"), pe)
    device = distributed.started().get("device") or os.environ.get("KFTPU_DEVICE") or "cuda"
    x = torch.full((1, 1), float(pe.process_id + 1), device=device)
    total = float(collectives.psum(x, mesh.axis("dp"))[0, 0])
    expected = float(sum(range(1, pe.num_processes + 1)))
    assert total == expected, (total, expected)
    mean = float(collectives.pmean(x, mesh.axis("dp"))[0, 0])
    assert abs(mean - expected / pe.num_processes) < 1e-6
    print(f"rank {pe.process_id} (slice {pe.slice_id}): hybrid psum ok ({total})",
          flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
