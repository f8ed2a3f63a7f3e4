"""A TpuJob worker that joins its gang and checks one collective.

Counterpart of the JAX package's ``tests/e2e/gang_worker.py``: the
process joins the gang through the TPUJOB_* contract
(`parallel/distributed.initialize_from_env`, on the device KFTPU_DEVICE
names), builds a dp mesh over the gang's processes and sums each rank's
``rank + 1`` over dp; every rank must read 1 + 2 + ... + n. It prints
``rank <r>: psum ok (<total>)`` and exits 0.

    python -m kubeflow_tpu_torch.testing.workers.gang_worker
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    import torch

    from kubeflow_tpu_torch.parallel import MeshSpec, build_mesh, initialize_from_env
    from kubeflow_tpu_torch.parallel import collectives, distributed

    pe = initialize_from_env(device=os.environ.get("KFTPU_DEVICE") or None)
    assert torch.distributed.get_world_size() == pe.num_processes
    mesh = build_mesh(MeshSpec(dp=-1))
    device = distributed.started().get("device") or os.environ.get("KFTPU_DEVICE") or "cuda"
    x = torch.full((1, 1), float(pe.process_id + 1), device=device)
    total = float(collectives.psum(x, mesh.axis("dp"))[0, 0])
    expected = sum(range(1, pe.num_processes + 1))
    assert total == expected, (total, expected)
    print(f"rank {pe.process_id}: psum ok ({total})", flush=True)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
