"""Parallelism: the dp × sp mesh, the sp ring's collectives, and the
process bootstrap. Tensor, FSDP, pipeline and expert parallelism are
not ported yet (ROADMAP Queue 1 item 12)."""

from kubeflow_tpu_torch.parallel.collectives import GroupRing, LocalRing
from kubeflow_tpu_torch.parallel.distributed import ProcessEnv, initialize_from_env
from kubeflow_tpu_torch.parallel.mesh import AXES, BATCH_AXES, Mesh, MeshSpec, build_mesh

__all__ = [
    "AXES",
    "BATCH_AXES",
    "GroupRing",
    "LocalRing",
    "Mesh",
    "MeshSpec",
    "ProcessEnv",
    "build_mesh",
    "initialize_from_env",
]
