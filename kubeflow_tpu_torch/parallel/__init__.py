"""Parallelism: the dp × fsdp × sp mesh, the collectives over its axes,
the sharding rules, and the process bootstrap. Tensor, pipeline and
expert parallelism are not ported yet (ROADMAP Queue 1 item 12)."""

import importlib

# Name -> submodule, imported at first use: the operator imports
# `parallel.distributed` (ProcessEnv) in control-plane processes, which
# must not load torch through the mesh and the collectives.
_EXPORTS = {
    "GroupRing": "collectives", "LocalRing": "collectives",
    "ProcessEnv": "distributed", "initialize_from_env": "distributed",
    "AXES": "mesh", "BATCH_AXES": "mesh", "Mesh": "mesh", "MeshSpec": "mesh",
    "build_mesh": "mesh", "build_hybrid_mesh": "mesh", "local_mesh_spec": "mesh",
    "mesh_spec_of": "mesh", "resize_spec": "mesh",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AXES",
    "BATCH_AXES",
    "GroupRing",
    "LocalRing",
    "Mesh",
    "MeshSpec",
    "ProcessEnv",
    "build_hybrid_mesh",
    "build_mesh",
    "initialize_from_env",
    "local_mesh_spec",
    "mesh_spec_of",
    "resize_spec",
]
