"""The device mesh: dp × sp.

Counterpart of `kubeflow_tpu/parallel/mesh.py`: the same axis names,
`MeshSpec` and its `resolve`, and a `build_mesh` that lays a spec out
either over the processes of a `torch.distributed` job (ranks laid out
row-major over (dp, sp), as `init_device_mesh` does, so the sp ranks of
one dp row are consecutive) or, in a single process, as an in-process
sp ring on one device (`collectives.LocalRing`), the counterpart of
XLA's virtual host devices.

Only dp and sp are ported. pp, fsdp, ep and tp of more than 1 raise
`NotImplementedError` (ROADMAP Queue 1 item 12), as do
`build_hybrid_mesh`, `mesh_spec_of`, `resize_spec` and
`local_mesh_spec`, which are not here.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from kubeflow_tpu_torch.parallel.collectives import GroupRing, LocalRing

# Mesh axis names, slowest-varying (outermost, DCN-tolerant) first.
AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "sp", "ep", "tp")

# Axes over which a *global data batch* is split. `sp` and `ep` shard
# activations (tokens within an example / experts), `tp` shards features,
# `pp` shards layers — none of those divide the batch.
BATCH_AXES: tuple[str, ...] = ("dp", "fsdp")

_PORTED_AXES = ("dp", "sp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named parallelism layout.

    Each field is the size of one mesh axis. At most one axis may be -1,
    meaning "fill with all remaining devices" — the usual idiom is
    ``MeshSpec(dp=-1)`` for pure DP.
    """

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def sizes(self) -> tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXES)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Resolve a single -1 axis against the device count and validate."""
        sizes = list(self.sizes())
        if any(s < 1 and s != -1 for s in sizes):
            raise ValueError(f"mesh axis sizes must be >= 1 (or -1 to infer): {self}")
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {self}")
        if wild:
            fixed = math.prod(s for s in sizes if s != -1)
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes of {self}"
                )
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes) != n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXES, sizes))} needs {math.prod(sizes)} devices, "
                f"have {n_devices}"
            )
        return MeshSpec(**dict(zip(AXES, sizes)))

    @property
    def data_parallelism(self) -> int:
        return self.dp * self.fsdp


class Mesh:
    """A resolved dp × sp layout and its sp ring.

    ``shape`` maps every axis name to its size, as a `jax.sharding.Mesh`'s
    does; ``ring()`` is the sp ring the sequence-parallel attention
    rotates over; ``multiprocess`` says whether the positions are
    processes of a `torch.distributed` job or all live in this one."""

    axis_names = AXES

    def __init__(self, spec: MeshSpec, sp_ring):
        self.shape = dict(zip(AXES, spec.sizes()))
        self._sp_ring = sp_ring

    @property
    def multiprocess(self) -> bool:
        return isinstance(self._sp_ring, GroupRing)

    def ring(self):
        return self._sp_ring

    def __repr__(self) -> str:
        sizes = {a: s for a, s in self.shape.items() if s > 1}
        return f"Mesh({sizes or {'dp': 1}}, ring={self._sp_ring!r})"


def _refuse_unported(spec: MeshSpec) -> None:
    others = {a: s for a, s in zip(AXES, spec.sizes())
              if a not in _PORTED_AXES and s != 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others}: only dp and sp are ported; pp, fsdp, ep "
            "and tp are ROADMAP Queue 1 item 12"
        )


def build_mesh(spec: MeshSpec | None = None, *, n_devices: int | None = None) -> Mesh:
    """Lay `spec` (default ``MeshSpec(dp=-1)``) out as a `Mesh`.

    Under an initialized `torch.distributed` job, over its processes:
    the spec resolves against the world size, and `init_device_mesh`
    builds the (dp, sp) groups on the backend's device type (NCCL:
    cuda, gloo: cpu); each process then holds one position of its sp
    ring. In a single process, the whole sp ring lives here on one
    device (`LocalRing`); the spec resolves against `n_devices`, by
    default its fixed axes' product (a -1 axis becomes 1), and dp only
    sets how many batch shards the ring's input must divide into."""
    spec = spec or MeshSpec(dp=-1)
    if dist.is_available() and dist.is_initialized():
        spec = spec.resolve(dist.get_world_size())
        _refuse_unported(spec)
        from torch.distributed.device_mesh import init_device_mesh

        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(
            device_type, (spec.dp, spec.sp), mesh_dim_names=("dp", "sp")
        )
        return Mesh(spec, GroupRing(device_mesh.get_group("sp")))
    if n_devices is None:
        n_devices = math.prod(s for s in spec.sizes() if s != -1)
    spec = spec.resolve(n_devices)
    _refuse_unported(spec)
    return Mesh(spec, LocalRing(spec.sp))
