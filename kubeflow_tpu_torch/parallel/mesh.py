"""The device mesh: dp × fsdp × sp.

Counterpart of `kubeflow_tpu/parallel/mesh.py`: the same axis names,
`MeshSpec` and its `resolve`, `mesh_spec_of`, `resize_spec` and
`local_mesh_spec` with JAX's error texts, and a `build_mesh` (and
`build_hybrid_mesh`) that lays a spec out either over the processes of
a `torch.distributed` job or, in a single process, as an in-process sp
ring on one device (`collectives.LocalRing`), the counterpart of XLA's
virtual host devices.

Over processes, the ranks are laid out row-major over (pp, dp, fsdp, sp,
ep, tp), as `init_device_mesh` lays them, so the sp ranks of one batch
shard are consecutive: rank r sits at dp ``r // (fsdp·sp)``, fsdp
``(r // sp) % fsdp`` and sp ``r % sp``. Each rank holds its process
groups for dp, fsdp and sp, for the batch (dp × fsdp: the ranks of one
sp position), for the replica (dp × sp: the ranks holding the same fsdp
shard) and for the world. In one process, fsdp, like dp, only sets how
many batch shards the input must divide into.

pp, ep and tp of more than 1 raise `NotImplementedError`: the pipeline,
expert and tensor parallel slices are ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.collectives import GroupRing, LocalRing

# Mesh axis names, slowest-varying (outermost, DCN-tolerant) first.
AXES: tuple[str, ...] = ("pp", "dp", "fsdp", "sp", "ep", "tp")

# Axes over which a *global data batch* is split. `sp` and `ep` shard
# activations (tokens within an example / experts), `tp` shards features,
# `pp` shards layers — none of those divide the batch.
BATCH_AXES: tuple[str, ...] = ("dp", "fsdp")

_PORTED_AXES = ("dp", "fsdp", "sp")
# The groups a process mesh holds besides one per axis: name -> the axes
# its ranks vary along.
_GROUPS = {"batch": BATCH_AXES, "replica": ("dp", "sp"), "world": AXES}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named parallelism layout.

    Each field is the size of one mesh axis. At most one axis may be -1,
    meaning "fill with all remaining devices" — the usual idiom is
    ``MeshSpec(fsdp=-1)`` for pure FSDP or ``MeshSpec(dp=-1)`` for pure DP.
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
    """A resolved layout: its shape, its sp ring, and over processes the
    rank layout and this rank's groups.

    ``shape`` maps every axis name to its size, as a `jax.sharding.Mesh`'s
    does; ``ring()`` is the sp ring the sequence-parallel attention
    rotates over; ``multiprocess`` says whether the positions are
    processes of a `torch.distributed` job or all live in this one.
    `axis(name)` is the collectives' axis object for a mesh axis or a
    group name ("batch", "replica", "world"), `index(name)` this rank's
    position along it (0 in one process); ``rank`` is this process's
    rank in the world (0 in one process)."""

    axis_names = AXES

    def __init__(self, spec: MeshSpec, sp_ring, *, ranks: np.ndarray | None = None,
                 groups: dict | None = None, rank: int = 0):
        self.shape = dict(zip(AXES, spec.sizes()))
        self._sp_ring = sp_ring
        self._groups = groups or {}
        self.rank = rank
        coords = np.argwhere(ranks == rank)[0] if ranks is not None else [0] * len(AXES)
        self._coords = dict(zip(AXES, (int(c) for c in coords)))

    @property
    def multiprocess(self) -> bool:
        return isinstance(self._sp_ring, GroupRing)

    def ring(self):
        return self._sp_ring

    def group(self, name: str):
        """This rank's process group along `name` (an axis or "batch",
        "replica", "world"); None in one process."""
        return self._groups.get(name)

    def axis(self, name: str):
        """The collectives' axis for `name`: a `GroupRing` over this rank's
        group, or in one process a `LocalRing` of the axis's size."""
        if self.multiprocess:
            return GroupRing(self._groups[name])
        axes = _GROUPS.get(name, (name,))
        return LocalRing(math.prod(self.shape[a] for a in axes))

    def index(self, name: str) -> int:
        """This rank's position along an axis, or along the batch axes for
        "batch" (dp-major over dp × fsdp)."""
        if name == "batch":
            return self._coords["dp"] * self.shape["fsdp"] + self._coords["fsdp"]
        return self._coords[name]

    def __repr__(self) -> str:
        sizes = {a: s for a, s in self.shape.items() if s > 1}
        return f"Mesh({sizes or {'dp': 1}}, ring={self._sp_ring!r})"


def _refuse_unported(spec: MeshSpec) -> None:
    others = {a: s for a, s in zip(AXES, spec.sizes())
              if a not in _PORTED_AXES and s != 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {others}: dp, fsdp and sp are ported; pp, ep and tp are "
            "ROADMAP Queue 1 item 12"
        )


def _lines(ranks: np.ndarray, axes: tuple[str, ...]) -> list[list[int]]:
    """The rank groups of `ranks` that vary along `axes`: one per setting
    of the other axes, each in mesh order."""
    vary = [AXES.index(a) for a in axes]
    keep = [i for i in range(len(AXES)) if i not in vary]
    moved = np.transpose(ranks, keep + vary)
    return moved.reshape(-1, math.prod(ranks.shape[i] for i in vary)).tolist()


def _process_mesh(spec: MeshSpec, ranks: np.ndarray) -> Mesh:
    """The `Mesh` of this rank over `ranks` (the world's ranks in mesh
    order): every group of every kind is made on every rank, in one
    order, as `new_group` requires, with the gang's timeout."""
    from kubeflow_tpu_torch.parallel.distributed import group_timeout

    rank = dist.get_rank()
    kinds = {**{a: (a,) for a in _PORTED_AXES}, **_GROUPS}
    groups = {}
    for name, axes in kinds.items():
        for line in _lines(ranks, axes):
            if line != sorted(line):
                # A group's ranks number its members in ascending order;
                # a position along the axis must be that number.
                raise NotImplementedError(f"{name} group {line} is not in rank order")
            group = dist.new_group(line, timeout=group_timeout())
            if rank in line:
                groups[name] = group
    return Mesh(spec, GroupRing(groups["sp"]), ranks=ranks, groups=groups, rank=rank)


def build_mesh(spec: MeshSpec | None = None, *, n_devices: int | None = None) -> Mesh:
    """Lay `spec` (default ``MeshSpec(dp=-1)``) out as a `Mesh`.

    Under an initialized `torch.distributed` job, over its processes:
    the spec resolves against the world size and the ranks lie row-major
    in mesh order; each process then holds one position of its sp ring
    and of each other group. In a single process, the whole sp ring lives
    here on one device (`LocalRing`); the spec resolves against
    `n_devices`, by default its fixed axes' product (a -1 axis becomes
    1), and dp and fsdp only set how many batch shards the ring's input
    must divide into."""
    spec = spec or MeshSpec(dp=-1)
    if dist.is_available() and dist.is_initialized():
        spec = spec.resolve(dist.get_world_size())
        _refuse_unported(spec)
        return _process_mesh(spec, np.arange(dist.get_world_size()).reshape(spec.sizes()))
    if n_devices is None:
        n_devices = math.prod(s for s in spec.sizes() if s != -1)
    spec = spec.resolve(n_devices)
    _refuse_unported(spec)
    return Mesh(spec, LocalRing(spec.sp))


def build_hybrid_mesh(ici: MeshSpec, dcn: MeshSpec, *, n_devices: int | None = None) -> Mesh:
    """Multi-slice mesh: `ici` axes laid out inside each slice, `dcn` axes
    spanning slices (JAX's `build_hybrid_mesh`); each axis's size is
    ici_axis * dcn_axis, so models address the combined axis by its
    usual name. Put dp (or pp) across slices, never sp.

    The slices are consecutive rank groups: with TPUJOB_NUM_SLICES = k,
    the gang's n ranks are k slices of n / k, as the TpuJob operator
    numbers them (slice_id = process_id // (n / k)); the dcn axes' product
    must be k. Within a slice the ranks lie row-major over the ici
    axes; each combined axis puts the dcn coordinate outside the ici one,
    as JAX's virtual-slice layout does. In one process the combined spec
    is laid out as `build_mesh` lays it."""
    if any(s == -1 for s in dcn.sizes()):
        raise ValueError("dcn axes must be explicit (no -1): slice count "
                         "is physical, not inferred")
    n_slices = math.prod(dcn.sizes())
    multiprocess = dist.is_available() and dist.is_initialized()
    if n_devices is None:
        n_devices = (dist.get_world_size() if multiprocess
                     else n_slices * math.prod(s for s in ici.sizes() if s != -1))
    if n_slices < 1 or n_devices % n_slices:
        raise ValueError(f"{n_devices} devices not divisible into {n_slices} slices")
    if multiprocess:
        from kubeflow_tpu_torch.parallel.distributed import ProcessEnv

        pe = ProcessEnv.from_env()
        if pe.num_slices != n_slices:
            raise ValueError(
                f"dcn axes {dict(zip(AXES, dcn.sizes()))} make {n_slices} slices, "
                f"the gang has {pe.num_slices} (TPUJOB_NUM_SLICES)")
    per_slice = n_devices // n_slices
    ici = ici.resolve(per_slice)
    sizes = tuple(i * d for i, d in zip(ici.sizes(), dcn.sizes()))
    spec = MeshSpec(**dict(zip(AXES, sizes)))
    _refuse_unported(spec)
    if not multiprocess:
        return Mesh(spec, LocalRing(spec.sp))
    outer = np.arange(n_devices).reshape(*dcn.sizes(), *ici.sizes())
    k = len(AXES)
    order: list[int] = []
    for axis in range(k):
        order += [axis, k + axis]
    return _process_mesh(spec, outer.transpose(order).reshape(sizes))


def mesh_spec_of(mesh: Mesh) -> MeshSpec:
    """The `MeshSpec` a mesh realizes (axis name -> axis size)."""
    return MeshSpec(**{a: int(mesh.shape.get(a, 1)) for a in AXES})


def resize_spec(
    spec: MeshSpec,
    new_dp: int,
    *,
    n_devices: int | None = None,
    global_batch: int | None = None,
) -> MeshSpec:
    """The elastic-resize target layout: `spec` with its dp axis set to
    `new_dp`, every other axis unchanged — validated with the divisor
    math spelled out, as JAX's: the resized mesh needs ``new_dp *
    (pp*fsdp*sp*ep*tp)`` devices, which must not exceed what survives;
    the global batch is sharded over ``new_dp * fsdp`` batch shards, so
    it must divide evenly (a resize keeps the global batch)."""
    if new_dp < 1:
        raise ValueError(f"resize target dp must be >= 1, got {new_dp}")
    others = {a: s for a, s in zip(AXES, spec.sizes()) if a != "dp"}
    if any(s < 1 for s in others.values()):
        raise ValueError(
            f"resize requires a fully-resolved spec (no -1 axes): {spec}"
        )
    model_axes = math.prod(others.values())
    need = new_dp * model_axes
    if n_devices is not None and need > n_devices:
        factors = " * ".join(f"{a}={s}" for a, s in others.items() if s > 1)
        raise ValueError(
            f"resize to dp={new_dp} needs dp={new_dp}"
            + (f" * {factors}" if factors else "")
            + f" = {need} devices, but only {n_devices} "
            f"survive — shrink dp to at most {n_devices // max(1, model_axes)}"
        )
    batch_shards = new_dp * spec.fsdp
    if global_batch is not None and global_batch % batch_shards:
        divisors = sorted(
            d for d in range(1, global_batch + 1)
            if global_batch % (d * spec.fsdp) == 0
        )
        raise ValueError(
            f"resize to dp={new_dp} cannot shard the global batch: "
            f"{global_batch} examples over dp={new_dp} * fsdp={spec.fsdp} "
            f"= {batch_shards} batch shards leaves "
            f"{global_batch % batch_shards} examples over — elastic "
            f"resize keeps the global batch fixed, so dp must satisfy "
            f"dp * {spec.fsdp} | {global_batch} (valid dp: {divisors})"
        )
    return dataclasses.replace(spec, dp=new_dp)


def local_mesh_spec(n_devices: int | None = None, tp: int = 1, sp: int = 1) -> MeshSpec:
    """Convenience: FSDP over everything not claimed by tp/sp. The device
    count defaults to the gang's processes (1 without one)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    n = n_devices
    if n % (tp * sp):
        raise ValueError(f"{n} devices not divisible by tp={tp} * sp={sp}")
    return MeshSpec(fsdp=n // (tp * sp), sp=sp, tp=tp)
