"""Logical-axis sharding rules, batch shards and parameter placement.

Counterpart of `kubeflow_tpu/parallel/sharding.py`. Models name each
parameter's dimensions with logical axes ("embed", "mlp", "heads", ...;
`TransformerLM.logical_axes`, `ResNet.logical_axes`), and a rules table
maps logical names to mesh axes (`default_rules`), so changing the
layout is a rules change, never a model change. Where JAX turns the
result into `NamedSharding`s for one jitted program, the port's
processes act on it themselves: `batch_sharding` gives the rows of the
global batch a rank holds, and `placement` the dimension of each
parameter that is split over fsdp (the counterpart of
`apply_logical_annotations`), which the trainer shards its ZeRO-3 state
along.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Sequence

from kubeflow_tpu_torch.parallel.mesh import BATCH_AXES

# logical name -> mesh axis (or tuple of mesh axes, or None for replicated)
LogicalRules = Mapping[str, Any]


class PartitionSpec(tuple):
    """A tuple of mesh axes (or None, or a tuple of axes) per tensor
    dimension, trailing Nones trimmed: `jax.sharding.PartitionSpec`'s
    value."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def default_rules(*, fsdp_params: bool = True) -> dict[str, Any]:
    """Rules for the standard DP/FSDP × TP × SP layout, JAX's table.

    With ``fsdp_params=True`` the embed dimension of every weight (and a
    conv's output channels) is sharded over the fsdp axis (ZeRO-3).
    Attention heads and MLP hidden ride tp; activation sequence rides sp,
    batch rides dp×fsdp."""
    return {
        # activations
        "batch": BATCH_AXES,
        "seq": "sp",
        "act_embed": None,
        "act_heads": "tp",
        # parameters
        "embed": "fsdp" if fsdp_params else None,
        "mlp": "tp",
        "heads": "tp",
        "kv": None,
        "qkv_embed": "fsdp" if fsdp_params else None,
        "vocab": "tp",
        "expert": "ep",
        # conv / vision parameters: shard the output-channel dim over fsdp
        "conv_out": "fsdp" if fsdp_params else None,
        "conv_in": None,
        "spatial": None,
        # scalars / norms
        "norm": None,
        "stage": "pp",
    }


def spec_for(names: Sequence[str | None], rules: LogicalRules) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec."""
    parts = []
    for name in names:
        if name is None:
            parts.append(None)
        else:
            if name not in rules:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            parts.append(rules[name])
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def batch_axes(mesh) -> tuple[str, ...]:
    """The batch axes present in `mesh`, in BATCH_AXES order."""
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def batch_shard_count(mesh) -> int:
    """How many shards the leading (example) axis of a global batch is
    split into on `mesh`: the product of the batch-axis sizes, the
    divisibility contract every batch consumer validates against."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def batch_sharding(mesh, batch: int) -> slice:
    """The rows of a global batch of `batch` examples this rank holds:
    the batch split evenly over the batch shards, shard i the i-th block
    (JAX's dim-0 sharding over dp × fsdp). All rows in one process."""
    shards = batch_shard_count(mesh)
    if batch % shards:
        raise ValueError(
            f"global batch {batch} does not divide into {shards} batch shards "
            f"(dp × fsdp of {dict(mesh.shape)})")
    if not getattr(mesh, "multiprocess", False):
        return slice(0, batch)
    rows = batch // shards
    i = mesh.index("batch")
    return slice(i * rows, (i + 1) * rows)


def sequence_sharding(mesh, seq: int) -> slice:
    """The positions of a sequence of `seq` tokens this rank holds: its
    chunk of the sp ring on a process mesh, all of them otherwise."""
    if not getattr(mesh, "multiprocess", False) or mesh.shape["sp"] == 1:
        return slice(0, seq)
    sp = mesh.shape["sp"]
    if seq % sp:
        raise ValueError(f"sequence {seq} does not split over sp={sp}")
    c = seq // sp
    i = mesh.index("sp")
    return slice(i * c, (i + 1) * c)


def local_batch(mesh, batch: dict, *, seq_keys: Sequence[str] = ()) -> dict:
    """This rank's part of a global batch dict: its rows of every entry,
    and of the entries named in `seq_keys` its sp chunk of dim 1."""
    out = {}
    for key, x in batch.items():
        x = x[batch_sharding(mesh, x.shape[0])]
        if key in seq_keys:
            x = x[:, sequence_sharding(mesh, x.shape[1])]
        out[key] = x
    return out


class Placement(NamedTuple):
    """Where one tensor lives on a process mesh: ``dim`` split into
    ``count`` equal pieces over the fsdp axis, this rank holding piece
    ``index`` (dim None: replicated)."""

    dim: int | None = None
    count: int = 1
    index: int = 0

    def local_shape(self, shape: Sequence[int]) -> tuple:
        shape = tuple(shape)
        if self.dim is None:
            return shape
        return shape[:self.dim] + (shape[self.dim] // self.count,) + shape[self.dim + 1:]

    def take(self, x):
        """This rank's piece of the whole tensor `x`."""
        if self.dim is None:
            return x
        n = x.shape[self.dim] // self.count
        return x.narrow(self.dim, self.index * n, n)


REPLICATED = Placement()


def placement(mesh, names: Sequence[str | None], rules: LogicalRules,
              shape: Sequence[int], what: str = "tensor") -> Placement:
    """The fsdp split of a tensor whose dimensions carry the logical
    `names`, on `mesh` under `rules`: the dimension whose rule is "fsdp"
    when that axis is larger than 1 (its size must divide evenly), else
    replicated. In one process everything is replicated: fsdp only sets
    the batch shards there. The counterpart of
    `apply_logical_annotations`."""
    spec = spec_for(names, rules)
    fsdp = mesh.shape["fsdp"] if getattr(mesh, "multiprocess", False) else 1
    dims = [d for d, part in enumerate(spec)
            if part == "fsdp" or (isinstance(part, tuple) and "fsdp" in part)]
    if fsdp == 1 or not dims:
        return REPLICATED
    if len(dims) > 1:
        raise ValueError(f"{what}: {spec} splits {len(dims)} dims over fsdp")
    dim = dims[0]
    if shape[dim] % fsdp:
        raise ValueError(
            f"{what}: dim {dim} of {tuple(shape)} ({names[dim]}) does not split "
            f"over fsdp={fsdp}")
    return Placement(dim, fsdp, mesh.index("fsdp"))
