"""Collectives over a mesh axis: the sp ring, dp, fsdp and the batch axes.

Counterpart of `kubeflow_tpu/parallel/collectives.py` (`axis_size`,
`axis_index`, `ppermute_ring`, `psum`, `pmean`, `all_gather`,
`reduce_scatter`, `all_to_all`). There a
collective names a mesh axis inside `shard_map`, and every device runs
the body on its own shard. Here the axis is an object, of one of two
kinds (`parallel/mesh.Mesh.axis` gives either):

- `LocalRing(n)`: all n positions of the axis in this process, on one
  device — the counterpart of XLA's virtual host devices, on which the
  JAX package's own ring tests run. A tensor carries a leading dimension
  of the n positions, and a rotation is a roll along it.
- `GroupRing(group)`: one position per process of a `torch.distributed`
  group (gloo on the CPU, NCCL on GPUs, or gloo with CUDA tensors,
  `parallel/distributed.choose_backend`). The leading dimension has size
  1, and a rotation is one send/receive pair, posted together with
  `batch_isend_irecv` so that NCCL sees both sides.

Ring code is written once over that leading dimension of R local
positions, with their ids in `ring.ranks`: `ops/attention.ring_attention`
and `ops/flash.ring_flash_attention` run the same body on both kinds. No
thread per position and no barrier inside autograd is involved, so the
backward of a ring cannot deadlock on the autograd engine's device
threads. Every collective is differentiable, its backward the transpose
JAX's gives it: psum ↔ psum, pmean ↔ pmean, all_gather ↔ reduce_scatter,
all_to_all ↔ all_to_all with the split and concat axes swapped. The
axes of `all_gather`, `reduce_scatter` and `all_to_all` count in one
position's tensor (after the leading dimension), as JAX's count in one
device's shard.

The `group_*` functions are the same collectives on plain tensors over
a process group, without autograd: the trainer reduces gradients and
gathers parameters with them. On a gloo group with CUDA tensors (two
ranks sharing a card), gloo's all_reduce, broadcast,
all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single
take the tensors as they are (measured on an H100 host, torch 2.11);
its send/recv hands the device pointer to the socket and the process
aborts in writev, so there the ring's rotation copies its tensor to
host memory, rotates it, and copies the result back. That is the
rotation's body on that layout, not a handler of a failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class LocalRing:
    """Every position of an sp ring of `size`, in this process."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size
        self.ranks = tuple(range(size))

    def sequence_offset(self, local_len: int) -> int:
        """The global position of the first token this process holds: it
        holds the whole sequence."""
        del local_len
        return 0

    def _rotate(self, x, shift: int):
        return torch.roll(x, shift, dims=0)

    def _sum(self, x):
        return x.sum(0, keepdim=True).expand_as(x)

    def __repr__(self) -> str:
        return f"LocalRing(size={self.size})"


class GroupRing:
    """This process's position on a ring of `torch.distributed` ranks
    (`group`, or the default group)."""

    def __init__(self, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def sequence_offset(self, local_len: int) -> int:
        """The global position of the first token of this rank's chunk."""
        return self.ranks[0] * local_len

    def _peer(self, shift: int) -> int:
        return dist.get_global_rank(self.group, (self.ranks[0] + shift) % self.size)

    def _rotate(self, x, shift: int):
        if self.size == 1:
            return x
        if x.is_cuda and dist.get_backend(self.group) == "gloo":
            # gloo's send/recv takes host tensors only (module docstring).
            return self._rotate(x.to("cpu"), shift).to(x.device)
        x = x.contiguous()
        out = torch.empty_like(x)
        ops = [
            dist.P2POp(dist.isend, x, self._peer(shift), self.group),
            dist.P2POp(dist.irecv, out, self._peer(-shift), self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def _sum(self, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def __repr__(self) -> str:
        return f"GroupRing(size={self.size}, rank={self.ranks[0]})"


class _GroupRotate(torch.autograd.Function):
    """A process-group rotation; its transpose rotates the other way."""

    @staticmethod
    def forward(ctx, x, ring, shift):
        ctx.ring, ctx.shift = ring, shift
        return ring._rotate(x, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ring._rotate(grad, -ctx.shift), None, None


class _GroupSum(torch.autograd.Function):
    """A process-group sum; its transpose is the same sum."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring._sum(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ring._sum(grad), None


def axis_size(ring) -> int:
    """The number of positions on the ring."""
    return ring.size


def axis_index(ring, device=None) -> torch.Tensor:
    """The ids of the ring positions this process holds, [R] int64 —
    every id on a `LocalRing`, this rank's on a `GroupRing`."""
    return torch.tensor(ring.ranks, dtype=torch.int64, device=device)


def ppermute_ring(x, ring, *, shift: int = 1):
    """Rotate x [R, ...] around the ring: position i's slice goes to
    position (i + shift) % n, the direction of JAX's
    `ppermute_ring` and of ring attention's hop."""
    if isinstance(ring, GroupRing):
        return _GroupRotate.apply(x, ring, shift)
    return ring._rotate(x, shift)


def psum(x, ring):
    """x [R, ...] summed over all positions of the ring; every position
    gets the sum."""
    if isinstance(ring, GroupRing):
        return _GroupSum.apply(x, ring)
    return ring._sum(x)


# -- tensor collectives over a process group (no autograd) -------------------


def group_all_reduce(x, group, op: str = "sum"):
    """x summed (``op="sum"``), or its max or min, over the group's ranks,
    in a new tensor."""
    out = x.contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return out


def group_all_gather(x, group, dim: int = 0):
    """The ranks' x concatenated along `dim`, in rank order (tiled)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((n * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def group_reduce_scatter(x, group, dim: int = 0):
    """x summed over the group's ranks, then this rank's 1/n slice along
    `dim`."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def group_all_to_all(x, group, split_axis: int, concat_axis: int):
    """x cut into n pieces along `split_axis`, piece j sent to rank j; the
    pieces received concatenated along `concat_axis` in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[split_axis] % n:
        raise ValueError(
            f"dim {split_axis} of {tuple(x.shape)} does not split over {n} ranks")
    pieces = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _GroupAllGather(torch.autograd.Function):
    """all_gather; its transpose is reduce_scatter on the same axis."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return group_reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _GroupReduceScatter(torch.autograd.Function):
    """reduce_scatter; its transpose is all_gather on the same axis."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group_reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return group_all_gather(grad, ctx.group, ctx.dim), None, None


class _GroupAllToAll(torch.autograd.Function):
    """all_to_all; its transpose is all_to_all with the axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return group_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return group_all_to_all(grad, ctx.group, concat_axis, split_axis), None, None, None


# -- collectives over an axis object (autograd) ------------------------------


def pmean(x, ring):
    """x [R, ...] averaged over all positions of the axis."""
    return psum(x, ring) / ring.size


def all_gather(x, ring, *, tiled: bool = True, gather_axis: int = 0):
    """Every position's x [R, ...] gathered on every position: with
    ``tiled``, concatenated along `gather_axis` (of one position's
    tensor), else stacked on a new axis there."""
    if not tiled:
        return all_gather(x.unsqueeze(gather_axis + 1), ring, gather_axis=gather_axis)
    if isinstance(ring, GroupRing):
        return _GroupAllGather.apply(x[0], ring.group, gather_axis).unsqueeze(0)
    whole = torch.cat(x.unbind(0), dim=gather_axis)
    return whole.unsqueeze(0).expand(ring.size, *whole.shape)


def reduce_scatter(x, ring, *, scatter_axis: int = 0):
    """x [R, ...] summed over the axis, each position keeping its 1/n
    slice of `scatter_axis` (of one position's tensor)."""
    if isinstance(ring, GroupRing):
        return _GroupReduceScatter.apply(x[0], ring.group, scatter_axis).unsqueeze(0)
    total = x.sum(0)
    if total.shape[scatter_axis] % ring.size:
        raise ValueError(
            f"dim {scatter_axis} of {tuple(total.shape)} does not split over "
            f"{ring.size} positions")
    return torch.stack(total.chunk(ring.size, dim=scatter_axis))


def all_to_all(x, ring, *, split_axis: int, concat_axis: int):
    """The EP/MoE dispatch primitive: position i's x [R, ...] cut into n
    pieces along `split_axis`, piece j sent to position j, which
    concatenates what it receives along `concat_axis` in position order."""
    if isinstance(ring, GroupRing):
        return _GroupAllToAll.apply(x[0], ring.group, split_axis, concat_axis).unsqueeze(0)
    n = ring.size
    pieces = [xi.chunk(n, dim=split_axis) for xi in x.unbind(0)]
    return torch.stack([torch.cat([pieces[j][i] for j in range(n)], dim=concat_axis)
                        for i in range(n)])
