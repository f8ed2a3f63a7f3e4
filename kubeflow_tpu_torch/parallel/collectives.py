"""Collectives over the sequence-parallel (sp) ring.

Counterpart of the ring part of `kubeflow_tpu/parallel/collectives.py`
(`axis_size`, `axis_index`, `ppermute_ring`, `psum`). There a collective
names a mesh axis inside `shard_map`, and every device runs the body on
its own shard. Here the axis is a ring object, of one of two kinds:

- `LocalRing(n)`: all n positions of the ring in this process, on one
  device — the counterpart of XLA's virtual host devices, on which the
  JAX package's own ring tests run. A tensor carries a leading dimension
  of the n positions, and a rotation is a roll along it.
- `GroupRing(group)`: one position per process of a `torch.distributed`
  group (gloo on the CPU, NCCL on GPUs). The leading dimension has size
  1, and a rotation is one send/receive pair, posted together with
  `batch_isend_irecv` so that NCCL sees both sides.

Ring code is written once over that leading dimension of R local
positions, with their ids in `ring.ranks`: `ops/attention.ring_attention`
and `ops/flash.ring_flash_attention` run the same body on both kinds. No
thread per position and no barrier inside autograd is involved, so the
backward of a ring cannot deadlock on the autograd engine's device
threads. `ppermute_ring` and `psum` are differentiable.

Not ported yet (ROADMAP Queue 1 item 12): `pmean`, `all_gather`,
`reduce_scatter`, `all_to_all` and the other helpers of the JAX module.
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
        self.group = group
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
