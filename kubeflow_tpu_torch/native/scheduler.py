"""The gang scheduler: compiled, with its Python twin.

Counterpart of `kubeflow_tpu/native/scheduler.py` (a module with no JAX
in it): `GangScheduler` binds the port's copy of ``scheduler.cc``
(``libkftpu_sched``, built by `native/build.py` at first use) by ctypes;
`PyGangScheduler` is its Python twin with the same semantics (the same
serpentine slot order, torus ring cost and tie-breaking), held to it by
tests/test_torch_native_scheduler.py.

`make_gang_scheduler()` returns the compiled scheduler, which is what
the TpuJob operator places every gang with, and raises if the library
cannot be built or loaded. JAX's falls back to the twin with a warning;
the port's does not, so a placement counted ``native`` is one the
compiled scheduler made. The twin is reached only by name, through the
operator's ``scheduler_factory=``.
"""

from __future__ import annotations

import ctypes

from kubeflow_tpu_torch.native.build import load


class PlacementError(RuntimeError):
    """No pool can hold the whole gang (nothing was reserved)."""


def _configure(lib: ctypes.CDLL) -> None:
    lib.kftpu_sched_new.restype = ctypes.c_void_p
    lib.kftpu_sched_free.argtypes = [ctypes.c_void_p]
    lib.kftpu_sched_add_node.restype = ctypes.c_int32
    lib.kftpu_sched_add_node.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.kftpu_sched_remove_node.restype = ctypes.c_int32
    lib.kftpu_sched_remove_node.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
    ]
    lib.kftpu_sched_set_pool_topology.restype = ctypes.c_int32
    lib.kftpu_sched_set_pool_topology.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.kftpu_sched_place_gang.restype = ctypes.c_int64
    lib.kftpu_sched_place_gang.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.kftpu_sched_release_gang.restype = ctypes.c_int32
    lib.kftpu_sched_release_gang.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
    ]
    lib.kftpu_sched_reserve.restype = ctypes.c_int32
    lib.kftpu_sched_reserve.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int32,
    ]
    lib.kftpu_sched_free_chips.restype = ctypes.c_int64
    lib.kftpu_sched_free_chips.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
    ]


class GangScheduler:
    """Topology-aware, all-or-nothing gang placement, compiled
    (scheduler.cc)."""

    tier = "native"

    def __init__(self):
        self._lib = load("kftpu_sched", _configure)
        self._handle = self._lib.kftpu_sched_new()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.kftpu_sched_free(handle)
            self._handle = None

    def add_node(
        self, name: str, pool: str, *, x: int = 0, y: int = 0, chips: int = 4
    ) -> None:
        rc = self._lib.kftpu_sched_add_node(
            self._handle, name.encode(), pool.encode(), x, y, chips
        )
        if rc != 0:
            raise PlacementError(f"node {name!r} already registered")

    def remove_node(self, name: str) -> bool:
        return (
            self._lib.kftpu_sched_remove_node(self._handle, name.encode()) == 0
        )

    def set_pool_topology(self, pool: str, width: int, height: int) -> None:
        """Declare `pool` as a width x height 2D torus: ring cost then
        uses per-axis wraparound distance (min(d, size-d)), so a ring
        crossing the seam is one hop, not width-1. 0/1 on an axis = no
        wrap there."""
        rc = self._lib.kftpu_sched_set_pool_topology(
            self._handle, pool.encode(), width, height
        )
        if rc != 0:
            raise PlacementError(
                f"bad topology {width}x{height} for pool {pool!r}"
            )

    def place_gang(
        self, job: str, pool: str, workers: int, chips_per_worker: int
    ) -> tuple[list[str], int]:
        """Returns (node per rank, ring cost). Raises PlacementError if the
        pool cannot hold the whole gang (nothing is reserved)."""
        buf = ctypes.create_string_buffer(64 * max(1, workers) + 64)
        cost = self._lib.kftpu_sched_place_gang(
            self._handle, job.encode(), pool.encode(), workers,
            chips_per_worker, buf, len(buf),
        )
        if cost == -1:
            raise PlacementError(
                f"pool {pool!r} lacks capacity for {workers}x"
                f"{chips_per_worker} chips"
            )
        if cost < 0:
            raise PlacementError(f"placement failed (code {cost}) for {job!r}")
        return buf.value.decode().split(";"), int(cost)

    def reserve(self, job: str, node: str, chips: int) -> bool:
        """Record an observed placement (rebuilding state from pods)."""
        return (
            self._lib.kftpu_sched_reserve(
                self._handle, job.encode(), node.encode(), chips
            )
            == 0
        )

    def release_gang(self, job: str) -> int:
        n = self._lib.kftpu_sched_release_gang(self._handle, job.encode())
        return max(0, n)

    def free_chips(self, pool: str) -> int:
        return int(
            self._lib.kftpu_sched_free_chips(self._handle, pool.encode())
        )


class PyGangScheduler:
    """Topology-aware, all-or-nothing gang placement: the Python twin
    of the JAX package's native scheduler, with its semantics — the
    same serpentine slot order over (y, x), the same torus ring-cost
    minimization, the same tie-breaking. A gang of `workers` takes
    `chips_per_worker` accelerators on each of its nodes, or nothing."""

    tier = "python"

    def __init__(self):
        # name -> [pool, x, y, chips, reserved]
        self._nodes: dict[str, list] = {}
        self._gangs: dict[str, list[tuple[str, int]]] = {}
        self._pool_topo: dict[str, tuple[int, int]] = {}

    def add_node(self, name, pool, *, x=0, y=0, chips=4) -> None:
        if chips < 0:
            raise PlacementError(f"node {name!r}: negative chips {chips}")
        if name in self._nodes:
            raise PlacementError(f"node {name!r} already registered")
        self._nodes[name] = [pool, x, y, chips, 0]

    def remove_node(self, name) -> bool:
        return self._nodes.pop(name, None) is not None

    def set_pool_topology(self, pool, width, height) -> None:
        if width < 0 or height < 0:
            raise PlacementError(
                f"bad topology {width}x{height} for pool {pool!r}"
            )
        self._pool_topo[pool] = (width, height)

    def _dist(self, a: str, b: str) -> int:
        pool, ax, ay, _, _ = self._nodes[a]
        _, bx, by, _, _ = self._nodes[b]
        w, h = self._pool_topo.get(pool, (0, 0))

        def axis(d, size):
            d = abs(d)
            if size > 1:
                d %= size
                return min(d, size - d)
            return d

        return axis(ax - bx, w) + axis(ay - by, h)

    def place_gang(self, job, pool, workers, chips_per_worker):
        if workers <= 0 or chips_per_worker < 0 or job in self._gangs:
            raise PlacementError(f"placement failed (code -3) for {job!r}")
        pool_nodes = sorted(
            (name for name, n in self._nodes.items() if n[0] == pool),
            key=lambda name: (
                self._nodes[name][2],
                (-self._nodes[name][1] if self._nodes[name][2] & 1
                 else self._nodes[name][1]),
                name,
            ),
        )
        slots: list[str] = []
        for name in pool_nodes:
            _, _, _, chips, reserved = self._nodes[name]
            cap = (
                (workers if chips >= reserved else 0)
                if chips_per_worker == 0
                else (chips - reserved) // chips_per_worker
            )
            for _ in range(cap):
                if len(slots) >= workers * 2 + 1024:
                    break
                slots.append(name)
        if len(slots) < workers:
            raise PlacementError(
                f"pool {pool!r} lacks capacity for {workers}x"
                f"{chips_per_worker} chips"
            )
        best_cost, best_start = -1, 0
        for start in range(len(slots) - workers + 1):
            cost = sum(
                self._dist(slots[start + i - 1], slots[start + i])
                for i in range(1, workers)
            )
            if best_cost < 0 or cost < best_cost:
                best_cost, best_start = cost, start
        assignment = slots[best_start:best_start + workers]
        gang = self._gangs.setdefault(job, [])
        for name in assignment:
            self._nodes[name][4] += chips_per_worker
            gang.append((name, chips_per_worker))
        return assignment, int(best_cost)

    def reserve(self, job, node, chips) -> bool:
        n = self._nodes.get(node)
        if n is None or chips < 0:
            return False
        n[4] += chips
        self._gangs.setdefault(job, []).append((node, chips))
        return True

    def release_gang(self, job) -> int:
        gang = self._gangs.pop(job, None)
        if gang is None:
            return 0
        for node, chips in gang:
            if node in self._nodes:
                self._nodes[node][4] -= chips
        return len(gang)

    def free_chips(self, pool) -> int:
        return sum(
            max(0, n[3] - n[4])
            for n in self._nodes.values()
            if n[0] == pool
        )


def make_gang_scheduler() -> GangScheduler:
    """The compiled scheduler; raises if it cannot be built or loaded."""
    return GangScheduler()
