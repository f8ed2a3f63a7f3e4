"""Gang placement for the TpuJob operator.

Counterpart of `kubeflow_tpu/native/scheduler.py`'s `PyGangScheduler`
and `PlacementError`: the Python twin of the native (C++) gang
scheduler, with the native scheduler's semantics. The port binds no
native code; the operator builds one of these from observed Nodes and
pods for every placement decision.
"""

from __future__ import annotations


class PlacementError(RuntimeError):
    """No pool can hold the whole gang (nothing was reserved)."""


class PyGangScheduler:
    """Topology-aware, all-or-nothing gang placement: the Python twin
    of the JAX package's native scheduler, with its semantics — the
    same serpentine slot order over (y, x), the same torus ring-cost
    minimization, the same tie-breaking. A gang of `workers` takes
    `chips_per_worker` accelerators on each of its nodes, or nothing."""

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
