"""Serving data-plane fault plans: seeded replica kills.

The port's copy of the serving part of `kubeflow_tpu/testing/chaos.py`
(`ReplicaKill`, `ReplicaKillSchedule`; the control-plane chaos proxy
and the training fault plans are not ported). The serving chaos run
kills REPLICAS: a worker dies mid-request under concurrent clients, and
the router's ack contract (acked == completed + failed, failed == 0 for
idempotent traffic) is the gate. The plan is finite, seeded and
coverage-accounted.
"""

from __future__ import annotations

import dataclasses
import random
import threading

REPLICA_KILL = "replica_kill"
SERVING_FAULT_CLASSES = (REPLICA_KILL,)


@dataclasses.dataclass(frozen=True)
class ReplicaKill:
    """One planned replica death. `at_fraction` is the point in the
    offered load (completed-requests fraction, 0..1) the kill fires at;
    `victim` indexes into the READY set at fire time (mod its length),
    so the plan stays meaningful however many replicas are still up."""

    cls: str
    at_fraction: float
    victim: int


class ReplicaKillSchedule:
    """A finite, seeded replica-kill plan for a serving chaos run.

    Pure function of (seed, kills, replicas): two schedules from the
    same arguments have identical plans, and the JAX package's schedule
    draws the same plan from the same arguments. Kills land at
    ascending load fractions inside `window` (default mid-run, so every
    kill hits a fleet with requests in flight AND leaves load behind it
    to prove recovery), each targeting a seeded victim index.

    `due(fraction)` is the caller's poll: it pops at most one kill whose
    trigger fraction has passed. Consumption is not coverage —
    `mark_injected` records only kills whose effect landed (the caller
    observed the process die / the queue close), so `coverage()` never
    reports robustness the run didn't test."""

    def __init__(
        self,
        seed: int,
        *,
        kills: int = 1,
        replicas: int = 3,
        window: tuple[float, float] = (0.2, 0.7),
    ):
        self.seed = seed
        rng = random.Random(seed)
        lo, hi = window
        span = (hi - lo) / max(1, kills)
        plan = []
        for i in range(kills):
            at = lo + span * (i + rng.uniform(0.25, 0.75))
            plan.append(
                ReplicaKill(REPLICA_KILL, at, rng.randrange(replicas))
            )
        self.plan: tuple[ReplicaKill, ...] = tuple(plan)
        self._pending: list[ReplicaKill] = list(self.plan)
        self._injected: dict[str, int] = {c: 0 for c in SERVING_FAULT_CLASSES}
        self._lock = threading.Lock()

    @classmethod
    def from_plan(cls, plan) -> "ReplicaKillSchedule":
        """A schedule with an explicit plan (targeted tests that need a
        kill at an exact point, not a seeded mix)."""
        sched = cls(0, kills=0)
        sched.plan = tuple(plan)
        sched._pending = list(sched.plan)
        return sched

    def due(self, fraction: float) -> ReplicaKill | None:
        """The kill (if any) whose trigger point has passed. At most one
        per call so the caller applies each death and lets the router
        react before the next. Thread-safe."""
        with self._lock:
            if self._pending and fraction >= self._pending[0].at_fraction:
                return self._pending.pop(0)
            return None

    def mark_injected(self, kill: ReplicaKill) -> None:
        """The kill verifiably landed (process dead / queue closed)."""
        with self._lock:
            self._injected[kill.cls] = self._injected.get(kill.cls, 0) + 1

    def coverage(self) -> dict[str, int]:
        with self._lock:
            return dict(self._injected)

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return not self._pending

    def __repr__(self) -> str:
        return (
            f"ReplicaKillSchedule(seed={self.seed}, "
            f"planned={len(self.plan)}, coverage={self.coverage()})"
        )
