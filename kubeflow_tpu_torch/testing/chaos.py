"""Fault plans: seeded serving replica kills and the RL soak's faults.

The port's copy of two parts of `kubeflow_tpu/testing/chaos.py`: the
serving part (`ReplicaKill`, `ReplicaKillSchedule`) and the RL soak's
(`ACTOR_KILL`, `LEARNER_KILL`, `TRIAL_KILL`, `RL_FAULT_CLASSES`,
`RLFault`, `RLFaultSchedule`); the control-plane chaos proxy and the
training fault plans are not ported. The serving chaos run kills
REPLICAS: a worker dies mid-request under concurrent clients, and the
router's ack contract (acked == completed + failed, failed == 0 for
idempotent traffic) is the gate. Every plan is finite, seeded and
coverage-accounted, and for the same arguments identical to JAX's.
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


# ---------------------------------------------------------------------------
# RL soak faults.
#
# The RL soak runs a StudyJob of short actor–learner trials and kills
# each layer of the coupled system in a different trial: an ACTOR's
# serving replica mid-study (the fleet must heal and the loop keep
# acting), the LEARNER mid-fit (SIGKILL; the resumed incarnation must
# continue the same replay position), and a whole TRIAL before it
# trains (the study controller must reschedule it). Coverage is gated on
# worker-reported evidence, never on the soak's intent.
# ---------------------------------------------------------------------------

ACTOR_KILL = "actor_kill"
LEARNER_KILL = "learner_kill"
TRIAL_KILL = "trial_kill"
RL_FAULT_CLASSES = (ACTOR_KILL, LEARNER_KILL, TRIAL_KILL)


@dataclasses.dataclass(frozen=True)
class RLFault:
    """One planned RL fault. `trial` is the study trial index it binds
    to; `at_fraction` the point in that trial's learner progress
    (steps-done fraction, 0..1) it fires at. trial_kill fires before
    meaningful training (the reschedule story), learner_kill mid-fit
    (the resume story), actor_kill mid-fit (the heal story)."""

    cls: str
    trial: int
    at_fraction: float


class RLFaultSchedule:
    """A finite, seeded fault plan for the RL study soak.

    Pure function of (seed, trials): the soak and every trial worker
    construct the identical schedule from the env-carried seed,
    so a worker self-derives its own faults from its trial index (read
    off its job's trial label) — no fault channel between processes,
    which is exactly why a kill can't be lost in transit.

    Every class lands on a DISTINCT trial (requires trials >= 3) so one
    trial's recovery can't mask another class going uninjected.
    `mark_injected` is driven by worker-reported evidence only (the
    observation rows carry what actually happened), so `coverage()`
    never reports robustness the run didn't test.
    """

    def __init__(self, seed: int, *, trials: int):
        if trials < len(RL_FAULT_CLASSES):
            raise ValueError(
                f"RL soak needs >= {len(RL_FAULT_CLASSES)} trials for "
                f"distinct per-class victims, got {trials}"
            )
        self.seed = seed
        self.trials = trials
        # A STRING seed: Random(str) seeds via sha512 — stable across
        # processes, which the soak/worker shared-plan contract needs
        # (tuple/other hashables seed via hash(), randomized per
        # process by PYTHONHASHSEED).
        rng = random.Random(f"rl-{seed}")
        victims = rng.sample(range(trials), len(RL_FAULT_CLASSES))
        windows = {
            # Early: the trial dies before training matters.
            TRIAL_KILL: (0.0, 0.1),
            # Mid-fit, past warmup, with room left to prove recovery.
            LEARNER_KILL: (0.35, 0.65),
            ACTOR_KILL: (0.3, 0.6),
        }
        plan = []
        for cls, trial in zip(RL_FAULT_CLASSES, victims):
            lo, hi = windows[cls]
            plan.append(RLFault(cls, trial, rng.uniform(lo, hi)))
        self.plan: tuple[RLFault, ...] = tuple(
            sorted(plan, key=lambda f: f.trial)
        )
        self._injected: dict[str, int] = {c: 0 for c in RL_FAULT_CLASSES}
        self._lock = threading.Lock()

    def for_trial(self, trial: int) -> tuple[RLFault, ...]:
        """The faults bound to one trial (what a worker self-delivers)."""
        return tuple(f for f in self.plan if f.trial == trial)

    def mark_injected(self, cls: str) -> None:
        """Worker-reported evidence says this class's effect landed."""
        with self._lock:
            self._injected[cls] = self._injected.get(cls, 0) + 1

    def coverage(self) -> dict[str, int]:
        with self._lock:
            return dict(self._injected)

    def __repr__(self) -> str:
        return (
            f"RLFaultSchedule(seed={self.seed}, trials={self.trials}, "
            f"planned={len(self.plan)}, coverage={self.coverage()})"
        )
