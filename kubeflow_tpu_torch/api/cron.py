"""CronWorkflow: scheduled Workflow materialization.

The reference's CI cadence is Prow periodics triggering Argo workflows
(`prow_config.yaml`, `testing/README.md:22-35`); Argo itself ships
CronWorkflow for the same job. This CRD captures that surface natively:
a 5-field cron schedule (minute resolution), a workflow template, a
suspend switch, and a concurrency policy (Allow | Forbid | Replace)
for when the previous run is still going.

Counterpart of `kubeflow_tpu/api/cron.py` (a module with no JAX in it),
whole: Vixie day semantics (day-of-month OR day-of-week when both are
restricted, 7 is Sunday), a day-stepping `next_after` that keeps a
sparse schedule cheap and gives the first epoch of an ambiguous wall
time, and an unsatisfiable schedule that is an invalid spec.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

KIND = "CronWorkflow"

_FIELDS = (
    ("minute", 0, 59),
    ("hour", 0, 23),
    ("dom", 1, 31),
    ("month", 1, 12),
    ("dow", 0, 7),  # 0 and 7 both mean Sunday (POSIX/Vixie convention)
)


def _parse_field(text: str, lo: int, hi: int, name: str) -> frozenset[int]:
    """One cron field: '*', '*/n', 'a', 'a-b', 'a-b/n', comma lists."""
    out: set[int] = set()
    for part in text.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            if not step_s.isdigit() or int(step_s) < 1:
                raise ValueError(f"cron {name}: bad step {step_s!r}")
            step = int(step_s)
        if part == "*":
            start, end = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            if not (a.isdigit() and b.isdigit()):
                raise ValueError(f"cron {name}: bad range {part!r}")
            start, end = int(a), int(b)
        elif part.isdigit():
            start = end = int(part)
        else:
            raise ValueError(f"cron {name}: bad value {part!r}")
        if not (lo <= start <= hi and lo <= end <= hi and start <= end):
            raise ValueError(
                f"cron {name}: {part!r} outside [{lo}, {hi}]"
            )
        out.update(range(start, end + 1, step))
    return frozenset(out)


@dataclasses.dataclass(frozen=True)
class CronSchedule:
    minute: frozenset[int]
    hour: frozenset[int]
    dom: frozenset[int]
    month: frozenset[int]
    dow: frozenset[int]
    # Vixie day semantics need to know whether the day fields were
    # written as '*' (a `*/n` form counts as star, matching Vixie's
    # DOM_STAR/DOW_STAR flags): when BOTH dom and dow are restricted, a
    # day matches if EITHER does — '0 0 1,15 * 1' fires on the 1st, the
    # 15th, AND every Monday.
    dom_star: bool = True
    dow_star: bool = True

    @classmethod
    def parse(cls, expr: str) -> "CronSchedule":
        parts = expr.split()
        if len(parts) != 5:
            raise ValueError(
                f"cron needs 5 fields (minute hour dom month dow), got "
                f"{expr!r}"
            )
        fields = [
            _parse_field(text, lo, hi, name)
            for text, (name, lo, hi) in zip(parts, _FIELDS)
        ]
        # dow 7 is Sunday's alias; normalize onto 0.
        dow = fields[4]
        if 7 in dow:
            dow = (dow - {7}) | {0}
        return cls(
            *fields[:4],
            frozenset(dow),
            dom_star=parts[2].startswith("*"),
            dow_star=parts[4].startswith("*"),
        )

    def _day_matches(self, tm: time.struct_time) -> bool:
        dow = (tm.tm_wday + 1) % 7  # tm_wday: 0=Mon → cron: 0=Sun
        dom_ok = tm.tm_mday in self.dom
        dow_ok = dow in self.dow
        if self.dom_star or self.dow_star:
            return dom_ok and dow_ok
        return dom_ok or dow_ok  # Vixie OR when both are restricted

    def matches(self, t: float) -> bool:
        tm = time.localtime(t)
        return (
            tm.tm_min in self.minute
            and tm.tm_hour in self.hour
            and tm.tm_mon in self.month
            and self._day_matches(tm)
        )

    def next_after(self, t: float, horizon_days: int = 1500) -> float:
        """First matching minute strictly after `t`.

        Field arithmetic, not a minute scan: walk candidate DAYS (mktime
        normalizes day overflow, so DST days keep their civil dates) and
        only enumerate the schedule's own hour×minute sets inside a
        matching day — a sparse-but-valid schedule like '0 0 29 2 *'
        costs ~1500 cheap day probes, not 2.1M minute probes (reconciles
        call this on every pass). The horizon spans a full leap cycle so
        a Feb-29 schedule resolves from any anchor; a schedule with NO
        match inside it (e.g. Feb 31) raises — callers surface that as
        an invalid spec, never a retry loop."""
        hours = sorted(self.hour)
        minutes = sorted(self.minute)
        base_tm = time.localtime(t)
        for d in range(horizon_days + 1):
            # Noon probe sidesteps DST boundary ambiguity when resolving
            # the candidate day's civil date.
            probe = time.mktime(
                (base_tm.tm_year, base_tm.tm_mon, base_tm.tm_mday + d,
                 12, 0, 0, 0, 0, -1)
            )
            ptm = time.localtime(probe)
            if ptm.tm_mon not in self.month or not self._day_matches(ptm):
                continue
            # Try BOTH isdst hints and keep the earliest valid epoch: on
            # the fall-back day a wall time inside the repeated hour has
            # two epochs, and isdst=-1 would pick the later (standard-
            # time) one — firing an hour late. matches() re-guards each
            # candidate, so a spring-forward-skipped or hint-shifted wall
            # clock outside the sets is dropped.
            best: float | None = None
            for h in hours:
                for m in minutes:
                    for isdst in (1, 0):
                        try:
                            cand = time.mktime(
                                (ptm.tm_year, ptm.tm_mon, ptm.tm_mday,
                                 h, m, 0, 0, 0, isdst)
                            )
                        except (OverflowError, ValueError):
                            # A zone with no DST at all (TZ=UTC — every
                            # CI container) has no isdst=1 reading of
                            # any wall time; glibc signals that with
                            # OverflowError rather than normalizing.
                            continue
                        if cand > t and self.matches(cand):
                            if best is None or cand < best:
                                best = cand
            if best is not None:
                return float(best)
        raise ValueError("no matching time within the horizon")


@dataclasses.dataclass(frozen=True)
class CronWorkflowSpec:
    schedule: str
    # The Workflow spec dict to materialize each run.
    workflow_spec: dict[str, Any]
    suspend: bool = False
    # Allow: runs may overlap. Forbid: skip the tick if a spawned
    # workflow is still running. Replace: delete the running one first.
    concurrency_policy: str = "Allow"
    # Keep this many finished spawned workflows (older ones are GC'd).
    history_limit: int = 3

    def validate(self) -> None:
        CronSchedule.parse(self.schedule)
        if not self.workflow_spec.get("steps"):
            raise ValueError("cron workflow needs workflowSpec.steps")
        if self.concurrency_policy not in ("Allow", "Forbid", "Replace"):
            raise ValueError(
                f"concurrencyPolicy must be Allow|Forbid|Replace, got "
                f"{self.concurrency_policy!r}"
            )
        if self.history_limit < 0:
            raise ValueError("historyLimit must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        return {
            "schedule": self.schedule,
            "workflowSpec": dict(self.workflow_spec),
            "suspend": self.suspend,
            "concurrencyPolicy": self.concurrency_policy,
            "historyLimit": self.history_limit,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CronWorkflowSpec":
        spec = cls(
            schedule=d.get("schedule", ""),
            workflow_spec=dict(d.get("workflowSpec") or {}),
            suspend=bool(d.get("suspend", False)),
            concurrency_policy=d.get("concurrencyPolicy", "Allow"),
            history_limit=int(d.get("historyLimit", 3)),
        )
        spec.validate()
        return spec
