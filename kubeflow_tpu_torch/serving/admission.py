"""Priority admission control and per-tenant quotas for the router.

The port's own copy of `kubeflow_tpu/serving/admission.py` (a module
with no JAX in it), on the port's `utils/metrics.MetricsRegistry`.
Under overload the front door sheds the traffic that declared itself
sheddable first, and bounds each tenant's share so that one runaway
client cannot starve the rest even below overload. Two independent
gates, both decided before a request is acknowledged (a shed is an
honest 429: it never enters the router's `acked == completed + failed`
accounting):

- **Priority classes.** Each class owns a *headroom fraction* of fleet
  capacity: class p is admitted only while fleet-wide outstanding work
  is below ``capacity × headroom[p]``. Lower classes have smaller
  fractions, so as load rises they shed first and the slots between
  their ceiling and 1.0 stay reserved for higher classes.
- **Per-tenant token buckets.** A tenant with a `QuotaSpec` spends one
  token per request from a bucket refilled at ``rate`` tokens/s up to
  ``burst``; an empty bucket sheds with a Retry-After hint of the time
  until the next token. Tenants without a quota are uncapped.

The controller is router-agnostic: `check_priority` and `acquire_quota`
return verdicts, `serving/router.py` turns them into `Overloaded`
(HTTP 429 with a jittered Retry-After at the boundary).
"""

from __future__ import annotations

import dataclasses
import threading
import time

from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

# Default ladder: "critical" may use the whole fleet, "standard" sheds
# when the last 20% of slots are all that's left, "batch" when the top
# half is consumed. Deployments override per-CR.
DEFAULT_PRIORITIES: dict[str, float] = {
    "critical": 1.0,
    "standard": 0.8,
    "batch": 0.5,
}


@dataclasses.dataclass(frozen=True)
class QuotaSpec:
    """Token-bucket quota: sustained ``rate`` requests/s, bursting to
    ``burst`` back-to-back."""

    rate: float
    burst: float = 1.0

    def validate(self) -> None:
        if self.rate <= 0:
            raise ValueError(f"quota rate must be > 0, got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"quota burst must be >= 1, got {self.burst}")


@dataclasses.dataclass(frozen=True)
class Verdict:
    """One admission decision. ``retry_after`` is the UNjittered backoff
    hint; the boundary spreads it (router's seeded jitter) before it
    becomes a Retry-After header."""

    admitted: bool
    reason: str = ""
    retry_after: float = 0.0


class _Bucket:
    __slots__ = ("tokens", "stamp", "lock")

    def __init__(self, burst: float, now: float):
        # Stamped from the CONTROLLER's clock, not time.monotonic() —
        # with an injected clock a monotonic stamp makes the first
        # refill compute a garbage elapsed-time delta.
        self.tokens = burst
        self.stamp = now
        self.lock = threading.Lock()


class AdmissionController:
    """Priority + quota policy, shared by every request the router sees.

    ``priorities`` maps class name → headroom fraction in (0, 1]; an
    unknown class on a request is a client error (the boundary's 400),
    surfaced as ValueError. ``quotas`` maps tenant → `QuotaSpec`."""

    def __init__(
        self,
        *,
        priorities: dict[str, float] | None = None,
        quotas: dict[str, QuotaSpec] | None = None,
        metrics: MetricsRegistry | None = None,
        clock=time.monotonic,
    ):
        self.priorities = dict(priorities or DEFAULT_PRIORITIES)
        for name, fraction in self.priorities.items():
            if not 0.0 < fraction <= 1.0:
                raise ValueError(
                    f"priority {name!r} headroom must be in (0, 1], "
                    f"got {fraction}"
                )
        self._clock = clock
        self.quotas: dict[str, QuotaSpec] = {}
        self._buckets: dict[str, _Bucket] = {}
        for tenant, quota in (quotas or {}).items():
            self.set_quota(tenant, quota)
        metrics = metrics or MetricsRegistry()
        self.shed_priority_total = metrics.counter(
            "serving_admission_shed_priority_total",
            "requests shed because their class was out of headroom",
            ("priority",),
        )
        self.shed_quota_total = metrics.counter(
            "serving_admission_shed_quota_total",
            "requests shed by an exhausted tenant token bucket",
            ("tenant",),
        )

    def set_quota(self, tenant: str, quota: QuotaSpec) -> None:
        quota.validate()
        self.quotas[tenant] = quota
        self._buckets[tenant] = _Bucket(quota.burst, self._clock())

    def remove_quota(self, tenant: str) -> None:
        self.quotas.pop(tenant, None)
        self._buckets.pop(tenant, None)

    # -- the two gates -----------------------------------------------------

    def check_priority(
        self, priority: str, *, outstanding: int, capacity: int
    ) -> Verdict:
        """Headroom gate, called under the router lock (pure arithmetic,
        no blocking). Sheds when this class's slice of capacity is
        already consumed by outstanding work."""
        fraction = self.priorities.get(priority)
        if fraction is None:
            raise ValueError(
                f"unknown priority class {priority!r}; "
                f"known: {sorted(self.priorities)}"
            )
        ceiling = capacity * fraction
        if outstanding >= ceiling:
            self.shed_priority_total.inc(priority=priority)
            return Verdict(
                False,
                reason=(
                    f"priority {priority!r} out of headroom "
                    f"({outstanding} outstanding >= "
                    f"{ceiling:.0f} of {capacity} slots)"
                ),
            )
        return Verdict(True)

    def _charge_one(self, key: str, quota: QuotaSpec) -> Verdict:
        bucket = self._buckets[key]
        with bucket.lock:
            now = self._clock()
            bucket.tokens = min(
                quota.burst,
                bucket.tokens + (now - bucket.stamp) * quota.rate,
            )
            bucket.stamp = now
            if bucket.tokens >= 1.0:
                bucket.tokens -= 1.0
                return Verdict(True)
            wait = (1.0 - bucket.tokens) / quota.rate
        self.shed_quota_total.inc(tenant=key)
        return Verdict(
            False,
            reason=f"tenant {key!r} over quota ({quota.rate}/s)",
            retry_after=wait,
        )

    def _refund_one(self, key: str, quota: QuotaSpec) -> None:
        bucket = self._buckets.get(key)
        if bucket is None:  # quota removed between charge and refund
            return
        with bucket.lock:
            bucket.tokens = min(quota.burst, bucket.tokens + 1.0)

    def acquire_quota(self, *keys: str | None) -> Verdict:
        """Token-bucket gate over every quota'd key at once — charged
        once per request (NOT once per dispatch retry — a request that
        spreads across replicas spent one token), and all-or-nothing
        across keys (tenant bucket + ``model:<name>`` bucket): a shed
        by any bucket refunds the tokens already charged, so a capped
        model does not silently drain its tenants. Keys without a
        quota pass untouched. Buckets are charged one lock at a time
        (charge, then refund on a later shed) — never nested, so two
        requests sharing a key subset cannot deadlock."""
        charged: list[tuple[str, QuotaSpec]] = []
        for key in keys:
            if key is None:
                continue
            quota = self.quotas.get(key)
            if quota is None:
                continue
            verdict = self._charge_one(key, quota)
            if not verdict.admitted:
                for prior_key, prior_quota in charged:
                    self._refund_one(prior_key, prior_quota)
                return verdict
            charged.append((key, quota))
        return Verdict(True)
