"""Drain-aware request router over a fleet of serving replicas.

The port's own copy of `kubeflow_tpu/serving/router.py` (a module with
no JAX in it), on the port's `utils/metrics.MetricsRegistry`. The
router sees the batching queues it feeds, so it spreads and retries
itself instead of leaving that to an external L7 balancer. Contracts:

- **Spread**: `predict()` dispatches to the admitting replica with the
  fewest outstanding requests (least-loaded, not round-robin: replica
  service times diverge the moment one is draining or cold).
- **Retry on replica death**: a replica that dies mid-request
  (`ReplicaGone`: connection reset, SIGKILL, hard queue kill) is marked
  dead and the request retries on a survivor, *if* the caller declared
  it idempotent. Inference is idempotent by default; double execution
  is safe, a dropped acknowledged request is not.
- **Load shedding**: when fleet-wide outstanding requests reach the
  admitting replicas' aggregate queue capacity, `predict()` raises
  `Overloaded` carrying `retry_after`; the server boundary turns that
  into an honest HTTP 429 with `Retry-After` *before* queues grow
  unboundedly.
- **Drain** (`drain()` / `roll()`): stop admitting to one replica, let
  its in-flight work finish, swap the model, re-admit. A checkpoint
  roll is therefore zero-downtime: the rest of the fleet keeps
  admitting the whole time. A replica killed *mid-drain* fails its
  in-flight requests with `ReplicaGone`, which re-enter `predict()`'s
  retry path on another replica; the drain completes either way.

Acknowledgement accounting: a request is *acknowledged* once it passes
admission (it was not shed). The router keeps `acked == completed +
failed`; with survivors left, `failed == 0`: no acknowledged request is
dropped.
"""

from __future__ import annotations

import random
import threading
import time

from kubeflow_tpu_torch.serving.admission import AdmissionController, QuotaSpec
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry


class RouterError(RuntimeError):
    pass


class NoReadyReplicas(RouterError):
    """No live replica exists at all (distinct from Overloaded: there is
    nobody to wait for, so retrying without operator action is futile)."""


class Overloaded(RouterError):
    """Load shed: the fleet is at capacity. `retry_after` (seconds) is
    the honest backoff hint the HTTP boundary forwards as Retry-After."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(msg)
        self.retry_after = retry_after


class ReplicaGone(RuntimeError):
    """The replica died or was torn down mid-request (connection reset,
    SIGKILL, queue hard-kill). Raised by replica adapters; the router
    converts it into mark-dead + retry-on-survivor."""


class ReplicaOverloaded(RuntimeError):
    """One replica refused the request (its queue is full); the router
    tries another — only a fleet-wide refusal becomes `Overloaded`."""

    def __init__(self, msg: str, retry_after: float = 0.05):
        super().__init__(msg)
        self.retry_after = retry_after


class _Slot:
    __slots__ = ("replica", "admitting", "dead", "outstanding")

    def __init__(self, replica):
        self.replica = replica
        self.admitting = True
        self.dead = False
        self.outstanding = 0


class Router:
    """Thread-safe fan-out of `predict()` across ready replicas.

    Replicas are any objects with ``name``, ``capacity`` (max queued
    requests it will hold — backpressure budget), and
    ``predict(instances)`` raising `ReplicaGone` / `ReplicaOverloaded`
    per the contracts above (`serving/replica.py` provides the local and
    HTTP adapters). On a multiplexed fleet every replica additionally
    accepts ``predict(instances, model=...)`` (the `MultiModelReplica`
    adapter over a `ServableRegistry`), and an `AdmissionController`
    gates requests by priority class + tenant quota before they count
    as acknowledged.
    """

    def __init__(
        self,
        metrics: MetricsRegistry | None = None,
        *,
        max_attempts: int = 4,
        retry_after_s: float = 0.25,
        dispatch_timeout_s: float = 30.0,
        admission: AdmissionController | None = None,
        retry_jitter_seed: int = 0,
    ):
        self._cv = threading.Condition()
        # Admission policy (priority headroom + tenant quotas) — None
        # keeps the original capacity-only shed, so single-model fleets
        # are untouched.
        self.admission = admission
        # ±50% spread on every Retry-After hint: a fixed value
        # synchronizes every shed client into a retry thundering herd
        # that re-sheds as one wave. Seeded so chaos gates replay the
        # same schedule run-to-run.
        self._retry_rng = random.Random(retry_jitter_seed)
        self._slots: dict[str, _Slot] = {}
        # Admission aggregates, maintained at every membership/state
        # change instead of recomputed per dispatch: _admit_locked sits
        # on the hot path of every request, and rebuilding the alive
        # list plus two sums per call holds the lock every caller needs.
        self._alive: list[_Slot] = []
        self._capacity = 0
        self._outstanding = 0
        self.max_attempts = max_attempts
        self.retry_after_s = retry_after_s
        self.dispatch_timeout_s = dispatch_timeout_s
        # Catalog-declared default priority class per model (CR
        # spec.models[].priority) — applied only when a request names
        # no class of its own.
        self._model_priority: dict[str, str] = {}
        metrics = metrics or MetricsRegistry()
        self._metrics_registry = metrics
        self.acked_total = metrics.counter(
            "serving_router_acked_total",
            "requests admitted past load shedding",
        )
        self.completed_total = metrics.counter(
            "serving_router_completed_total",
            "acknowledged requests that returned a result",
        )
        self.failed_total = metrics.counter(
            "serving_router_failed_total",
            "acknowledged requests the router could not complete",
        )
        self.shed_total = metrics.counter(
            "serving_router_shed_total",
            "requests shed at admission (HTTP 429 at the boundary)",
        )
        self.retried_total = metrics.counter(
            "serving_router_retried_total",
            "dispatches retried on another replica after replica death",
        )
        self.outstanding_gauge = metrics.gauge(
            "serving_router_outstanding",
            "requests currently dispatched to replicas",
        )

    # -- fleet membership --------------------------------------------------

    def add(self, replica) -> None:
        with self._cv:
            self._slots[replica.name] = _Slot(replica)
            self._refresh_locked()
            self._cv.notify_all()

    def remove(self, name: str) -> None:
        with self._cv:
            self._slots.pop(name, None)
            self._refresh_locked()
            self._cv.notify_all()

    def replica(self, name: str):
        with self._cv:
            slot = self._slots.get(name)
            return slot.replica if slot is not None else None

    def replica_names(self) -> list[str]:
        with self._cv:
            return sorted(self._slots)

    def ready_names(self) -> list[str]:
        with self._cv:
            return sorted(
                name
                for name, s in self._slots.items()
                if s.admitting and not s.dead
            )

    def set_model_policy(self, models) -> None:
        """Wire the CR catalog's admission policy (spec.models[]) into
        this router: each model's declared priority class becomes the
        default for requests that name none, and a nonzero
        ``quotaRate``/``quotaBurst`` becomes a per-model token bucket
        (key ``model:<name>``) charged alongside the tenant bucket.

        Idempotent under reconcile resync: an unchanged QuotaSpec keeps
        its live bucket (re-creating it would refill the burst every
        resync and the quota would never bind); only a changed spec
        resets, and models that dropped their quota (or left the
        catalog) lose their bucket."""
        self._model_priority = {m.name: m.priority for m in models}
        wanted = {
            f"model:{m.name}": QuotaSpec(
                rate=m.quota_rate, burst=m.quota_burst
            )
            for m in models
            if m.quota_rate > 0
        }
        if not wanted and self.admission is None:
            return
        if self.admission is None:
            self.admission = AdmissionController(
                metrics=self._metrics_registry
            )
        for key, quota in wanted.items():
            if self.admission.quotas.get(key) != quota:
                self.admission.set_quota(key, quota)
        for key in list(self.admission.quotas):
            if key.startswith("model:") and key not in wanted:
                self.admission.remove_quota(key)

    def stats(self) -> dict:
        """Aggregate autoscaling signal: fleet-wide outstanding plus each
        replica's own queue stats (the controller folds this into
        ServingDeployment status)."""
        with self._cv:
            slots = list(self._slots.items())
        per_replica = {}
        for name, slot in slots:
            stats_fn = getattr(slot.replica, "stats", None)
            try:
                rstats = stats_fn() if stats_fn else {}
            except Exception:
                rstats = {}
            per_replica[name] = {
                "admitting": slot.admitting,
                "dead": slot.dead,
                "outstanding": slot.outstanding,
                **rstats,
            }
        return {
            "outstanding": sum(s.outstanding for _, s in slots),
            "replicas": per_replica,
        }

    # -- dispatch ----------------------------------------------------------

    def _refresh_locked(self) -> None:
        """Rebuild the admission aggregates after any membership or
        admitting/dead flip. Replica capacity is read here, once per
        state change — a replica whose capacity attribute mutates
        mid-flight is out of contract."""
        self._alive = [
            s for s in self._slots.values() if not s.dead and s.admitting
        ]
        self._capacity = sum(
            max(int(s.replica.capacity), 1) for s in self._alive
        )

    def _retry_hint(self, base: float | None = None) -> float:
        """Retry-After with deterministic ±50% jitter: drawn from the
        seeded RNG so a replayed chaos run sheds the same schedule, but
        spread across [0.5, 1.5]× base so shed clients do not return as
        one synchronized wave (the thundering-herd regression)."""
        base = self.retry_after_s if base is None or base <= 0 else base
        return base * (0.5 + self._retry_rng.random())

    def _admit_locked(
        self, tried: set, priority: str = "standard"
    ) -> "_Slot | None":
        """Admission + selection under the lock. Raises NoReadyReplicas /
        Overloaded; returns None when every eligible replica was already
        tried this request (caller decides whether to wait and re-spread).

        `_outstanding` counts every dispatched-not-finished request,
        including those still in flight on replicas that have since been
        drained or removed — they hold real queue slots somewhere until
        they finish, so the shed decision is (slightly conservatively)
        honest about them."""
        alive = self._alive
        if not alive:
            if not any(not s.dead for s in self._slots.values()):
                raise NoReadyReplicas("no live serving replicas")
            # Everything live is draining; momentary — ask for a retry.
            raise Overloaded(
                "all replicas draining", retry_after=self._retry_hint()
            )
        if self.admission is not None:
            # Priority headroom first: a low class sheds at ITS ceiling
            # even before the fleet-wide capacity check would — the
            # reserved slots above the ceiling are what keep
            # high-priority p99 flat under 2× offered low-pri load.
            verdict = self.admission.check_priority(
                priority,
                outstanding=self._outstanding,
                capacity=self._capacity,
            )
            if not verdict.admitted:
                raise Overloaded(
                    verdict.reason,
                    retry_after=self._retry_hint(verdict.retry_after),
                )
        if self._outstanding >= self._capacity:
            raise Overloaded(
                f"fleet at capacity ({self._outstanding} outstanding >= "
                f"{self._capacity} queue slots)",
                retry_after=self._retry_hint(),
            )
        if not tried:  # the common path builds no per-request list
            return min(alive, key=lambda s: s.outstanding)
        candidates = [s for s in alive if s.replica.name not in tried]
        if not candidates:
            return None
        return min(candidates, key=lambda s: s.outstanding)

    def _finish_locked(self, slot: _Slot) -> None:
        slot.outstanding -= 1
        self._outstanding -= 1
        self.outstanding_gauge.dec()
        self._cv.notify_all()

    def predict(
        self,
        instances,
        *,
        model: str | None = None,
        priority: str | None = "standard",
        tenant: str | None = None,
        idempotent: bool = True,
    ):
        """Route one request. Raises `Overloaded` (shed — never acked),
        `NoReadyReplicas`, or the model error from the replica that
        served it. An acknowledged idempotent request survives replica
        death as long as one replica remains.

        `model` selects the servable on a multiplexed fleet (None keeps
        the single-model replicas' default); `priority`/`tenant` feed the
        admission controller when one is attached — a quota token is
        charged ONCE per request here, not per dispatch retry.
        `priority=None` defers to the model's catalog-declared class
        (`set_model_policy`), falling back to "standard"."""
        if priority is None:
            priority = self._model_priority.get(model or "", "standard")
        if self.admission is not None:
            verdict = self.admission.acquire_quota(
                tenant, f"model:{model}" if model else None
            )
            if not verdict.admitted:
                self.shed_total.inc()
                raise Overloaded(
                    verdict.reason,
                    retry_after=self._retry_hint(verdict.retry_after),
                )
        deadline = time.monotonic() + self.dispatch_timeout_s
        tried: set = set()
        acked = False
        attempts = 0
        while True:
            with self._cv:
                try:
                    slot = self._admit_locked(tried, priority)
                except Overloaded:
                    if not acked:
                        self.shed_total.inc()
                    else:
                        self.failed_total.inc()
                    raise
                except NoReadyReplicas:
                    if acked:
                        self.failed_total.inc()
                    raise
                if slot is None:
                    # Tried every admitting replica this pass (each one
                    # refused or died). Back off briefly and re-spread —
                    # admission said there IS capacity.
                    if time.monotonic() >= deadline:
                        if acked:
                            self.failed_total.inc()
                        else:
                            self.shed_total.inc()
                        raise Overloaded(
                            "every replica refused within the dispatch "
                            "deadline",
                            retry_after=self._retry_hint(),
                        )
                    tried = set()
                    self._cv.wait(0.005)
                    continue
                if not acked:
                    acked = True
                    self.acked_total.inc()
                slot.outstanding += 1
                self._outstanding += 1
                self.outstanding_gauge.inc()
                name = slot.replica.name
                replica = slot.replica
            try:
                if model is None:
                    result = replica.predict(instances)
                else:
                    result = replica.predict(instances, model=model)
            except ReplicaGone:
                with self._cv:
                    slot.dead = True
                    slot.admitting = False
                    self._refresh_locked()
                    self._finish_locked(slot)
                attempts += 1
                if not idempotent or attempts >= self.max_attempts:
                    self.failed_total.inc()
                    raise
                self.retried_total.inc()
                tried.add(name)
                continue
            except ReplicaOverloaded:
                # The replica's own queue beat our accounting (races with
                # direct callers); not a death — try a sibling.
                with self._cv:
                    self._finish_locked(slot)
                tried.add(name)
                continue
            except BaseException:
                # Model/input error: the replica executed and failed the
                # request on its merits — propagate, don't retry.
                with self._cv:
                    self._finish_locked(slot)
                self.failed_total.inc()
                raise
            with self._cv:
                self._finish_locked(slot)
            self.completed_total.inc()
            return result

    # -- drain / roll ------------------------------------------------------

    def drain(self, name: str, timeout: float = 30.0) -> bool:
        """Stop admitting to `name` and wait for its in-flight requests
        to finish (complete OR fail over to a sibling — a kill mid-drain
        converts the remainder into retries, see module docstring).
        Returns True once outstanding hits zero within `timeout`.

        A fully quiesced replica also gets its transport pool
        invalidated (if it has one — `HttpReplica.invalidate_pool`):
        the caller is about to swap or restart the process behind the
        address, and a pooled keep-alive socket into the pre-drain
        incarnation must never serve a post-roll request."""
        deadline = time.monotonic() + timeout
        with self._cv:
            slot = self._slots.get(name)
            if slot is None:
                return True
            slot.admitting = False
            self._refresh_locked()
            while slot.outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            replica = slot.replica
        invalidate = getattr(replica, "invalidate_pool", None)
        if invalidate is not None:
            invalidate()
        return True

    def admit(self, name: str) -> None:
        """Re-admit a drained (or replaced) replica. The caller vouches
        that the replica behind the slot is healthy again."""
        with self._cv:
            slot = self._slots.get(name)
            if slot is None:
                raise KeyError(f"unknown replica {name!r}")
            slot.admitting = True
            slot.dead = False
            self._refresh_locked()
            self._cv.notify_all()

    def roll(self, name: str, swap_fn, timeout: float = 30.0) -> float:
        """Zero-downtime hot swap: drain → swap_fn() → re-admit. Returns
        the wall seconds the replica was out of rotation. swap_fn runs
        with the replica fully quiesced (no in-flight work)."""
        start = time.monotonic()
        if not self.drain(name, timeout=timeout):
            raise TimeoutError(
                f"replica {name!r} did not drain within {timeout}s"
            )
        swap_fn()
        self.admit(name)
        return time.monotonic() - start
