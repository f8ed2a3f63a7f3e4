"""Leader election over a Lease resource, with write fencing.

Counterpart of `kubeflow_tpu/controllers/leader.py` (a module with no
JAX in it), whole. N replicas of the controller manager run with one
active: the active replica holds a Lease and renews it; standbys poll,
and the first to see it expired takes over.

- `Lease` is a stored resource (`coordination.k8s.io/Lease` analog):
  spec carries holderIdentity, leaseDurationSeconds, acquireTime,
  renewTime, and leaseTransitions, a monotonic count of ownership
  changes that doubles as the FENCING TOKEN.
- `LeaderElector` is the acquire/renew loop (client-go
  `leaderelection.LeaderElector` semantics): acquisition and renewal are
  compare-and-swap updates riding the store's resourceVersion
  preconditions, so two candidates can never both win a term.
- Fencing: a client can arm a *lease guard* (`HttpApiClient.
  set_lease_guard`): every later write carries (lease key, holder,
  transitions) and the store refuses it under its commit lock unless
  the lease still shows that holder and generation
  (`testing/fake_apiserver.check_lease_guard`). A leader that lost its
  lease during a partition (or a pause) and comes back mid-write gets a
  Conflict instead of changing state the new leader owns.

The loop never restarts itself after losing leadership: like client-go's
default, a deposed leader dies and its supervisor starts a fresh one;
in-flight state from the old term must not leak into a new one.
"""

from __future__ import annotations

import logging
import threading
import time

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    Conflict,
    NotFound,
)

log = logging.getLogger(__name__)

LEASE_KIND = "Lease"


def make_lease(
    name: str,
    holder: str,
    *,
    namespace: str = "",
    duration: float = 15.0,
    transitions: int = 1,
) -> Resource:
    now = time.time()
    return new_resource(
        LEASE_KIND,
        name,
        namespace,
        spec={
            "holderIdentity": holder,
            "leaseDurationSeconds": duration,
            "acquireTime": now,
            "renewTime": now,
            "leaseTransitions": transitions,
        },
    )


class LeaderElector:
    """Acquire/hold a Lease; CAS-safe against concurrent candidates.

    Timing contract (client-go's): `lease_duration` is how long a dead
    leader's lease blocks takeover (the failover ceiling); the holder
    renews every `retry_period`; a holder that cannot renew for
    `renew_deadline` must assume a successor exists and step down —
    renew_deadline < lease_duration leaves margin for clock skew and a
    final in-flight write to be fenced rather than racing."""

    def __init__(
        self,
        api,
        name: str,
        identity: str,
        *,
        namespace: str = "",
        lease_duration: float = 15.0,
        renew_deadline: float = 10.0,
        retry_period: float = 2.0,
    ):
        if not renew_deadline < lease_duration:
            raise ValueError(
                "renew_deadline must be < lease_duration (a holder must "
                "step down before its lease can have expired under it)"
            )
        self.api = api
        self.name = name
        self.namespace = namespace
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self._leading = threading.Event()
        # leaseTransitions of the term this elector holds — the fencing
        # token writers present.
        self.transitions: int | None = None

    # -- observations ------------------------------------------------------

    def is_leading(self) -> bool:
        return self._leading.is_set()

    @property
    def guard(self) -> tuple[str, str, str, int] | None:
        """The lease guard tuple an armed client attaches to writes:
        (namespace, name, holder, transitions). None when not leading."""
        if not self._leading.is_set() or self.transitions is None:
            return None
        return (self.namespace, self.name, self.identity, self.transitions)

    # -- protocol steps ----------------------------------------------------

    def _try_acquire_or_renew(self) -> bool:
        """One CAS attempt. True iff this identity holds the lease after
        the call. Every path is safe against concurrent candidates: the
        create races through AlreadyExists, the update through the
        resourceVersion precondition."""
        now = time.time()
        try:
            lease = self.api.get(LEASE_KIND, self.name, self.namespace)
        except NotFound:
            fresh = make_lease(
                self.name,
                self.identity,
                namespace=self.namespace,
                duration=self.lease_duration,
            )
            try:
                self.api.create(fresh)
            except (AlreadyExists, Conflict):
                return False  # someone else created it this instant
            self.transitions = 1
            return True
        spec = dict(lease.spec)
        holder = spec.get("holderIdentity") or ""
        age = now - float(spec.get("renewTime", 0.0))
        expired = not holder or age > float(
            spec.get("leaseDurationSeconds", self.lease_duration)
        )
        if holder != self.identity and not expired:
            return False  # someone else is alive and holding
        spec["holderIdentity"] = self.identity
        spec["renewTime"] = now
        spec["leaseDurationSeconds"] = self.lease_duration
        if holder != self.identity:
            # Ownership change: new term, new fencing token.
            spec["acquireTime"] = now
            spec["leaseTransitions"] = int(spec.get("leaseTransitions", 0)) + 1
        lease = lease.thaw()
        lease.spec = spec
        try:
            updated = self.api.update(lease)  # rv CAS
        except (Conflict, NotFound):
            return False  # lost the race this round
        self.transitions = int(updated.spec["leaseTransitions"])
        return True

    def acquire(self, stop: threading.Event) -> bool:
        """Block until this replica leads (True) or `stop` is set
        (False). Standby mode is this loop: poll every retry_period."""
        while not stop.is_set():
            try:
                if self._try_acquire_or_renew():
                    self._leading.set()
                    log.info(
                        "%s: acquired lease %s (generation %s)",
                        self.identity, self.name, self.transitions,
                    )
                    return True
            except PermissionError as e:
                # Not a transient blip: a revoked/under-privileged token
                # never heals by hot-retrying. Say so loudly and back
                # off hard (the operator may re-grant, so the standby
                # stays alive rather than dying silently) — the same
                # posture as HttpApiClient._watch_loop.
                log.error(
                    "%s: lease %s acquire unauthorized (%s); backing off",
                    self.identity, self.name, e,
                )
                stop.wait(max(self.retry_period, 5.0))
                continue
            except Exception as e:
                log.warning(
                    "%s: lease %s acquire attempt failed: %s",
                    self.identity, self.name, e,
                )
            stop.wait(self.retry_period)
        return False

    def hold(self, stop: threading.Event) -> None:
        """Renew until `stop` is set or leadership is LOST — either no
        successful renewal for renew_deadline, or the renewal succeeded
        as a re-ACQUISITION of a newer term (leaseTransitions moved:
        someone else held the lease in between, e.g. across a long GC
        pause or SIGSTOP). A term change must read as loss, not routine
        renewal: the caller's fencing guard was armed with the old
        generation, and in-flight state belongs to the dead term.
        Returns only on stop/loss; the caller decides whether loss is
        fatal (controller binaries exit)."""
        term = self.transitions
        last_renew = time.monotonic()
        while not stop.is_set():
            if stop.wait(self.retry_period):
                break
            try:
                renewed = self._try_acquire_or_renew()
            except Exception as e:
                # Renewal failures are load-bearing (they end in a
                # step-down): surface the cause above DEBUG.
                log.warning(
                    "%s: lease %s renewal failed: %s",
                    self.identity, self.name, e,
                )
                renewed = False
            if renewed and self.transitions != term:
                self._leading.clear()
                log.error(
                    "%s: lease %s changed terms under us (generation "
                    "%s -> %s: another replica held it in between) — "
                    "stepping down",
                    self.identity, self.name, term, self.transitions,
                )
                return
            if renewed:
                last_renew = time.monotonic()
            elif time.monotonic() - last_renew > self.renew_deadline:
                self._leading.clear()
                log.error(
                    "%s: lost lease %s (no successful renewal for "
                    "%.1fs) — stepping down",
                    self.identity, self.name, self.renew_deadline,
                )
                return
        self._leading.clear()

    def release(self) -> None:
        """Graceful handover: clear holderIdentity so a standby acquires
        on its next poll instead of waiting out the TTL (client-go's
        ReleaseOnCancel). Best-effort — a crash skips this and costs the
        full lease_duration, which the e2e pins as the failover bound."""
        self._leading.clear()
        try:
            lease = self.api.get(LEASE_KIND, self.name, self.namespace)
            if lease.spec.get("holderIdentity") == self.identity:
                lease = lease.thaw()
                lease.spec["holderIdentity"] = ""
                self.api.update(lease)
        except Exception:
            log.debug("lease release failed (crash-equivalent)",
                      exc_info=True)

    def run(
        self,
        stop: threading.Event,
        on_started_leading,
        *,
        release_on_stop: bool = True,
    ) -> bool:
        """The standard lifecycle: block in standby until leading, call
        `on_started_leading(elector)`, then renew until stop/loss.
        Returns True if leadership was LOST (caller should exit rather
        than resume — a deposed leader's state belongs to a dead term),
        False on a clean stop."""
        if not self.acquire(stop):
            return False
        try:
            on_started_leading(self)
            self.hold(stop)
        finally:
            lost = not stop.is_set()
            if release_on_stop and not lost:
                self.release()
        return lost
