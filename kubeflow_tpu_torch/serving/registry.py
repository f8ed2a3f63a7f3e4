"""Per-replica multi-model servable registry with LRU weight paging.

Counterpart of `kubeflow_tpu/serving/registry.py` (a module with no JAX
in it), on the port's batching queue and metrics. One server process
hosts N servables so that tenants share the card instead of each paying
for an idle fleet:

- **Per-model batching queues.** Every registered model owns its own
  `BatchingQueue`, so one slow or backed-up model can neither delay
  another model's flush window nor eat its pending budget.
- **LRU weight paging.** With ``max_resident`` set, only the most
  recently used models hold weights on the device and a scheduler
  thread; the rest cost a catalog entry. A request for a paged-out model
  triggers a *page-in* (the registry's factory rebuilds the servable: a
  checkpoint restore and a warm-up of every bucket), measured as
  `serving_page_in_seconds`. It blocks ONLY that model's callers:
  resident models keep flushing because the load runs outside the
  registry lock.
- **Crisp death.** `kill()` is the SIGKILL analog: every model's queued
  and in-flight work fails with `QueueClosed` (`ReplicaGone` at the
  router). `kill(model)` during a page-in fails only that model's
  waiting callers; the other queues never notice.

A roll arriving while a page-in is in flight waits the load out instead
of yanking the fresh queue, so the loading generation is never dropped
with callers parked on it.

On the device: a page-out drops every reference to the servable (the
catalog entry's, the queue's once its scheduler thread has been joined,
and a stored factory error's traceback), so the weights' memory goes
back to PyTorch's allocator and `torch.cuda.memory_allocated()` falls by
the model's bytes; nothing here calls `torch.cuda.empty_cache()`. A
page-in runs on the request thread that claimed it, on the current
stream, so the first flush of its queue is ordered after the weight
copies and the warm-up without an event.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import traceback
from typing import Any, Callable

from kubeflow_tpu_torch.serving.batching import (
    BatchingConfig,
    BatchingQueue,
    QueueClosed,
)
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


class ModelNotFound(KeyError):
    """No such model in the catalog (HTTP boundary maps this to 404 —
    distinct from a paged-out model, which is served after a page-in)."""


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """LRU weight-paging policy for one registry.

    ``max_resident`` bounds how many models hold live weights + a
    batcher thread at once; 0 means unlimited (paging off — every
    registered model stays resident once loaded)."""

    max_resident: int = 0

    def validate(self) -> None:
        if self.max_resident < 0:
            raise ValueError(
                f"paging.maxResident must be >= 0, got {self.max_resident}"
            )


# Catalog entry lifecycle: registered -> loading -> resident -> (paged
# out) registered. A whole-registry kill/close parks everything in
# "closed".
_REGISTERED = "registered"
_LOADING = "loading"
_RESIDENT = "resident"
_CLOSED = "closed"


class _ModelEntry:
    __slots__ = (
        "name", "rspec", "state", "queue", "servable", "version",
        "ready", "error", "last_used", "generation", "page_ins",
        "last_page_in_s",
    )

    def __init__(self, name: str, rspec: dict):
        self.name = name
        self.rspec = dict(rspec)
        self.state = _REGISTERED
        self.queue: BatchingQueue | None = None
        self.servable = None
        self.version = int(rspec.get("modelVersion", 0) or 0)
        # Signaled whenever a load settles (success, failure, or kill);
        # waiters re-check state under the lock — never trust the event
        # alone.
        self.ready = threading.Event()
        self.error: BaseException | None = None
        self.last_used = time.monotonic()
        # Bumped on every load claim and every kill: a page-in that
        # finishes after its generation moved on discards its queue
        # instead of resurrecting a killed/rolled model.
        self.generation = 0
        self.page_ins = 0
        self.last_page_in_s = 0.0


class ServableRegistry:
    """Thread-safe multi-model catalog: name → (servable, queue), with
    LRU paging. ``factory(rspec)`` builds a servable from a per-model
    replica spec dict (the same shape the controller pushes through
    ServingReplica objects)."""

    def __init__(
        self,
        factory: Callable[[dict], Any],
        *,
        batching: BatchingConfig | None = None,
        paging: PagingConfig | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        self._factory = factory
        self.batching = batching or BatchingConfig()
        self.paging = paging or PagingConfig()
        self.paging.validate()
        self._metrics = metrics or MetricsRegistry()
        self._lock = threading.Lock()
        self._entries: dict[str, _ModelEntry] = {}
        self._closed = False
        self.page_ins_total = self._metrics.counter(
            "serving_page_ins_total",
            "servable weight page-ins (cold loads included)",
            ("model",),
        )
        self.page_outs_total = self._metrics.counter(
            "serving_page_outs_total",
            "servables evicted to make room under maxResident",
            ("model",),
        )
        self.resident_models = self._metrics.gauge(
            "serving_resident_models",
            "models currently holding live weights",
        )
        self.page_in_seconds = self._metrics.gauge(
            "serving_page_in_seconds",
            "duration of the most recent page-in",
            ("model",),
        )

    # -- catalog -----------------------------------------------------------

    def ensure(self, rspec: dict) -> bool:
        """Register (or update the spec of) one model. Returns True when
        the catalog changed — a changed spec does NOT swap a resident
        servable by itself; `roll()` does that under drain."""
        name = rspec.get("model")
        if not name:
            raise ValueError("rspec.model must be non-empty")
        with self._lock:
            self._check_open_locked()
            entry = self._entries.get(name)
            if entry is None:
                self._entries[name] = _ModelEntry(name, rspec)
                return True
            changed = entry.rspec != dict(rspec)
            entry.rspec = dict(rspec)
            return changed

    def remove(self, name: str) -> None:
        """Unregister a model; its resident queue (if any) drains and
        closes. Unknown names are a no-op (idempotent reconcile)."""
        with self._lock:
            entry = self._entries.pop(name, None)
            queue = self._demote_locked(entry) if entry else None
            if entry is not None:
                entry.state = _CLOSED
                entry.error = QueueClosed(f"model {name!r} was removed")
                entry.ready.set()
        if queue is not None:
            queue.close()

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    # -- serving hot path --------------------------------------------------

    def predict(self, model: str, instances):
        """Serve one request for `model`, paging it in if needed. The
        per-model queue path: lookup + LRU touch under the registry lock,
        then straight into that model's own `BatchingQueue`; no other
        model's state is read or written."""
        while True:
            queue = self._resident_queue(model)
            try:
                return queue.predict(instances)
            except QueueClosed:
                # A closed queue still holds its servable: drop it before
                # the next pass, whose frames a stored error may keep.
                del queue
                # The queue closed between lookup and call: paged out or
                # rolled under us. Re-enter: the next pass pages the
                # model back in. Only a killed or closed registry, or a
                # removed model, re-raises. A page-out is not the
                # replica's death, and however often paging pressure
                # closes the queue under a caller (the JAX package gives
                # up after three passes), raising would make the router
                # mark a live replica dead.
                with self._lock:
                    entry = self._entries.get(model)
                    dead = (
                        self._closed
                        or entry is None
                        or entry.state == _CLOSED
                    )
                if dead:
                    raise

    def _resident_queue(self, model: str) -> BatchingQueue:
        """Return the model's live queue, claiming (or waiting out) a
        page-in when it is not resident. Only THIS model's callers ever
        wait here; the load itself runs outside the registry lock. A
        model paged in and out again before a waiter got to it is paged
        in anew (the JAX package raises `QueueClosed` there, which the
        router reads as the replica's death)."""
        while True:
            claim = False
            with self._lock:
                self._check_open_locked()
                entry = self._entries.get(model)
                if entry is None:
                    raise ModelNotFound(model)
                entry.last_used = time.monotonic()
                if entry.state == _RESIDENT:
                    return entry.queue
                if entry.state == _CLOSED:
                    raise QueueClosed(f"model {model!r} is closed")
                if entry.state == _REGISTERED:
                    claim = True
                    self._claim_load_locked(entry)
                generation = entry.generation
                ready = entry.ready
            if claim:
                self._page_in(entry, generation)
                settled = True
            else:
                settled = ready.wait(timeout=300.0)
            with self._lock:
                if entry.state == _RESIDENT:
                    return entry.queue
                error = entry.error
            if error is not None:
                # Every waiter raises the one stored error: start its
                # traceback afresh each time, or it would keep every
                # earlier raiser's frames.
                raise error.with_traceback(None)
            if not settled:
                raise QueueClosed(f"page-in of model {model!r} did not complete")

    def _claim_load_locked(self, entry: _ModelEntry) -> None:
        entry.state = _LOADING
        entry.generation += 1
        entry.ready = threading.Event()
        entry.error = None

    def _page_in(self, entry: _ModelEntry, generation: int) -> None:
        """Build the servable + queue OUTSIDE the lock (the measured
        event — checkpoint restore and bucket warmup on a real replica),
        then install it if our generation still owns the entry."""
        t0 = time.monotonic()
        try:
            servable = self._factory(dict(entry.rspec))
            queue = BatchingQueue(servable, self.batching, self._metrics)
        except BaseException as e:
            # Unwind even on KeyboardInterrupt/SystemExit (a model stuck
            # in _LOADING parks every future caller forever), but only
            # factory *errors* are recorded and swallowed; interrupts
            # re-raise after waking the parked callers. The stored error
            # outlives the load, so it is kept without its traceback: its
            # frames, and through them their callers' (a roll's old
            # queue), may hold weights on the device.
            log.warning("page-in of model %r failed:\n%s", entry.name,
                        "".join(traceback.format_exception(e)))
            e.with_traceback(None)
            with self._lock:
                if entry.generation == generation and (
                    entry.state == _LOADING
                ):
                    entry.state = _REGISTERED
                    entry.error = e
                    entry.ready.set()
            if not isinstance(e, Exception):
                raise
            return
        elapsed = time.monotonic() - t0
        stale = None
        victims: list[BatchingQueue] = []
        with self._lock:
            if (
                self._closed
                or entry.generation != generation
                or entry.state != _LOADING
            ):
                # Killed or rolled while loading: the fresh queue must
                # not resurrect the model.
                stale = queue
            else:
                entry.queue = queue
                entry.servable = servable
                entry.version = int(getattr(servable, "version", 0) or 0)
                entry.state = _RESIDENT
                entry.page_ins += 1
                entry.last_page_in_s = elapsed
                # Its parked callers use it next. Stamped at the claim, a
                # model whose load took seconds would be the LRU victim
                # of the next page-in before they reach its queue, and
                # their retries would page it in again, and again.
                entry.last_used = time.monotonic()
                self.page_ins_total.inc(model=entry.name)
                self.page_in_seconds.set(elapsed, model=entry.name)
                victims = self._evict_locked(keep=entry)
                self._update_resident_gauge_locked()
                entry.ready.set()
        if stale is not None:
            stale.close()
        for victim in victims:
            victim.close()

    # -- paging ------------------------------------------------------------

    def _evict_locked(self, keep: _ModelEntry) -> list[BatchingQueue]:
        """LRU page-out down to max_resident. Idle victims are preferred
        (their close() is instant); if every candidate has queued work
        the least-recently-used one drains — honest memory bound over
        latency. Returns the queues to close outside the lock."""
        limit = self.paging.max_resident
        if limit <= 0:
            return []
        victims: list[BatchingQueue] = []
        while True:
            resident = [
                e for e in self._entries.values()
                if e.state == _RESIDENT and e is not keep
            ]
            if len(resident) + 1 <= limit:
                break
            idle = []
            for e in resident:
                s = e.queue.stats() if e.queue is not None else {}
                if not s.get("queue_depth") and not s.get("inflight"):
                    idle.append(e)
            victim = min(
                idle or resident, key=lambda e: e.last_used
            )
            queue = self._demote_locked(victim)
            if queue is not None:
                victims.append(queue)
            self.page_outs_total.inc(model=victim.name)
        return victims

    def _demote_locked(self, entry: _ModelEntry) -> BatchingQueue | None:
        queue, entry.queue = entry.queue, None
        entry.servable = None
        if entry.state == _RESIDENT:
            entry.state = _REGISTERED
        return queue

    def _update_resident_gauge_locked(self) -> None:
        self.resident_models.set(
            sum(1 for e in self._entries.values() if e.state == _RESIDENT)
        )

    # -- roll / teardown ---------------------------------------------------

    def roll(self, model: str, rspec: dict | None = None) -> None:
        """Swap one model to its (possibly updated) spec: drain the old
        queue, page the new generation in. A page-in already in flight
        is waited out first — the roll never discards a loading
        generation with callers parked on it."""
        with self._lock:
            self._check_open_locked()
            entry = self._entries.get(model)
            if entry is None:
                raise ModelNotFound(model)
            if rspec is not None:
                entry.rspec = dict(rspec)
        while True:
            with self._lock:
                if entry.state != _LOADING:
                    break
                ready = entry.ready
            ready.wait(timeout=300.0)
        old_queue = None
        with self._lock:
            if entry.state == _CLOSED:
                raise QueueClosed(f"model {model!r} is closed")
            was_resident = entry.state == _RESIDENT
            if was_resident:
                old_queue = self._demote_locked(entry)
            self._claim_load_locked(entry)
            generation = entry.generation
            self._update_resident_gauge_locked()
        if old_queue is not None:
            old_queue.close()
        if was_resident:
            # Only a live model reloads eagerly; a paged-out one just
            # carries the new spec until its next page-in.
            self._page_in(entry, generation)
        else:
            with self._lock:
                if entry.generation == generation and (
                    entry.state == _LOADING
                ):
                    entry.state = _REGISTERED
                    entry.ready.set()

    def kill(self, model: str | None = None) -> None:
        """Hard stop. With a model name: fail ONLY that model's queued
        and in-flight work (including callers waiting on its page-in) —
        the other models' queues keep flushing, and the killed model can
        page back in on a later request. Without: the replica-death
        analog — everything fails with QueueClosed and the registry
        refuses further work."""
        queues: list[BatchingQueue] = []
        with self._lock:
            if model is not None:
                entries = [self._entries[model]]  # KeyError → caller bug
            else:
                entries = list(self._entries.values())
                self._closed = True
            for entry in entries:
                entry.generation += 1
                err = QueueClosed(
                    f"model {entry.name!r} was killed"
                    + (" during page-in" if entry.state == _LOADING else "")
                )
                if entry.queue is not None:
                    queues.append(entry.queue)
                queue = self._demote_locked(entry)
                del queue  # collected via `queues`
                entry.state = _CLOSED if model is None else _REGISTERED
                entry.error = err
                entry.ready.set()
            self._update_resident_gauge_locked()
        for queue in queues:
            queue.kill()

    def close(self) -> None:
        """Graceful teardown: every resident queue drains and stops."""
        queues: list[BatchingQueue] = []
        with self._lock:
            self._closed = True
            for entry in self._entries.values():
                if entry.queue is not None:
                    queues.append(entry.queue)
                self._demote_locked(entry)
                entry.state = _CLOSED
                entry.error = QueueClosed(
                    f"model {entry.name!r} is closed"
                )
                entry.ready.set()
            self._update_resident_gauge_locked()
        for queue in queues:
            queue.close()

    def _check_open_locked(self) -> None:
        if self._closed:
            raise QueueClosed("servable registry is closed")

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Per-model snapshot the replica adapter folds into its own
        stats() (and the controller into ServingDeployment status)."""
        with self._lock:
            entries = list(self._entries.values())
            resident = sum(1 for e in entries if e.state == _RESIDENT)
            per_model = {}
            for e in entries:
                row = {
                    "state": e.state,
                    "version": e.version,
                    "page_ins": e.page_ins,
                    "last_page_in_s": round(e.last_page_in_s, 6),
                }
                # Lock order registry → queue-cv, same as the eviction
                # scan; the queue never takes the registry lock back.
                if e.queue is not None:
                    row.update(e.queue.stats())
                per_model[e.name] = row
            closed = self._closed
        return {
            "models": per_model,
            "resident": resident,
            "closed": closed,
        }
