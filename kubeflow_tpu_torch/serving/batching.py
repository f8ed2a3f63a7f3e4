"""Cross-request dynamic batching: the TF-Serving batcher analog.

The port's own copy of `kubeflow_tpu/serving/batching.py` (a module with
no JAX in it), on the port's `utils/metrics.MetricsRegistry`. A model
step at batch 1 leaves the card's tensor cores nearly idle, so
`BatchingQueue` merges concurrent small requests into one execution of
its servable:

- callers block in `predict()` while their instances join the pending
  batch;
- a scheduler thread flushes when the batch fills (`max_batch`) or the
  OLDEST entry has waited `timeout_ms` (TF-Serving's
  `batch_timeout_micros`);
- each flush groups entries by per-instance signature (shape, dtype)
  and runs one `Servable.predict` per group (the servable's bucket
  padding handles the ragged tail); each caller gets exactly its rows
  back, and a failed execution fails only the callers of its own group.

**Continuous batching**: when a flush is already cut, each signature
group *late-admits* compatible requests that arrived after the cut, up
to `max_batch`, just before it executes, so a request that misses a cut
rides the window about to run instead of waiting out the whole execution
plus its own timeout. The admission is host-side list surgery under the
queue lock: the flush path gains no device work and no sync.

Backpressure rejects with `QueueFull` (the server answers 429) once
`max_pending` instances wait. The queue exports its depth and in-flight
gauges through `MetricsRegistry` and a `stats()` snapshot; `kill()`
fails every pending and in-flight caller at once.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Sequence

import numpy as np

from kubeflow_tpu_torch.utils.metrics import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """TF-Serving batching knobs (batching_config.txt analog)."""

    max_batch: int = 64
    timeout_ms: float = 5.0
    # Backpressure: pending instances beyond this reject immediately
    # (TF-Serving's max_enqueued_batches) instead of growing the queue
    # unboundedly under overload.
    max_pending: int = 1024


class _Entry:
    __slots__ = (
        "instances", "event", "result", "error", "arrived", "signature",
    )

    def __init__(self, instances: np.ndarray, servable):
        self.instances = instances
        self.event = threading.Event()
        self.result: np.ndarray | None = None
        self.error: BaseException | None = None
        self.arrived = time.monotonic()
        # Computed ONCE at admission: the scheduler re-reads it on every
        # cut, grouping pass, and late-admission scan — under the queue
        # lock, where per-entry tuple building was pure contention.
        self.signature = _signature(servable, instances)


def _signature(servable, instances: np.ndarray) -> tuple:
    """Flush-group key: ``(model, version, shape-sans-batch, dtype)``.

    Queues are per-servable, so within one queue the first two elements
    are constant; the key carries them anyway, so that two models' (or
    two generations') rows never merge into one device execution even if
    flush windows are ever pooled across queues."""
    return (
        servable.name,
        getattr(servable, "version", 0),
        instances.shape[1:],
        instances.dtype.str,
    )


class QueueFull(RuntimeError):
    """Backpressure signal (the server maps it to HTTP 429 with a
    Retry-After header: `serving/server.py`)."""


class QueueClosed(RuntimeError):
    """The queue was shut down (e.g. its servable version was reloaded);
    a retry against a fresh queue is expected to succeed."""


class BatchingQueue:
    """Thread-safe dynamic batcher over one servable."""

    def __init__(
        self,
        servable,
        config: BatchingConfig | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        self.servable = servable
        self.config = config or BatchingConfig()
        metrics = metrics or MetricsRegistry()
        self.batches_total = metrics.counter(
            "serving_batches_total", "accelerator executions", ("model",)
        )
        self.batched_instances_total = metrics.counter(
            "serving_batched_instances_total",
            "instances served through the batcher",
            ("model",),
        )
        self.rejected_total = metrics.counter(
            "serving_batch_rejected_total",
            "requests rejected by backpressure",
            ("model",),
        )
        self.late_admitted_total = metrics.counter(
            "serving_batch_late_admitted_total",
            "requests admitted into an already-cut flush window",
            ("model",),
        )
        # The autoscaler's input signal (ServingDeployment status rides
        # on the same numbers via stats()).
        self.queue_depth = metrics.gauge(
            "serving_queue_depth",
            "instances waiting in the batching queue",
            ("model",),
        )
        self.inflight_batches = metrics.gauge(
            "serving_inflight_batches",
            "accelerator batches currently executing",
            ("model",),
        )
        self._cv = threading.Condition()
        # Deque, not list: _cut_locked consumes from the head, and under
        # a deep queue list.pop(0) made every cut O(pending) while
        # holding the lock every caller needs.
        self._pending: collections.deque[_Entry] = collections.deque()
        self._pending_count = 0
        self._inflight: list[_Entry] = []
        self._wait_ewma_ms = 0.0
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop,
            name=f"batcher-{servable.name}-v{servable.version}",
            daemon=True,
        )
        self._thread.start()

    # -- caller side -------------------------------------------------------

    def predict(self, instances: Sequence) -> np.ndarray:
        batch = np.asarray(instances)
        if batch.shape[0] == 0:
            raise ValueError("empty instances")
        entry = _Entry(batch, self.servable)
        with self._cv:
            if self._closed:
                raise QueueClosed(
                    f"batching queue for {self.servable.name!r} is closed"
                )
            # Backpressure gates on what's ALREADY queued, not the new
            # request's own size — an oversized request on an idle server
            # must be admitted (the servable chunks it), or its retries
            # would fail forever.
            if self._pending_count >= self.config.max_pending:
                self.rejected_total.inc(model=self.servable.name)
                raise QueueFull(
                    f"batching queue for {self.servable.name!r} is full "
                    f"({self._pending_count} pending)"
                )
            was_empty = not self._pending
            prev_count = self._pending_count
            self._pending.append(entry)
            self._pending_count += batch.shape[0]
            self.queue_depth.set(
                self._pending_count, model=self.servable.name
            )
            # Wake the scheduler only when this admission changes what
            # it would do: first entry arms the timeout window (it is
            # parked in an untimed wait), and crossing max_batch makes
            # the cut due early. Everything else it discovers on its own
            # timed wakeup.
            if was_empty or (
                prev_count < self.config.max_batch <= self._pending_count
            ):
                self._cv.notify()
        entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def stats(self) -> dict:
        """Snapshot of the autoscaling signal: queued instances, instances
        executing right now, and an EWMA of the queue wait (ms)."""
        with self._cv:
            return {
                "queue_depth": self._pending_count,
                "inflight": sum(
                    e.instances.shape[0] for e in self._inflight
                ),
                "queue_wait_ms": round(self._wait_ewma_ms, 3),
                "closed": self._closed,
            }

    def close(self) -> None:
        """Flush and stop; in-flight callers complete, later ones error."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def kill(self) -> None:
        """Hard stop (chaos / replica-death simulation): unlike close(),
        nothing drains — pending AND in-flight callers fail immediately
        with QueueClosed, the way a SIGKILLed replica's open connections
        reset."""
        with self._cv:
            self._closed = True
            pending, self._pending = (
                list(self._pending), collections.deque()
            )
            self._pending_count = 0
            self.queue_depth.set(0, model=self.servable.name)
            inflight = list(self._inflight)
            self._cv.notify_all()
        err = QueueClosed(
            f"batching queue for {self.servable.name!r} was killed"
        )
        for entry in pending + inflight:
            if not entry.event.is_set():
                entry.error = err
                entry.event.set()

    # -- scheduler ---------------------------------------------------------

    def _take_batch(self) -> list[_Entry]:
        """Block until a flush is due; returns the entries to run (empty
        only when closing). Flush when pending fills max_batch, or the
        oldest entry's deadline passes, or the queue is closing (drain)."""
        timeout = self.config.timeout_ms / 1000.0
        with self._cv:
            while True:
                if self._pending and (
                    self._closed
                    or self._pending_count >= self.config.max_batch
                ):
                    return self._cut_locked()
                if not self._pending:
                    if self._closed:
                        return []
                    self._cv.wait()
                    continue
                # Entries pending but batch not full: the window closes
                # `timeout` after the OLDEST entry arrived — a steady
                # trickle of arrivals must not extend the oldest caller's
                # wait indefinitely.
                remaining = self._pending[0].arrived + timeout - time.monotonic()
                if remaining <= 0 or not self._cv.wait(remaining):
                    return self._cut_locked()

    def _cut_locked(self) -> list[_Entry]:
        take: list[_Entry] = []
        count = 0
        while self._pending:
            nxt = self._pending[0]
            n = nxt.instances.shape[0]
            if take and count + n > self.config.max_batch:
                break  # next entry rides the following flush
            take.append(self._pending.popleft())
            count += n
            if count >= self.config.max_batch:
                break
        self._pending_count -= count
        self.queue_depth.set(self._pending_count, model=self.servable.name)
        self._record_wait_locked(take)
        # Becomes in-flight the instant it leaves pending, under the same
        # lock — a kill() racing the cut must find every caller in one of
        # the two lists or it would strand them on an unset event.
        self._inflight = list(take)
        return take

    def _record_wait_locked(self, entries: list[_Entry]) -> None:
        now = time.monotonic()
        for e in entries:
            wait_ms = (now - e.arrived) * 1000.0
            self._wait_ewma_ms += 0.2 * (wait_ms - self._wait_ewma_ms)

    def _admit_late(self, key: tuple, count: int) -> list[_Entry]:
        """Continuous batching: pull compatible pending entries into the
        group that is ABOUT to execute, up to max_batch. Host-side list
        surgery under the queue lock only — the flush path gains no
        device work or sync."""
        with self._cv:
            taken: list[_Entry] = []
            kept: list[_Entry] = []
            for e in self._pending:
                n = e.instances.shape[0]
                if (
                    count + n <= self.config.max_batch
                    and e.signature == key
                ):
                    taken.append(e)
                    count += n
                else:
                    kept.append(e)
            if taken:
                # Mismatched entries stay IN ARRIVAL ORDER — the next
                # cut still honors the oldest caller's deadline.
                self._pending = collections.deque(kept)
                admitted = sum(e.instances.shape[0] for e in taken)
                self._pending_count -= admitted
                self.queue_depth.set(
                    self._pending_count, model=self.servable.name
                )
                self.late_admitted_total.inc(
                    len(taken), model=self.servable.name
                )
                self._record_wait_locked(taken)
                # kill() must cover late admissions too — they are
                # in-flight the moment they leave pending.
                self._inflight.extend(taken)
            return taken

    def _loop(self) -> None:
        while True:
            entries = self._take_batch()
            if not entries:
                return  # closed and drained
            # Group by per-instance signature (shape-sans-batch, dtype):
            # requests only merge with compatible neighbors (TF-Serving
            # batches per signature too), so one client's odd-shaped
            # input can neither break the concatenate nor fail innocent
            # requests sharing the flush.
            groups: dict = {}
            for entry in entries:
                groups.setdefault(entry.signature, []).append(entry)
            try:
                for key, group in groups.items():
                    self._run_group(key, group)
            except BaseException as e:
                # An interrupt/exit is taking this scheduler thread
                # down: close the queue and unblock EVERY caller that
                # hasn't been signalled yet (later signature groups in
                # this flush, plus everything still pending), then let
                # it propagate — a dying batcher must never leave a
                # predict() parked on an event nobody will set.
                self._abort(entries, e)
                raise
            finally:
                with self._cv:
                    self._inflight = []
                    self.inflight_batches.set(0, model=self.servable.name)

    def _abort(self, entries: list[_Entry], e: BaseException) -> None:
        with self._cv:
            self._closed = True  # later predict() gets QueueClosed
            pending, self._pending = (
                list(self._pending), collections.deque()
            )
            self._pending_count = 0
            self.queue_depth.set(0, model=self.servable.name)
            inflight, self._inflight = self._inflight, []
            self._cv.notify_all()
        for entry in entries + inflight + pending:
            if not entry.event.is_set():
                entry.error = e
                entry.event.set()

    def _run_group(self, key: tuple, group: list[_Entry]) -> None:
        group = group + self._admit_late(
            key, sum(e.instances.shape[0] for e in group)
        )
        self.inflight_batches.set(1, model=self.servable.name)
        try:
            # A flush window holding ONE entry (the batch-1 steady state
            # at low concurrency) skips the concatenate — np.concatenate
            # copies even for a single input, and this is the hot path.
            merged = (
                group[0].instances
                if len(group) == 1
                else np.concatenate(
                    [e.instances for e in group], axis=0
                )
            )
            out = self.servable.predict(merged)
        except BaseException as e:
            # Execution failures propagate to THIS group only. An
            # interrupt/exit also fails the group (the callers must not
            # hang), then re-raises so _loop can abort the rest of the
            # flush and die loudly instead of swallowing a shutdown.
            for entry in group:
                entry.error = e
                entry.event.set()
            if not isinstance(e, Exception):
                raise
            return
        self.batches_total.inc(model=self.servable.name)
        self.batched_instances_total.inc(
            merged.shape[0], model=self.servable.name
        )
        offset = 0
        for entry in group:
            n = entry.instances.shape[0]
            entry.result = out[offset:offset + n]
            offset += n
            entry.event.set()
