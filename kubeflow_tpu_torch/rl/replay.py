"""Bounded, resumable trajectory queue between actors and the learner.

Counterpart of `kubeflow_tpu/rl/replay.py`, with the same claim, push,
staleness, stall, resume and perturb rules. The JAX queue places each
batch it yields on the learner's mesh (``jax.device_put`` with a batch
sharding); this one moves it to the learner's ``device`` as torch
tensors.

One trajectory == one learner batch (``horizon * n_envs`` transitions):
that equality is what keeps the resumability contract exact — the
queue's ``position`` is simultaneously "batches the learner consumed"
and "trajectory indices retired", so the train/data protocol
(`state_dict`/`load_state_dict`/`perturb`, the same duck type `fit()`
already persists for synthetic streams) rides the checkpoint manifest
unchanged and a killed-and-resumed learner neither repeats nor drops a
trajectory index.

Actors `claim()` the next index (with the current salt), roll it out
through the serving stack, and `push()` the result; a push whose claim
ticket no longer matches the queue's state (a restore or an anomaly
rollback happened in between) is REJECTED and the actor just claims
again — in-flight stale work dies at the boundary instead of leaking
into the learner. Backpressure is applied at claim time (a bounded
window of outstanding indices past the learner's position), never at
push time: a blocked push would deadlock the in-order learner behind
the very gap the blocked actor holds.

Off-policy staleness bound (the IMPALA/Sebulba discipline): a
trajectory whose behavior-policy version lags the learner's step by
more than ``staleness_bound`` is DISCARDED at consumption time (counted
in ``stale_dropped``; versions are checkpoint steps, so the bound is in
learner steps). Dropping — not blocking — is deliberate: the
alternative deadlocks when a full buffer of stale work blocks the very
actors that could produce fresh work. With the stale backlog cleared
the learner blocks on an EMPTY buffer, which running actors always
relieve; if publication is wedged so badly that everything arriving is
stale, the stall timeout turns that into a loud `ReplayStalled` instead
of silent off-policy drift. (Resume-exactness is orthogonal: a staleness
drop is a counted policy decision, never a bookkeeping loss — restore
still repeats or skips no index.)

One departure from JAX: a push whose index is already buffered is
rejected. A restore to the checkpoint's salt leaves the tickets issued
before it valid (same salt, index past the restored position) and issues
their indices again; JAX's queue buffers both pushes, and the second
copy, left behind the position once the first is consumed, holds the
head forever (`ReplayStalled`). A learner resumed while its actors are
already claiming (the RL soak's ``learner_kill``) meets exactly that.

Not ported yet: `rebind`, the elastic resize's re-targeting of batch
placement at a new mesh (ROADMAP Queue 1 item 12); it raises.
"""

from __future__ import annotations

import threading
import time

import torch


class ReplayStalled(RuntimeError):
    """The learner waited past the stall timeout for admissible data —
    actors dead, a roll wedged, or the staleness gate starved."""


class ReplayQueue:
    """`device` is where the learner trains (the trainer's device): each
    batch it takes is moved there as torch tensors. None yields the
    actors' numpy arrays as they are."""

    def __init__(
        self,
        *,
        capacity: int = 8,
        staleness_bound: int = 10_000,
        device=None,
        stall_timeout_s: float = 120.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.staleness_bound = staleness_bound
        self.stall_timeout_s = stall_timeout_s
        self._device = torch.device(device) if device is not None else None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buf: list[tuple[int, int, dict]] = []  # (index, version, batch)
        self._position = 0      # trajectories consumed == batches yielded
        self._next_claim = 0    # next index handed to an actor
        self._returned: list[int] = []  # abandoned claims, re-issued first
        self._salt = 0
        self._max_seen_version = 0
        self._learner_step = 0
        self._closed = False
        self._draining = False
        # Observability for the bench/soak.
        self.rejected_pushes = 0
        self.stale_dropped = 0

    # -- actor side --------------------------------------------------------

    def claim(self) -> tuple[int, int]:
        """Reserve the next trajectory index; returns ``(index, salt)``.
        The ticket must be handed back verbatim to `push`.

        Backpressure lives HERE, not in `push`: a claim blocks while the
        index would fall outside the ``[position, position + capacity)``
        window. Blocking the push instead would deadlock — the buffer
        can fill with out-of-order successors while the actor holding
        the head index waits for space the learner (stuck on that very
        gap) can never free. An issued ticket always has buffer room by
        construction, so completed rollouts are never parked."""
        with self._cond:
            while True:
                if self._closed or self._draining:
                    # Don't wedge a shutting-down actor: hand out a
                    # ticket that will bounce at push.
                    break
                if self._returned:
                    return self._returned.pop(0), self._salt
                if self._next_claim < self._position + self.capacity:
                    break
                self._cond.wait(0.05)
            index = self._next_claim
            self._next_claim += 1
            return index, self._salt

    def abandon(self, index: int, salt: int) -> None:
        """Hand an unfinished claim back (the actor died mid-rollout or
        its predict path failed hard). Unfilled indices would otherwise
        leave a permanent gap the in-order learner stalls behind."""
        with self._cond:
            if salt == self._salt and index >= self._position:
                self._returned.append(index)
                self._returned.sort()
                self._cond.notify_all()

    def push(
        self, index: int, salt: int, version: int, batch: dict
    ) -> bool:
        """Deliver a completed trajectory. Never blocks: the claim
        window already bounded how far actors can outrun the learner,
        and a valid ticket's slot is guaranteed. Returns False — drop
        and re-claim — when the ticket went stale under a
        restore/rollback or the queue closed."""
        with self._cond:
            if self._closed or self._draining:
                return False
            if (salt != self._salt or index < self._position
                    or any(item[0] == index for item in self._buf)):
                # Stale, or a duplicate: a ticket issued before a restore
                # to the same salt, whose index was issued again after it.
                self.rejected_pushes += 1
                return False
            self._buf.append((index, int(version), batch))
            self._buf.sort(key=lambda item: item[0])
            self._max_seen_version = max(
                self._max_seen_version, int(version)
            )
            self._cond.notify_all()
            return True

    def note_learner_step(self, step: int) -> None:
        """The learner's clock for the staleness comparison (fed from
        the fit loop's metrics callback; versions are checkpoint steps,
        so the two sides share units)."""
        with self._lock:
            self._learner_step = max(self._learner_step, int(step))

    def drain_pushers(self) -> None:
        """The learner is done: release any actor blocked in `claim` on
        a closed window (and bounce subsequent pushes) so it can keep
        acting — observing the final publication — instead of
        freezing."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- learner side (the fit() data iterable) ----------------------------

    def __iter__(self):
        return self

    def _head_ready_locked(self) -> bool:
        # The head must be the next index in order — a later index
        # parked ahead of a gap means its predecessor is still in
        # flight (or was abandoned and will be re-claimed).
        return bool(self._buf) and self._buf[0][0] == self._position

    def __next__(self):
        deadline = time.monotonic() + self.stall_timeout_s
        with self._cond:
            while True:
                if self._head_ready_locked():
                    _, version, batch = self._buf[0]
                    # Consuming this batch puts the learner at step
                    # _learner_step + 1; enforce the off-policy bound
                    # against the version its actions came from.
                    if (
                        self._learner_step + 1 - version
                        > self.staleness_bound
                    ):
                        self._buf.pop(0)
                        self._position += 1
                        self.stale_dropped += 1
                        self._cond.notify_all()
                        continue
                    self._buf.pop(0)
                    self._position += 1
                    self._cond.notify_all()
                    break
                if self._closed:
                    raise StopIteration
                t0 = time.monotonic()
                if t0 >= deadline:
                    raise ReplayStalled(
                        f"no admissible trajectory for "
                        f"{self.stall_timeout_s:.0f}s (position="
                        f"{self._position} buffered={len(self._buf)} "
                        f"learner_step={self._learner_step} "
                        f"max_seen_version={self._max_seen_version} "
                        f"stale_dropped={self.stale_dropped} "
                        f"staleness_bound={self.staleness_bound})"
                    )
                self._cond.wait(min(0.05, deadline - t0))
        if self._device is not None:
            batch = {k: torch.as_tensor(v, device=self._device)
                     for k, v in batch.items()}
        return batch

    # -- train/data resumability protocol ----------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            return {"position": self._position, "salt": self._salt}

    def load_state_dict(self, state: dict) -> None:
        with self._cond:
            self._position = int(state["position"])
            self._salt = int(state["salt"])
            # Anything buffered or claimed was produced before the
            # restore point — invalidate it all; actors re-claim from
            # the restored position and in-flight pushes bounce off the
            # ticket check.
            self._buf.clear()
            self._returned.clear()
            self._next_claim = self._position
            self._cond.notify_all()

    def perturb(self, salt: int) -> None:
        """Anomaly-rollback re-seed (the guard's escape from a poisoned
        region): future trajectories draw different observations."""
        with self._cond:
            self._salt = int(salt)
            self._buf.clear()
            self._returned.clear()
            self._next_claim = self._position
            self._cond.notify_all()

    def rebind(self, mesh) -> "ReplayQueue":
        """Elastic resize's re-targeting of batch placement: not ported."""
        raise NotImplementedError(
            "ReplayQueue.rebind follows an elastic mesh resize, which is not "
            "ported yet (ROADMAP Queue 1 item 12)"
        )
