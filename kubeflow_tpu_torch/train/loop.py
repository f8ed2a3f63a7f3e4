"""The training loop: resume, step, guard, checkpoint, report.

Counterpart of `kubeflow_tpu/train/loop.py`, with the same failure
semantics:

- **Auto-resume.** `fit` restores the newest valid checkpoint
  (`train/checkpoint.py` verifies manifests and falls back past
  corruption) and, when the data implements the resumable-data protocol
  (``state_dict``/``load_state_dict``), repositions it from the state
  saved with that checkpoint, so a restarted run neither repeats nor
  skips batches.
- **Anomaly guard.** A trainer built with an `AnomalyGuard` screens every
  step on the device and skips non-finite or spiking updates, so a NaN
  at a step between saves never reaches a checkpoint. On sustained
  divergence the loop rolls back to the last checkpoint and perturbs the
  data (``perturb(salt)``), at most ``max_rollbacks`` times.
- **Preemption.** SIGTERM or SIGINT is caught and honoured at the next
  step boundary: one forced save (with the data state), then a
  `Preempted` result. The handlers are installed only on the main thread
  and restored on exit.

Not ported yet: elastic resize (``elastic=``, `ElasticResize`), which
reshapes a multi-device mesh at a step boundary; it raises
`NotImplementedError` (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import signal as signal_module
import sys
import time
from typing import Any, Callable, Iterable

import torch

from kubeflow_tpu_torch.train.checkpoint import Checkpointer
from kubeflow_tpu_torch.train.profiling import Profiler
from kubeflow_tpu_torch.train.trainer import Trainer, TrainState

log = logging.getLogger(__name__)


class TrainingDiverged(RuntimeError):
    """The loss became non-finite (a run without a guard) or the guard
    used up its rollbacks: restart from the last checkpoint with another
    seed or schedule rather than continue."""


@dataclasses.dataclass(frozen=True)
class ResizeProposal:
    """An elastic-resize target (kept for the API; `fit` refuses
    ``elastic=`` until the multi-device layer is ported)."""

    dp: int
    source: str = "live"

    def __post_init__(self) -> None:
        if self.source not in ("live", "checkpoint"):
            raise ValueError(
                f"ResizeProposal.source must be 'live' or 'checkpoint', "
                f"got {self.source!r}"
            )


@dataclasses.dataclass(frozen=True)
class ResizeEvent:
    """One completed mesh resize (JAX's `FitResult.resizes` entries)."""

    step: int
    from_dp: int
    to_dp: int
    source: str
    seconds: float
    absorbed_signum: int | None = None
    restored_step: int | None = None


@dataclasses.dataclass
class ElasticResize:
    """JAX's elastic gang-resize driver; `fit` raises on it here."""

    mesh_factory: Callable[[int], Any]
    data_factory: Callable[[Any, Any], Any]
    propose: Callable[[int, bool], ResizeProposal | None]
    on_resize: Callable[[ResizeEvent], None] | None = None


@dataclasses.dataclass
class FitResult:
    state: TrainState
    history: list[dict]
    steps_done: int
    resumed_from: int | None
    # Divergence rollbacks taken (guarded runs; 0 otherwise).
    rollbacks: int = 0
    # Elastic resizes (always empty: elastic resize is not ported).
    resizes: list[ResizeEvent] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Preempted(FitResult):
    """`fit` saw SIGTERM or SIGINT and stopped at a step boundary after a
    forced save: resume from the checkpoint to continue with no lost
    step."""

    signum: int | None = None


def _data_state(data: Any) -> dict | None:
    sd = getattr(data, "state_dict", None)
    return sd() if callable(sd) else None


def _load_data_state(data: Any, state: dict | None) -> None:
    ld = getattr(data, "load_state_dict", None)
    if state is not None and callable(ld):
        ld(state)


def fit(
    trainer: Trainer,
    data: Iterable[dict],
    total_steps: int,
    *,
    rng: int | torch.Generator | None = None,
    checkpointer: Checkpointer | None = None,
    log_every: int = 50,
    on_metrics: Callable[[int, dict], None] | None = None,
    profiler: Profiler | None = None,
    handle_signals: bool = True,
    max_rollbacks: int = 3,
    elastic: ElasticResize | None = None,
) -> FitResult:
    """Train for `total_steps` global steps, resuming if possible.

    Without a checkpoint to resume from, the run starts from
    `trainer.init_state(rng)`: `rng` (a seed or an explicit
    `torch.Generator`) draws the model's parameters anew; None keeps the
    parameters the model holds. It runs on the trainer's device (CUDA
    unless the trainer was built with ``device="cpu"``).

    `handle_signals=False` leaves SIGTERM/SIGINT to the caller.
    `max_rollbacks` bounds divergence rollbacks before `TrainingDiverged`.
    """
    if elastic is not None:
        raise NotImplementedError(
            "elastic resize reshapes a multi-device mesh, which is not "
            "ported yet (ROADMAP Queue 1 item 12)"
        )
    guard = trainer.guard

    resumed_from = None
    state = None
    if checkpointer is not None:
        restored = checkpointer.restore_latest(trainer.abstract_state())
        if restored is not None:
            state = trainer.load_state_dict(restored.state)
            resumed_from = int(restored.step)
            _load_data_state(data, restored.data_state)
    if state is None:
        state = trainer.init_state(rng)

    start_step = int(state.step)
    if start_step >= total_steps:
        log.info(
            "checkpoint already at step %d >= total_steps %d; nothing to do",
            start_step, total_steps,
        )
        return FitResult(state=state, history=[], steps_done=0,
                         resumed_from=resumed_from)

    step_fn = trainer.make_train_step()
    it = iter(data)
    history: list[dict] = []
    t_last = time.perf_counter()
    examples = 0
    rollbacks = 0
    preempt: dict = {"signum": None}
    installed: dict = {}
    if handle_signals:
        def _restore_handlers() -> None:
            for sig, prev in installed.items():
                # None: the earlier handler was installed outside Python.
                signal_module.signal(
                    sig, prev if prev is not None else signal_module.SIG_DFL)

        def _on_signal(signum, frame):
            if preempt["signum"] is not None:
                # A second delivery (nothing reached a boundary since):
                # restore the earlier disposition and deliver it again.
                _restore_handlers()
                os.kill(os.getpid(), signum)
                return
            # Flag only: the loop honours it at the next step boundary.
            preempt["signum"] = signum

        try:
            for sig in (signal_module.SIGTERM, signal_module.SIGINT):
                installed[sig] = signal_module.signal(sig, _on_signal)
        except ValueError:  # not the main thread: the caller owns signals
            installed = {}

    def check_finite(metrics, step: int) -> float:
        loss = float(metrics["loss"])
        if not math.isfinite(loss):
            # Runs before any save at this step: never persisted.
            raise TrainingDiverged(f"non-finite loss {loss} at step {step}")
        return loss

    def rollback(step: int) -> tuple[TrainState, int]:
        """Divergence: restore the last good checkpoint and perturb the
        data so that the retried trajectory differs."""
        nonlocal it
        restored = (
            checkpointer.restore_latest(trainer.abstract_state())
            if checkpointer is not None else None
        )
        if restored is None:
            raise TrainingDiverged(
                f"sustained divergence at step {step} and no checkpoint "
                "to roll back to"
            )
        perturb = getattr(data, "perturb", None)
        if (
            restored.data_state is None
            or not callable(getattr(data, "load_state_dict", None))
            or not callable(perturb)
        ):
            # Without resumable data the replayed steps would take batches
            # that do not match their step numbers; without perturb() the
            # replay diverges the same way. Refuse rather than burn the
            # rollback budget.
            raise TrainingDiverged(
                f"sustained divergence at step {step}: rollback needs "
                "resumable, perturbable data (state_dict/"
                "load_state_dict/perturb); restart manually from the last "
                "checkpoint with a different data order instead"
            )
        _load_data_state(data, restored.data_state)
        # A salt past the checkpoint's own and past this process's earlier
        # attempts: every retry is a new trajectory.
        salt = int(restored.data_state.get("salt", 0)) + rollbacks
        perturb(salt)
        # Durable now: a crash before the next save resumes onto the new
        # salt, not the one that diverged.
        checkpointer.update_data_state(int(restored.step), _data_state(data))
        it = iter(data)
        log.warning(
            "anomaly guard: sustained divergence at step %d; rolled back "
            "to checkpoint step %d (rollback %d/%d, data salt -> %d)",
            step, restored.step, rollbacks, max_rollbacks, salt,
        )
        return trainer.load_state_dict(restored.state), int(restored.step)

    result: FitResult | None = None
    step = start_step
    try:
        while step < total_steps:
            try:
                batch = next(it)
            except StopIteration:
                raise ValueError(
                    f"data iterable exhausted at step {step} "
                    f"(needed {total_steps})"
                ) from None
            if profiler is not None:
                profiler.before_step(step)
            state, metrics = step_fn(state, batch)
            if profiler is not None:
                profiler.after_step(step)
            step += 1
            examples += trainer.config.batch_size
            is_last = step == total_steps
            preempted = preempt["signum"] is not None
            want_save = checkpointer is not None and (
                checkpointer.should_save(step) or is_last
            )
            # A preempted boundary always logs.
            want_log = step % log_every == 0 or is_last or preempted

            # The guard's state is read on the host only at boundaries
            # that sync anyway.
            if guard is not None and (want_save or want_log or preempted):
                if guard.diverged(state.guard):
                    if preempted or rollbacks >= max_rollbacks:
                        raise TrainingDiverged(
                            f"sustained divergence at step {step} after "
                            f"{rollbacks} rollback(s)"
                        )
                    rollbacks += 1
                    state, step = rollback(step)
                    continue

            saved = False
            if want_save:
                if guard is None:
                    check_finite(metrics, step)
                checkpointer.save(step, state, force=is_last or preempted,
                                  data_state=_data_state(data))
                saved = True
            if want_log:
                if guard is None:
                    loss = check_finite(metrics, step)
                else:
                    # A skipped step may log a non-finite loss: its update
                    # was rejected on the device, the state stayed finite.
                    loss = float(metrics["loss"])
                now = time.perf_counter()
                rec = {
                    "step": step,
                    "loss": loss,
                    "accuracy": float(metrics.get("accuracy", float("nan"))),
                    "examples_per_sec": examples / (now - t_last),
                }
                if guard is not None:
                    rec["grad_norm"] = float(metrics["grad_norm"])
                    rec["guard_skipped_total"] = int(metrics["guard_skipped_total"])
                    rec["rollbacks"] = rollbacks
                history.append(rec)
                if on_metrics is not None:
                    on_metrics(step, rec)
                log.info(
                    "step %d loss %.4f acc %.3f %.1f ex/s",
                    rec["step"], rec["loss"], rec["accuracy"],
                    rec["examples_per_sec"],
                )
                t_last, examples = now, 0
            if preempted:
                if checkpointer is not None and not saved:
                    checkpointer.save(step, state, force=True,
                                      data_state=_data_state(data))
                log.warning(
                    "preemption signal %s honored at step %d: %s, exiting cleanly",
                    preempt["signum"], step,
                    "emergency save done" if checkpointer is not None
                    else "NO checkpointer — progress not saved",
                )
                result = Preempted(
                    state=state, history=history,
                    steps_done=step - start_step, resumed_from=resumed_from,
                    rollbacks=rollbacks, signum=preempt["signum"],
                )
                break
    finally:
        # Even while an exception unwinds: restore the signal disposition,
        # make enqueued saves durable and close a live trace.
        if installed:
            _restore_handlers()
        if profiler is not None:
            profiler.close()
        if checkpointer is not None:
            if sys.exc_info()[0] is None:
                # A clean exit claims its saves are safe: a failure is
                # the result.
                checkpointer.wait()
            else:
                # Another exception is the story; a wait() failure must
                # not replace it.
                try:
                    checkpointer.wait()
                except Exception:
                    log.exception(
                        "checkpoint wait failed while another exception "
                        "was unwinding"
                    )

    if result is not None:
        return result
    return FitResult(
        state=state, history=history, steps_done=total_steps - start_step,
        resumed_from=resumed_from, rollbacks=rollbacks,
    )
