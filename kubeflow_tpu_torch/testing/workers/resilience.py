"""One incarnation of the kill-and-resume soak: a real guarded `fit()`.

Counterpart of the JAX package's `tests/e2e/resilience_worker.py`, its
non-elastic part. A caller (`tests/test_torch_train_resilience.py`) runs
this worker again and again against one checkpoint directory while it
consumes a seeded `testing/chaos.TrainFaultSchedule`:

    python -m kubeflow_tpu_torch.testing.workers.resilience

The worker delivers its planned crash signal to itself from inside the
data iterator: a real SIGKILL between steps, or a real SIGTERM mid-step
that `fit()` honours at the next boundary after an emergency save. It
trains the port's `TinyMLP` on `SyntheticImages` varying per step, with
the planned loss spikes (`SpikedData`) and the guard armed after the
plan's `DEFAULT_GUARD_WARMUP` steps, and appends a JSONL trace (the
boot, every step with its data position, and the final state) from
which the caller rebuilds the run.

One departure from the JAX worker: the SIGKILL first waits for the
checkpointer's pending writes. The plan aims its storage faults at the
``max_to_keep`` newest steps, and the soak's steps take milliseconds
while the saves do not, so under load a kill that tore the newest
saves left a fault nothing to damage. A kill that lands inside an
asynchronous save is driven on its own, at three fixed points of the
write (`tests/test_torch_train_resilience.py`).

Env (the JAX worker's names):

- ``KFTPU_CKPT_DIR``, ``KFTPU_TRACE_FILE``, ``KFTPU_TOTAL_STEPS``,
  ``KFTPU_SAVE_INTERVAL``, ``KFTPU_DATA_SEED``, ``KFTPU_INCARNATION``;
- ``KFTPU_SPIKE_STEPS``: comma-separated batch positions to poison;
- ``KFTPU_CRASH_STEP`` and ``KFTPU_CRASH_SIGNAL`` (``kill`` or
  ``sigterm``): the planned crash, if any;
- ``KFTPU_DEVICE``: ``cpu`` runs on the CPU (the tests); unset, CUDA.

Elastic runs (JAX's ``KFTPU_ELASTIC_PLAN``, ``KFTPU_RESIZE_FILE``) are
refused: `fit(elastic=)` waits for ROADMAP Queue 1 item 12.

Exit codes: 0 completed; 75 preempted (`fit` returned `Preempted`);
killed by the signal otherwise.
"""

from __future__ import annotations

import json
import os
import signal as signal_module
import sys
import time

EXIT_PREEMPTED = 75


def build_trainer(total_steps: int, device: str | None):
    """The soak's `Trainer`: `TinyMLP` under the guard that skips the
    planned spikes."""
    from kubeflow_tpu_torch.testing.chaos import DEFAULT_GUARD_WARMUP
    from kubeflow_tpu_torch.testing.tinymodels import TinyMLP
    from kubeflow_tpu_torch.train import AnomalyGuard, GuardConfig, TrainConfig, Trainer

    config = TrainConfig(batch_size=8, learning_rate=0.05, warmup_steps=2,
                         total_steps=total_steps, fsdp_params=False, weight_decay=0.0)
    guard = AnomalyGuard(GuardConfig(ewma_alpha=0.2, warmup_steps=DEFAULT_GUARD_WARMUP,
                                     loss_spike_factor=3.0, grad_spike_factor=6.0,
                                     max_consecutive_skips=3))
    return Trainer(TinyMLP(8 * 8 * 3, device=device), config, device=device, guard=guard)


def main() -> int:
    for name in ("KFTPU_ELASTIC_PLAN", "KFTPU_RESIZE_FILE"):
        if os.environ.get(name):
            raise SystemExit(f"{name}: elastic resize is not ported yet "
                             "(ROADMAP Queue 1 item 12)")
    total_steps = int(os.environ["KFTPU_TOTAL_STEPS"])
    save_interval = int(os.environ["KFTPU_SAVE_INTERVAL"])
    seed = int(os.environ["KFTPU_DATA_SEED"])
    spikes = [int(s) for s in os.environ.get("KFTPU_SPIKE_STEPS", "").split(",") if s]
    crash_step = os.environ.get("KFTPU_CRASH_STEP")
    crash_signal = os.environ.get("KFTPU_CRASH_SIGNAL")
    incarnation = int(os.environ.get("KFTPU_INCARNATION", "0"))
    device = os.environ.get("KFTPU_DEVICE") or None

    trace = open(os.environ["KFTPU_TRACE_FILE"], "a")

    def emit(event: str, **fields) -> None:
        trace.write(json.dumps({"event": event, "incarnation": incarnation,
                                "t": time.time(), **fields}) + "\n")
        trace.flush()
        os.fsync(trace.fileno())

    emit("boot")

    import torch

    from kubeflow_tpu_torch.testing.chaos import ResumableWrapper, SpikedData
    from kubeflow_tpu_torch.train import Checkpointer, Preempted, SyntheticImages, fit

    class CrashInjector(ResumableWrapper):
        """Delivers `signum` to this process when the batch at `at_step`
        comes up. SIGKILL lands between steps (preemption without
        warning), once the checkpointer's pending writes are on disk
        (the departure above; lm_job waits the same way). SIGTERM is
        flagged by fit's handler and honoured at the boundary after the
        step in flight."""

        def __init__(self, data, at_step: int, signum: int):
            super().__init__(data)
            self.at_step = at_step
            self.signum = signum
            self._fired = False

        def transform(self, pos: int, batch):
            if not self._fired and pos >= self.at_step:
                self._fired = True
                if self.signum == signal_module.SIGKILL:
                    ckpt.wait()
                os.kill(os.getpid(), self.signum)
            return batch

    trainer = build_trainer(total_steps, device)
    guard = trainer.guard
    data = SyntheticImages(trainer.config.batch_size, image_size=8, num_classes=10, seed=seed,
                           vary_per_step=True, device=device)
    data = SpikedData(data, spikes, scale=1e3)
    ckpt = Checkpointer(os.environ["KFTPU_CKPT_DIR"], save_interval_steps=save_interval,
                        max_to_keep=3)
    if crash_step is not None:
        signum = signal_module.SIGKILL if crash_signal == "kill" else signal_module.SIGTERM
        data = CrashInjector(data, int(crash_step), signum)

    def on_metrics(step: int, rec: dict) -> None:
        emit("step", step=step, position=data.state_dict()["position"], loss=rec["loss"],
             skips=rec["guard_skipped_total"])

    result = fit(trainer, data, total_steps=total_steps, checkpointer=ckpt, log_every=1,
                 on_metrics=on_metrics)
    ckpt.close()

    if isinstance(result, Preempted):
        emit("preempted", step=int(result.state.step), signum=result.signum)
        print(f"PREEMPTED step={int(result.state.step)}", flush=True)
        return EXIT_PREEMPTED

    with torch.no_grad():
        params_l1 = float(sum(p.abs().sum() for p in result.state.model.parameters()))
    emit("done", step=int(result.state.step), position=data.state_dict()["position"],
         final_loss=result.history[-1]["loss"], params_l1=params_l1,
         skips=guard.skipped_total(result.state.guard), resumed_from=result.resumed_from)
    print(f"DONE step={int(result.state.step)} l1={params_l1:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
