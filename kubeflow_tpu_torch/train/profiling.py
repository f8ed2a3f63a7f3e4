"""Profiling: windowed `torch.profiler` capture for training jobs, named
trace regions, per-phase timing and roofline, a JSONL metrics sink.

Counterpart of `kubeflow_tpu/train/profiling.py`:

- `Profiler` traces steps [start, start + num_steps) of a run (relative
  to its first step, so a resumed run skips its warm-up too) with
  `torch.profiler` (CPU and, on a GPU, CUDA activity) and writes the
  trace where TensorBoard's PyTorch profiler plugin reads it
  (`torch.profiler.tensorboard_trace_handler`: ``<logdir>/*.pt.trace.json``).
  `close()` ends a live trace, so a run that fails still leaves one.
- `annotate` / `annotated_scope` name regions on the trace
  (`torch.profiler.record_function`).
- `time_phase` times a phase; on a GPU it syncs the device and reads
  CUDA events. `PhaseRoofline` classifies each timed phase against the
  card's peaks: an NVIDIA H100 SXM's dense bf16 tensor-core rate and HBM3
  bandwidth (NVIDIA's data sheet, at the full 700 W), with JAX's
  thresholds.
- `MetricsLogger` appends step records to ``metrics.jsonl`` beside the
  traces.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import logging
import pathlib
import time
from typing import Any

import torch

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ProfileSchedule:
    """Trace `num_steps` steps, beginning `start_step` steps after this
    process's first step."""

    start_step: int = 10  # skip the warm-up by default
    num_steps: int = 3

    def validate(self) -> None:
        if self.start_step < 0 or self.num_steps < 1:
            raise ValueError("start_step >= 0 and num_steps >= 1 required")


class Profiler:
    """Windowed trace capture driven by the training loop: call
    `before_step(step)` and `after_step(step)` around each step, and
    `close()` in a finally."""

    def __init__(
        self,
        logdir: str | pathlib.Path,
        schedule: ProfileSchedule | None = None,
    ):
        self.logdir = pathlib.Path(logdir)
        self.schedule = schedule or ProfileSchedule()
        self.schedule.validate()
        self._prof = None
        self._done = False
        self._first_step: int | None = None

    def before_step(self, step: int) -> None:
        if self._first_step is None:
            self._first_step = step
        if (
            not self._done
            and self._prof is None
            and step >= self._first_step + self.schedule.start_step
        ):
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            self.logdir.mkdir(parents=True, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(str(self.logdir)),
            )
            self._prof.start()
            self._started_at = step
            log.info("profiler: trace started at step %d", step)

    def after_step(self, step: int) -> None:
        if (
            self._prof is not None
            and step + 1 >= self._started_at + self.schedule.num_steps
        ):
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels end inside it
        self._prof.stop()  # writes the trace (on_trace_ready)
        self._prof = None
        self._done = True
        log.info("profiler: trace written under %s", self.logdir)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()

    @property
    def trace_written(self) -> bool:
        return self._done


# -- per-phase roofline --------------------------------------------------------

# NVIDIA H100 SXM (80 GB HBM3) data-sheet peaks at 700 W: dense bf16 on
# the tensor cores, and HBM3 bandwidth.
H100_PEAK_TFLOPS = 989.0
H100_PEAK_GBPS = 3350.0
PEAK_DEVICE = "NVIDIA H100 SXM 80GB HBM3"


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def time_phase(fn, *args, warmup: int = 2, steps: int = 5) -> float:
    """Milliseconds per call of `fn(*args)`. When the first tensor that
    `fn` returns lies on a GPU, the time comes from CUDA events recorded
    around the timed calls, read after a device sync; otherwise from the
    host clock."""
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
    first = _first_tensor(out)
    steps = max(1, steps)
    if first is not None and first.is_cuda:
        torch.cuda.synchronize(first.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(first.device)
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    return (time.perf_counter() - t0) / steps * 1000.0


@dataclasses.dataclass(frozen=True)
class PhaseStat:
    """One measured phase with the work its schedule must do: model
    TFLOP and modeled GB moved (recompute not counted)."""

    name: str
    ms: float
    tflop: float
    gb: float

    def achieved_tflops(self) -> float:
        return self.tflop / (self.ms / 1000.0) if self.ms > 0 else 0.0

    def achieved_gbps(self) -> float:
        return self.gb / (self.ms / 1000.0) if self.ms > 0 else 0.0


class PhaseRoofline:
    """Per-phase roofline: add phases, read the table. A phase is bound
    by "HBM" when its bandwidth share exceeds its compute share by 0.3 or
    more, "compute-side" (the tensor cores) when compute leads by 0.15 or
    more, and "mixed → <leader>" in between: JAX's thresholds, with
    "compute" where JAX says "MXU"."""

    def __init__(
        self,
        peak_tflops: float = H100_PEAK_TFLOPS,
        peak_gbps: float = H100_PEAK_GBPS,
    ):
        self.peak_tflops = peak_tflops
        self.peak_gbps = peak_gbps
        self.phases: list[PhaseStat] = []

    def add(self, name: str, *, ms: float, tflop: float, gb: float) -> dict:
        self.phases.append(PhaseStat(name, ms, tflop, gb))
        return self.rows()[-1]

    def _bound(self, compute_frac: float, bw_frac: float) -> str:
        if bw_frac - compute_frac >= 0.3:
            return "HBM"
        if compute_frac - bw_frac >= 0.15:
            return "compute-side"
        return "mixed → HBM" if bw_frac >= compute_frac else "mixed → compute"

    def rows(self) -> list[dict]:
        out = []
        for p in self.phases:
            tf = p.achieved_tflops()
            gbps = p.achieved_gbps()
            cf = tf / self.peak_tflops if self.peak_tflops else 0.0
            bf = gbps / self.peak_gbps if self.peak_gbps else 0.0
            out.append(
                {
                    "phase": p.name,
                    "ms": round(p.ms, 2),
                    "tflop": round(p.tflop, 2),
                    "gb": round(p.gb, 2),
                    "achieved_tflops": round(tf, 1),
                    "achieved_gbps": round(gbps, 1),
                    "compute_frac": round(cf, 3),
                    "bw_frac": round(bf, 3),
                    "bound_by": self._bound(cf, bf),
                }
            )
        return out

    def saturated(self) -> str:
        """The bound of the phase that takes the most time."""
        if not self.phases:
            return "none"
        top = max(self.rows(), key=lambda r: r["ms"])
        return f"{top['phase']}: {top['bound_by']}"

    def table(self) -> str:
        """A markdown table of the phases."""
        lines = [
            "| phase | ms | TFLOP | GB moved | achieved | bound by |",
            "|---|---|---|---|---|---|",
        ]
        for r in self.rows():
            lines.append(
                f"| {r['phase']} | {r['ms']:g} | {r['tflop']:g} | "
                f"{r['gb']:g} | {r['achieved_tflops']:g} TF/s "
                f"({r['compute_frac'] * 100:.0f}%), "
                f"{r['achieved_gbps']:g} GB/s "
                f"({r['bw_frac'] * 100:.0f}%) | {r['bound_by']} |"
            )
        return "\n".join(lines)


def annotate(name: str):
    """Decorator: mark a function as a named region on the trace."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def annotated_scope(name: str):
    """Context manager: a named region on the trace."""
    return torch.profiler.record_function(name)


class MetricsLogger:
    """JSONL metrics sink beside the traces, so one logdir holds both."""

    def __init__(self, logdir: str | pathlib.Path, filename: str = "metrics.jsonl"):
        self.path = pathlib.Path(logdir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, step: int, record: dict[str, Any]) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps({"ts": time.time(), "step": step, **record}) + "\n")

    def read(self) -> list[dict]:
        if not self.path.exists():
            return []
        return [
            json.loads(line)
            for line in self.path.read_text().splitlines()
            if line.strip()
        ]
