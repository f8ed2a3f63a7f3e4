"""The port's profiling layer against the JAX package's.

`PhaseRoofline` defaults to the H100 SXM peaks (989 TFLOP/s dense bf16,
3.35 TB/s) and classifies every phase as JAX's does at the same peaks
(JAX's "MXU" reads "compute" here); the schedule, the windowed trace
(torch.profiler, in TensorBoard's layout), `time_phase`, the named
regions and the metrics log mirror tests/test_profiling.py on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import profiling as jprof
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.train import (
    MetricsLogger,
    PhaseRoofline,
    Profiler,
    ProfileSchedule,
    SyntheticTokens,
    TrainConfig,
    Trainer,
    annotate,
    annotated_scope,
    fit,
    time_phase,
)
from kubeflow_tpu_torch.train import profiling as tprof


def test_schedule_validation():
    with pytest.raises(ValueError):
        ProfileSchedule(start_step=-1).validate()
    with pytest.raises(ValueError):
        ProfileSchedule(num_steps=0).validate()


def _tiny_trainer():
    cfg = ttf.TransformerConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=2,
                                head_dim=32, d_ff=128, dtype=torch.float32,
                                remat_policy="none")
    config = TrainConfig(batch_size=2, learning_rate=1e-2, warmup_steps=1,
                         total_steps=6, optimizer="adamw", label_smoothing=0.0,
                         fsdp_params=False, train_metrics="loss")
    return Trainer(ttf.TransformerLM(cfg, device="cpu"), config, input_key="tokens",
                   label_key="labels", device="cpu")


def test_windowed_capture_writes_tb_profile_layout(tmp_path):
    """fit() traces steps [2, 4) and writes the trace where TensorBoard's
    PyTorch profiler plugin reads it: a *.pt.trace.json under the logdir
    whose events include the train step's operators."""
    profiler = Profiler(tmp_path / "logs", ProfileSchedule(start_step=2, num_steps=2))
    data = SyntheticTokens(2, 64, 128, vary_per_step=True, device="cpu")
    result = fit(_tiny_trainer(), data, total_steps=6, profiler=profiler, log_every=100)
    assert result.steps_done == 6
    assert profiler.trace_written
    traces = list((tmp_path / "logs").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_close_is_crash_safe(tmp_path):
    profiler = Profiler(tmp_path, ProfileSchedule(start_step=0, num_steps=100))
    profiler.before_step(0)
    with annotated_scope("region"):
        torch.ones(4, 4).sum()
    profiler.close()  # stops cleanly before the window ends
    assert profiler.trace_written
    profiler.close()  # a no-op
    profiler.before_step(50)  # a finished profiler never restarts
    assert profiler._prof is None
    trace = next(tmp_path.glob("*.pt.trace.json"))
    assert "region" in {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


def test_resume_shifts_profile_window(tmp_path):
    """The window is relative to the process's first step: a run resumed
    at step 480 still skips its first start_step steps."""
    profiler = Profiler(tmp_path, ProfileSchedule(start_step=2, num_steps=1))
    profiler.before_step(480)
    assert profiler._prof is None
    profiler.after_step(480)
    profiler.before_step(481)
    assert profiler._prof is None
    profiler.after_step(481)
    profiler.before_step(482)
    assert profiler._prof is not None
    profiler.after_step(482)
    assert profiler.trace_written


def test_metrics_logger_roundtrip(tmp_path):
    """The same JSONL records as JAX's logger: ts, step, then the fields."""
    logger = MetricsLogger(tmp_path / "logs")
    ref = jprof.MetricsLogger(tmp_path / "jax")
    for step, loss in ((10, 1.5), (20, 1.1)):
        logger(step, {"loss": loss})
        ref(step, {"loss": loss})
    rows, want = logger.read(), ref.read()
    assert [r["step"] for r in rows] == [10, 20]
    assert [list(r) for r in rows] == [list(r) for r in want]
    assert [(r["step"], r["loss"]) for r in rows] == [(r["step"], r["loss"]) for r in want]


def test_phase_roofline_math_and_bounds():
    """JAX's test's arithmetic at JAX's test peaks (200 TF/s, 800 GB/s),
    with "compute" for "MXU"."""
    roof = PhaseRoofline(peak_tflops=200.0, peak_gbps=800.0)
    fwd = roof.add("fwd", ms=100.0, tflop=10.0, gb=8.0)
    assert fwd["achieved_tflops"] == 100.0 and fwd["achieved_gbps"] == 80.0
    assert fwd["bound_by"] == "compute-side"
    assert roof.add("optimizer", ms=100.0, tflop=0.0, gb=72.0)["bound_by"] == "HBM"
    assert roof.add("bwd", ms=100.0, tflop=12.8, gb=55.2)["bound_by"] == "mixed → HBM"
    roof.phases[-1] = roof.phases[-1].__class__("bwd", 300.0, 12.8, 55.2)
    assert roof.saturated().startswith("bwd:")
    table = roof.table()
    assert table.splitlines()[0] == "| phase | ms | TFLOP | GB moved | achieved | bound by |"
    assert "compute-side" in table and "HBM" in table


def test_phase_roofline_uses_the_h100_peaks():
    roof = PhaseRoofline()
    assert (roof.peak_tflops, roof.peak_gbps) == (989.0, 3350.0)
    assert "H100" in tprof.PEAK_DEVICE
    assert (tprof.H100_PEAK_TFLOPS, tprof.H100_PEAK_GBPS) != (
        jprof.V5E_PEAK_TFLOPS, jprof.V5E_PEAK_GBPS)


_LABELS = {"MXU-side": "compute-side", "mixed → MXU": "mixed → compute"}


def test_phase_roofline_classifies_as_jax_does():
    """200 phases drawn from numpy, through the port's roofline (H100
    peaks by default) and JAX's given the same peaks: the same rows, every
    bound the same (JAX's MXU labels mapped), the same saturated phase."""
    rng = np.random.default_rng(0)
    port = PhaseRoofline()
    ref = jprof.PhaseRoofline(peak_tflops=989.0, peak_gbps=3350.0)
    for i in range(200):
        ms = float(rng.uniform(0.1, 50.0))
        tflop = float(rng.uniform(0, 1.0) * ms * 989.0 / 1000.0)
        gb = float(rng.uniform(0, 1.0) * ms * 3350.0 / 1000.0)
        port.add(f"p{i}", ms=ms, tflop=tflop, gb=gb)
        ref.add(f"p{i}", ms=ms, tflop=tflop, gb=gb)
    got, want = port.rows(), ref.rows()
    for g, w in zip(got, want):
        assert g["bound_by"] == _LABELS.get(w["bound_by"], w["bound_by"]), g
        assert {k: v for k, v in g.items() if k != "bound_by"} == {
            k: v for k, v in w.items() if k != "bound_by"}
    assert {r["bound_by"] for r in got} == {
        "HBM", "compute-side", "mixed → HBM", "mixed → compute"}
    saturated, jsat = port.saturated().split(": "), ref.saturated().split(": ")
    assert saturated == [jsat[0], _LABELS.get(jsat[1], jsat[1])]


def test_time_phase_fenced_timer():
    """Positive ms on the CPU (host clock), for tuple and dict outputs."""
    x = torch.ones(32, 32)
    assert time_phase(lambda a: (a * 2.0, {"aux": a.sum()}), x, warmup=1, steps=2) > 0.0
    assert time_phase(lambda a: {"y": a @ a}, x, warmup=1, steps=2) > 0.0


def test_annotate_names_a_region_on_the_trace():
    @annotate("kftpu_region")
    def work(a):
        return a @ a

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        work(torch.ones(8, 8))
    assert "kftpu_region" in {e.key for e in prof.key_averages()}
