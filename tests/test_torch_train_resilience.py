"""The kill-and-resume soak on the port's `fit()`: real incarnations of
`kubeflow_tpu_torch/testing/workers/resilience.py` through a seeded
`TrainFaultSchedule`, held against an uninterrupted baseline.

The port's counterpart of JAX's `tests/e2e/test_train_resilience_e2e.py`
(its non-elastic soak, tier-1 and nightly sizes). The plan is the port's
`TrainFaultSchedule`, which equals JAX's for the same seed
(`test_torch_train_faults.py`):

- process faults: the worker delivers SIGKILL to itself between steps,
  or SIGTERM mid-step (fit exits `Preempted`, 75, after a save);
- storage faults: between incarnations the test truncates or flips the
  bytes of a checkpoint, or garbles its manifest
  (`apply_checkpoint_fault`), and `restore_latest` must quarantine it
  and fall back;
- data faults: loss-spike batches (in the baseline too) that the guard
  must skip.

JAX's four properties are asserted from the workers' JSONL traces:

1. the final parameters (L1) and loss equal the baseline's;
2. every step maps to its own data position, nothing repeated or skipped;
3. every training fault class fired;
4. the guard skipped exactly the planned spikes.

The seed prints; ``KFTPU_RESILIENCE_SEED=<seed>`` reproduces a failure.
Workers run on the CPU with one thread each.

The soak's SIGKILL waits for the pending saves (the worker's docstring
says why), so a kill inside an asynchronous save has tests of its own:
a worker whose checkpointer's writer thread SIGKILLs the process at a
fixed point of one save (its first file written into ``<step>.partial``;
the commit rename done but no manifest; the manifest's tmp file written
but not renamed). `restore_latest` must land on the step before it,
bitwise equal to an uninterrupted run's, and the next incarnation must
finish equal to that run.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from kubeflow_tpu_torch.testing.chaos import (
    TRAIN_FAULT_CLASSES,
    TrainFaultSchedule,
    apply_checkpoint_fault,
)
from kubeflow_tpu_torch.testing.workers.resilience import EXIT_PREEMPTED

REPO = Path(__file__).resolve().parents[1]
DEFAULT_SEED = 20260804  # JAX's tier-1 seed


def _seed() -> int:
    return int(os.environ.get("KFTPU_RESILIENCE_SEED") or DEFAULT_SEED)


def _run_worker(*, ckpt_dir, trace_file, incarnation, total_steps, save_interval, seed,
                spikes, crash=None, kill_in_save=None) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("KFTPU_CRASH_STEP", "KFTPU_CRASH_SIGNAL", "KFTPU_ELASTIC_PLAN",
                        "KFTPU_RESIZE_FILE")}
    env.update({
        "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p),
        "KFTPU_DEVICE": "cpu", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
        "KFTPU_CKPT_DIR": str(ckpt_dir), "KFTPU_TRACE_FILE": str(trace_file),
        "KFTPU_INCARNATION": str(incarnation), "KFTPU_TOTAL_STEPS": str(total_steps),
        "KFTPU_SAVE_INTERVAL": str(save_interval), "KFTPU_DATA_SEED": str(seed),
        "KFTPU_SPIKE_STEPS": ",".join(str(s) for s in spikes),
    })
    if crash is not None:
        env["KFTPU_CRASH_STEP"] = str(crash.at_step)
        env["KFTPU_CRASH_SIGNAL"] = crash.cls
    if kill_in_save is None:
        argv = ["-m", "kubeflow_tpu_torch.testing.workers.resilience"]
    else:
        stage, step = kill_in_save
        argv = ["-c", _KILL_IN_SAVE_PRELUDE.format(step=step) + _KILL_IN_SAVE[stage]
                + "from kubeflow_tpu_torch.testing.workers import resilience\n"
                  "sys.exit(resilience.main())\n"]
    return subprocess.run([sys.executable, *argv], env=env, cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)


def _read_trace(trace_file) -> list[dict]:
    with open(trace_file) as f:
        return [json.loads(line) for line in f if line.strip()]


def _final_summary(events: list[dict]) -> dict:
    done = [e for e in events if e["event"] == "done"]
    assert len(done) == 1, done
    return done[0]


def _run_soak(tmp_path, seed: int, *, total_steps, save_interval, faults_per_class,
              deadline) -> dict:
    repro = f"[resilience seed={seed}; reproduce with KFTPU_RESILIENCE_SEED={seed}]"
    print(f"resilience soak starting {repro}")
    t_start = time.monotonic()
    kwargs = dict(save_interval=save_interval, faults_per_class=faults_per_class)
    schedule = TrainFaultSchedule(seed, total_steps, **kwargs)
    assert TrainFaultSchedule(seed, total_steps, **kwargs).plan == schedule.plan, repro
    spikes = schedule.spike_steps
    common = dict(total_steps=total_steps, save_interval=save_interval, seed=seed,
                  spikes=spikes)

    # -- the uninterrupted baseline: same data, same spikes, no faults ----
    base_trace = tmp_path / "baseline.jsonl"
    proc = _run_worker(ckpt_dir=tmp_path / "ckpt-base", trace_file=base_trace,
                       incarnation=0, **common)
    assert proc.returncode == 0, (proc.stdout, proc.stderr, repro)
    baseline = _final_summary(_read_trace(base_trace))
    assert baseline["skips"] == len(spikes), (baseline, repro)

    # -- the chaos run: one incarnation per crash fault, then completion --
    ckpt_dir = tmp_path / "ckpt"
    trace_file = tmp_path / "chaos.jsonl"
    incarnation = 0
    crashes = list(schedule.crash_faults)
    while True:
        assert time.monotonic() - t_start < deadline, (
            f"soak missed its deadline at incarnation {incarnation} {schedule} {repro}")
        fault = crashes[incarnation] if incarnation < len(crashes) else None
        proc = _run_worker(ckpt_dir=ckpt_dir, trace_file=trace_file,
                           incarnation=incarnation, crash=fault, **common)
        if fault is None:
            assert proc.returncode == 0, (proc.stdout, proc.stderr, repro)
            break
        if fault.cls == "kill":
            assert proc.returncode == -9, (
                f"expected SIGKILL death at step {fault.at_step}, got rc={proc.returncode}",
                proc.stdout, proc.stderr, repro)
        else:
            assert proc.returncode == EXIT_PREEMPTED, (
                f"expected Preempted exit ({EXIT_PREEMPTED}) at step {fault.at_step}, got "
                f"rc={proc.returncode}", proc.stdout, proc.stderr, repro)
        schedule.mark_injected(fault)
        for storage in schedule.storage_after(incarnation):
            desc = apply_checkpoint_fault(ckpt_dir, storage.cls, offset=storage.offset)
            assert desc is not None, f"storage fault found nothing to damage: {storage} {repro}"
            print(f"applied {desc} {repro}")
            schedule.mark_injected(storage)
        incarnation += 1
    elapsed = time.monotonic() - t_start

    events = _read_trace(trace_file)
    final = _final_summary(events)

    # 4. the guard skipped exactly the planned spikes
    assert final["skips"] == len(spikes), (final, repro)
    for fault in schedule.spike_faults:
        schedule.mark_injected(fault)

    # 3. every training fault class fired
    coverage = schedule.coverage()
    assert all(coverage[c] >= 1 for c in TRAIN_FAULT_CLASSES), (
        f"incomplete fault coverage: {coverage} {repro}")
    # ... and every damaged step was quarantined, not loaded
    quarantined = sorted(p.name for p in ckpt_dir.iterdir() if p.name.startswith("corrupt-"))
    assert len(quarantined) == len(schedule.storage_faults), (quarantined, repro)

    # 1. parity with the uninterrupted baseline (one thread: bitwise)
    assert final["params_l1"] == baseline["params_l1"], (final, baseline, repro)
    assert final["final_loss"] == baseline["final_loss"], (final, baseline, repro)

    # 2. no repeated or skipped batch: the last word on each step (later
    # incarnations redo the steps after their restore point) is the
    # identity, step p consumed position p
    steps = [e for e in events if e["event"] == "step"]
    mapping = {e["step"]: e["position"] for e in steps}
    assert mapping == {s: s for s in range(1, total_steps + 1)}, (
        f"batch sequence diverged (repeated or skipped data) {repro}: "
        f"{sorted(set(range(1, total_steps + 1)) ^ set(mapping))[:10]}")
    first_step: dict[int, int] = {}
    last_step: dict[int, int] = {}
    for e in steps:
        first_step.setdefault(e["incarnation"], e["step"])
        last_step[e["incarnation"]] = e["step"]
    for inc in range(1, incarnation + 1):
        assert first_step[inc] <= last_step[inc - 1] + 1, (
            f"incarnation {inc} skipped ahead: first step {first_step[inc]} after "
            f"{last_step[inc - 1]} {repro}")

    metrics = {"seed": seed, "goodput": total_steps / len(steps),
               "steps_lost_per_kill": (len(steps) - total_steps) / len(crashes),
               "incarnations": incarnation + 1, "elapsed_seconds": elapsed,
               "coverage": coverage, "quarantined": quarantined}
    print(f"resilience soak converged: {json.dumps(metrics)} {repro}")
    return metrics


def test_resilience_soak_kill_and_resume(tmp_path):
    """Tier-1: JAX's smallest size (32 steps, save every 4, one fault of
    each class), its fixed seed, under its own 120 s deadline."""
    metrics = _run_soak(tmp_path, _seed(), total_steps=32, save_interval=4,
                        faults_per_class=1, deadline=120.0)
    assert 0.0 < metrics["goodput"] <= 1.0
    assert metrics["elapsed_seconds"] < 120.0


@pytest.mark.slow
def test_resilience_soak_nightly(tmp_path):
    """JAX's nightly size (80 steps, save every 5, two faults of each
    class) on a fresh seed, printed so that a failure reproduces."""
    seed = int(os.environ.get("KFTPU_RESILIENCE_SEED") or (time.time_ns() % 2**31))
    _run_soak(tmp_path, seed, total_steps=80, save_interval=5, faults_per_class=2,
              deadline=900.0)


# -- a SIGKILL inside an asynchronous save ------------------------------------

# Each stage patches the worker's process so that the checkpointer's writer
# thread SIGKILLs it at one point of the save of `step`.
_KILL_IN_SAVE_PRELUDE = """\
import os, signal, sys, torch
from kubeflow_tpu_torch.train import checkpoint
step = {step}
def kill():
    os.kill(os.getpid(), signal.SIGKILL)
"""
_KILL_IN_SAVE = {
    # The first state file is in `<step>.partial`; the rest are not.
    "partial": """\
_save = torch.save
def save(obj, f, *args, **kwargs):
    _save(obj, f, *args, **kwargs)
    if os.path.basename(os.path.dirname(str(getattr(f, "name", "")))) == f"{step}.partial":
        kill()
torch.save = save
""",
    # Committed by the rename, but without its manifest.
    "unmanifested": """\
_write_manifest = checkpoint.write_manifest
def write_manifest(step_dir, data_state):
    if step_dir.name == str(step):
        kill()
    return _write_manifest(step_dir, data_state)
checkpoint.write_manifest = write_manifest
""",
    # The manifest's tmp file is written and synced, not yet renamed.
    "manifest_tmp": """\
_replace = os.replace
def replace(src, dst, *args, **kwargs):
    dst_path = checkpoint.Path(dst)
    if dst_path.name == checkpoint.MANIFEST_NAME and dst_path.parent.name == str(step):
        kill()
    return _replace(src, dst, *args, **kwargs)
os.replace = replace
""",
}
TORN_STEP = 6
ASYNC_RUN = dict(total_steps=8, save_interval=2, seed=DEFAULT_SEED, spikes=[])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The run that no kill interrupts: its checkpoint directory (steps 4,
    6 and 8) and its final summary."""
    root = tmp_path_factory.mktemp("async-save-baseline")
    proc = _run_worker(ckpt_dir=root / "ckpt", trace_file=root / "trace.jsonl",
                       incarnation=0, **ASYNC_RUN)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    return root / "ckpt", _final_summary(_read_trace(root / "trace.jsonl"))


@pytest.mark.parametrize("stage", list(_KILL_IN_SAVE))
def test_sigkill_during_async_save_restores_previous_step(tmp_path, uninterrupted, stage):
    import torch

    from kubeflow_tpu_torch.testing.workers.resilience import build_trainer
    from kubeflow_tpu_torch.train import Checkpointer
    from kubeflow_tpu_torch.train.checkpoint import MANIFEST_NAME

    base_dir, base_final = uninterrupted
    ckpt_dir, trace_file = tmp_path / "ckpt", tmp_path / "trace.jsonl"
    proc = _run_worker(ckpt_dir=ckpt_dir, trace_file=trace_file, incarnation=0,
                       kill_in_save=(stage, TORN_STEP), **ASYNC_RUN)
    assert proc.returncode == -9, (proc.returncode, proc.stdout, proc.stderr)
    killed_steps = [e["step"] for e in _read_trace(trace_file) if e["event"] == "step"]
    assert killed_steps[-1] >= TORN_STEP, killed_steps

    # The kill tore the save of TORN_STEP where the stage says.
    torn = ckpt_dir / str(TORN_STEP)
    partial = ckpt_dir / f"{TORN_STEP}.partial"
    names = {p.name for p in ckpt_dir.iterdir()}
    assert {"2", "4"} <= names, names
    if stage == "partial":
        assert not torn.exists() and len(list(partial.iterdir())) == 1, names
    else:
        assert not partial.exists() and torn.is_dir(), names
        assert not (torn / MANIFEST_NAME).exists()
        assert (torn / (MANIFEST_NAME + ".tmp")).exists() == (stage == "manifest_tmp")

    # A reader lands on the step before, bitwise equal to the uninterrupted run's.
    template = build_trainer(ASYNC_RUN["total_steps"], "cpu").abstract_state()
    restored = Checkpointer(ckpt_dir, read_only=True).restore_latest(template)
    assert restored.step == TORN_STEP - ASYNC_RUN["save_interval"]
    want = Checkpointer(base_dir, read_only=True).restore_latest(
        template, prefer_step=restored.step)
    assert want.step == restored.step
    got, expected = _flat(restored.state), _flat(want.state)
    assert got.keys() == expected.keys()
    for key in expected:
        assert torch.equal(got[key], expected[key]), key

    # The next incarnation resumes there and ends where the uninterrupted run did.
    proc = _run_worker(ckpt_dir=ckpt_dir, trace_file=trace_file, incarnation=1, **ASYNC_RUN)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    events = _read_trace(trace_file)
    final = _final_summary(events)
    assert final["resumed_from"] == restored.step
    resumed = [e["step"] for e in events if e["event"] == "step" and e["incarnation"] == 1]
    assert resumed == list(range(restored.step + 1, ASYNC_RUN["total_steps"] + 1))
    assert final["params_l1"] == base_final["params_l1"]
    assert final["final_loss"] == base_final["final_loss"]
    # The writer quarantined a committed torn step and dropped a partial one.
    names = {p.name for p in ckpt_dir.iterdir()}
    assert (f"corrupt-{TORN_STEP}" in names) == (stage != "partial"), names
    assert f"{TORN_STEP}.partial" not in names
