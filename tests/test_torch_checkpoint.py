"""The port's Checkpointer against the JAX package's durability contract.

The port saves `TrainState.state_dict()` with `torch.save` (orbax plays
no role), so the JAX module cannot read its steps; what is held against
JAX is the manifest: the port's `write_manifest` writes byte for byte
the manifest JAX's writes over the same files, and each side's
`verify_manifest` accepts the other's and rejects the same damage. The
rest mirrors tests/test_checkpoint.py on a tiny LM on the CPU (2 layers,
d_model 64): round trips are bitwise, corruption falls back, read-only
never renames, the data state rides along.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from kubeflow_tpu.train import checkpoint as jckpt
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.train import (
    AnomalyGuard,
    Checkpointer,
    SyntheticTokens,
    TrainConfig,
    Trainer,
    TrainingDiverged,
    fit,
)
from kubeflow_tpu_torch.train import checkpoint as tckpt

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2, head_dim=32,
            d_ff=128, flash_block_q=64, flash_block_k=64, remat_policy="none")
SEQ, BATCH = 64, 2


def _trainer(guard=True, seed=0):
    cfg = ttf.TransformerConfig(**TINY, dtype=torch.float32, attention_impl="flash")
    config = TrainConfig(batch_size=BATCH, learning_rate=1e-2, warmup_steps=1,
                         total_steps=20, optimizer="adamw", label_smoothing=0.0,
                         fsdp_params=False, train_metrics="loss")
    return Trainer(ttf.TransformerLM(cfg, device="cpu", seed=seed), config,
                   input_key="tokens", label_key="labels", device="cpu",
                   guard=AnomalyGuard() if guard else None)


@pytest.fixture
def trainer():
    return _trainer()


@pytest.fixture
def data():
    return SyntheticTokens(BATCH, SEQ, TINY["vocab_size"], vary_per_step=True,
                           device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def _assert_state_equal(a: dict, b: dict):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for key in fa:
        if fa[key] is None:
            assert fb[key] is None, key
        else:
            assert fa[key].dtype == fb[key].dtype, key
            assert torch.equal(fa[key], fb[key]), key


def _save_steps(trainer, data, tmp_path, steps, interval=1):
    """Train up to max(steps), saving at each step in `steps` with the
    data state; returns the last state."""
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=interval)
    state = trainer.init_state()
    step_fn = trainer.make_train_step()
    it = iter(data)
    for n in range(1, max(steps) + 1):
        state, _ = step_fn(state, next(it))
        if n in steps:
            assert ckpt.save(n, state, force=True, data_state={"position": n})
    ckpt.close()
    return state


def test_save_restore_roundtrip(trainer, data, tmp_path):
    """Step, parameters, adamw's state (its bf16 first moment included)
    and the guard's state come back bitwise, on the trainer's device."""
    state = trainer.init_state()
    state, _ = trainer.make_train_step()(state, next(iter(data)))
    ckpt = Checkpointer(tmp_path / "ckpt", save_interval_steps=1)
    assert ckpt.save(1, state, force=True)
    ckpt.wait()
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in _flat(state.state_dict()).items()}
    restored, at, data_state = ckpt.restore_latest(trainer.abstract_state())
    assert at == 1 and data_state is None
    _assert_state_equal(restored, {k: v for k, v in state.state_dict().items()})
    assert restored["opt_state"]["mu"]["embedding"].dtype == torch.bfloat16
    # Into a fresh trainer: its model's parameters become the saved ones.
    other = _trainer(seed=1)
    loaded = other.load_state_dict(restored)
    assert int(loaded.step) == 1
    for name, p in other.model.named_parameters():
        assert torch.equal(p, saved[f"/params/{name}"]), name
    ckpt.close()


def test_data_state_rides_along(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    restored = ckpt.restore_latest(trainer.abstract_state())
    assert restored.step == 2 and restored.data_state == {"position": 2}
    ckpt.close()


def _write_files(root):
    (root / "nested").mkdir(parents=True)
    rng = np.random.default_rng(0)
    (root / "a.bin").write_bytes(rng.bytes(3000))
    (root / "nested" / "b.bin").write_bytes(rng.bytes(70_000))
    (root / (tckpt.MANIFEST_NAME + ".tmp")).write_text("a leftover")


def test_manifest_matches_jax_write_manifest(tmp_path):
    """Over the same files, the port's manifest is JAX's, key for key and
    byte for byte (the same name, keys, sizes, sha256 and data state;
    the leftover .tmp skipped by both)."""
    assert tckpt.MANIFEST_NAME == jckpt.MANIFEST_NAME
    assert tckpt.QUARANTINE_PREFIX == jckpt.QUARANTINE_PREFIX
    for side in ("jax", "port"):
        _write_files(tmp_path / side)
    data_state = {"position": 7, "salt": 2}
    want = jckpt.write_manifest(tmp_path / "jax", data_state)
    got = tckpt.write_manifest(tmp_path / "port", data_state)
    assert got == want
    assert set(got) == {"version", "files", "data_state"}
    assert sorted(got["files"]) == ["a.bin", "nested/b.bin"]
    assert ((tmp_path / "port" / tckpt.MANIFEST_NAME).read_bytes()
            == (tmp_path / "jax" / jckpt.MANIFEST_NAME).read_bytes())


@pytest.mark.parametrize("damage", ["none", "flip", "truncate", "missing",
                                    "garble", "vacuous"])
def test_manifest_verification_agrees_with_jax(tmp_path, damage):
    """Each side's verify_manifest accepts the other's manifest on sound
    files and rejects the same damage."""
    step_dir = tmp_path / "step"
    _write_files(step_dir)
    tckpt.write_manifest(step_dir, None)
    target = step_dir / "nested" / "b.bin"
    if damage == "flip":
        raw = bytearray(target.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        target.write_bytes(bytes(raw))
    elif damage == "truncate":
        target.write_bytes(target.read_bytes()[:-1])
    elif damage == "missing":
        target.unlink()
    elif damage == "garble":
        (step_dir / tckpt.MANIFEST_NAME).write_text("{not json")
    elif damage == "vacuous":
        (step_dir / tckpt.MANIFEST_NAME).write_text(
            json.dumps({"version": 1, "files": {}, "data_state": None}))
    port, ref = tckpt.verify_manifest(step_dir), jckpt.verify_manifest(step_dir)
    assert (port is None) == (ref is None) == (damage != "none")
    assert port == ref


def test_restore_latest_empty_directory(trainer, tmp_path):
    ckpt = Checkpointer(tmp_path / "empty", save_interval_steps=1)
    assert ckpt.restore_latest(trainer.abstract_state()) is None
    ckpt.close()


def test_restore_falls_back_past_corruption_and_resaves(trainer, data, tmp_path):
    """A byte flipped in the newest step's parameters: restore verifies,
    quarantines the step and falls back to the one before, bitwise; a
    later save at the quarantined number does not collide."""
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    two = ckpt.restore_latest(trainer.abstract_state()).state
    state = _save_steps(_trainer(), data, tmp_path / "more", steps={3})
    shutil.copytree(tmp_path / "more" / "ck" / "3", tmp_path / "ck" / "3")
    params = tmp_path / "ck" / "3" / "params.pt"
    raw = bytearray(params.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    params.write_bytes(bytes(raw))

    restored = ckpt.restore_latest(trainer.abstract_state())
    assert restored.step == 2 and restored.data_state == {"position": 2}
    _assert_state_equal(restored.state, two)
    quarantined = [p.name for p in (tmp_path / "ck").iterdir()
                   if p.name.startswith("corrupt-")]
    assert quarantined == ["corrupt-3"]
    assert ckpt.save(3, state, force=True)
    ckpt.wait()
    assert ckpt.restore_latest(trainer.abstract_state()).step == 3
    ckpt.close()


def test_restore_falls_back_on_garbled_manifest(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    (tmp_path / "ck" / "2" / tckpt.MANIFEST_NAME).write_text("{{{")
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    ckpt.close()


def test_restore_missing_manifest_treated_as_torn_write(trainer, data, tmp_path):
    """A save with no manifest (a crash between the commit and the
    manifest) is garbage: restore falls back and never loads it."""
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    (tmp_path / "ck" / "2" / tckpt.MANIFEST_NAME).unlink()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    assert (tmp_path / "ck" / "corrupt-2").is_dir()
    ckpt.close()


def test_restore_survives_eviction_racing_it(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1, 2, 3})
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.latest_step() == 3
    shutil.rmtree(tmp_path / "ck" / "3")
    assert ckpt.restore_latest(trainer.abstract_state()).step == 2
    ckpt.close()


def test_restore_prefers_a_named_step_while_it_is_valid(trainer, data, tmp_path):
    """`prefer_step` restores that step while the directory holds it
    valid (serving restores the version its spec names), and the newest
    valid step once it is missing or damaged; `holds_step` gives the
    same verdict, also after a byte flipped in a step it had vouched
    for."""
    _save_steps(trainer, data, tmp_path, steps={1, 2, 3})
    ckpt = Checkpointer(tmp_path / "ck", read_only=True)
    template = trainer.abstract_state()
    two = ckpt.restore_latest(template, prefer_step=2)
    assert two.step == 2 and two.data_state == {"position": 2}
    assert ckpt.restore_latest(template, prefer_step=7).step == 3
    assert [tckpt.holds_step(tmp_path / "ck", n) for n in (1, 2, 3, 7)] == [
        True, True, True, False]
    params = tmp_path / "ck" / "2" / "params.pt"
    raw = bytearray(params.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    params.write_bytes(bytes(raw))
    assert not tckpt.holds_step(tmp_path / "ck", 2)
    assert ckpt.restore_latest(template, prefer_step=2).step == 3
    shutil.rmtree(tmp_path / "ck" / "1")
    assert not tckpt.holds_step(tmp_path / "ck", 1)
    assert ckpt.restore_latest(template, prefer_step=1).step == 3
    ckpt.close()


def test_read_only_restore_skips_without_quarantine(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    (tmp_path / "ck" / "2" / tckpt.MANIFEST_NAME).unlink()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1, read_only=True)
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    assert (tmp_path / "ck" / "2").is_dir()
    assert not [p for p in (tmp_path / "ck").iterdir()
                if p.name.startswith("corrupt-")]
    ckpt.close()


def test_vacuous_manifest_is_invalid_not_a_crash(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1, 2})
    (tmp_path / "ck" / "2" / tckpt.MANIFEST_NAME).write_text(
        json.dumps({"version": 1, "files": {}, "data_state": None}))
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    ckpt.close()


def test_update_data_state_rewrites_manifest_in_place(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1})
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.update_data_state(1, {"position": 1, "salt": 7})
    restored = ckpt.restore_latest(trainer.abstract_state())
    assert restored.step == 1
    assert restored.data_state == {"position": 1, "salt": 7}
    assert not ckpt.update_data_state(99, {"position": 0})
    ckpt.close()


def test_read_only_is_actually_read_only(trainer, data, tmp_path):
    """read_only: no mkdir of a missing directory, saves and data-state
    rewrites refused, restore still works, nothing renamed."""
    with pytest.raises(FileNotFoundError, match="read_only"):
        Checkpointer(tmp_path / "nope", read_only=True)
    assert not (tmp_path / "nope").exists()
    state = _save_steps(trainer, data, tmp_path, steps={1})
    before = sorted(os.listdir(tmp_path / "ck"))
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1, read_only=True)
    assert not ckpt.should_save(2)
    with pytest.raises(RuntimeError, match="read_only"):
        ckpt.save(2, state, force=True)
    with pytest.raises(RuntimeError, match="read_only"):
        ckpt.update_data_state(1, {"position": 5})
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    assert sorted(os.listdir(tmp_path / "ck")) == before
    ckpt.close()


def test_restore_under_different_save_interval(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={3, 6}, interval=3)
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=5)
    restored = ckpt.restore_latest(trainer.abstract_state())
    assert restored.step == 6 and int(restored.state["step"]) == 6
    assert not ckpt.should_save(7)
    ckpt.close()


def test_should_save_follows_the_interval_and_the_newest_step(trainer, tmp_path):
    """orbax's rule, as the JAX Checkpointer applies it: a multiple of the
    interval past the newest saved step; `save` without force obeys it,
    and a step that exists cannot be saved again."""
    state = trainer.init_state()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=3)
    assert [s for s in range(1, 10) if ckpt.should_save(s)] == [3, 6, 9]
    assert not ckpt.save(4, state)
    assert ckpt.save(6, state)
    assert [s for s in range(1, 10) if ckpt.should_save(s)] == [9]
    assert ckpt.save(5, state, force=True)
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save(6, state, force=True)
    ckpt.wait()
    assert ckpt.all_steps() == [5, 6]
    ckpt.close()


def test_retention_keeps_the_newest_steps(trainer, data, tmp_path):
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1, max_to_keep=2)
    state = trainer.init_state()
    for step in (1, 2, 3, 4):
        assert ckpt.save(step, state, force=True)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    ckpt.close()


def test_save_copies_the_state_at_the_boundary(trainer, data, tmp_path):
    """The save is asynchronous, but what it writes is the state at the
    call: a step taken before the write finishes does not reach it."""
    state = trainer.init_state()
    step_fn = trainer.make_train_step()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    want = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    assert ckpt.save(1, state, force=True)
    state, _ = step_fn(state, next(iter(data)))  # updates the params in place
    restored = ckpt.restore_latest(trainer.abstract_state())
    for name, p in restored.state["params"].items():
        assert torch.equal(p, want[name]), name
    ckpt.close()


def test_a_partial_save_left_by_a_crash_is_ignored_and_cleared(trainer, data, tmp_path):
    _save_steps(trainer, data, tmp_path, steps={1})
    partial = tmp_path / "ck" / f"2{tckpt.PARTIAL_SUFFIX}"
    shutil.copytree(tmp_path / "ck" / "1", partial)
    reader = Checkpointer(tmp_path / "ck", read_only=True)
    assert reader.all_steps() == [1] and partial.is_dir()
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert not partial.exists()
    assert ckpt.restore_latest(trainer.abstract_state()).step == 1
    ckpt.close()


def test_restore_refuses_a_template_that_does_not_fit(trainer, data, tmp_path):
    """A step that verifies but does not fit the template (another
    model) raises: the bytes are sound, the caller's template is not, so
    the step is neither skipped nor quarantined."""
    _save_steps(trainer, data, tmp_path, steps={1})
    cfg = ttf.TransformerConfig(**{**TINY, "d_ff": 256}, dtype=torch.float32)
    other = Trainer(ttf.TransformerLM(cfg, device="cpu"), trainer.config,
                    device="cpu", guard=AnomalyGuard())
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    with pytest.raises(ValueError, match="template"):
        ckpt.restore_latest(other.abstract_state())
    assert ckpt.all_steps() == [1]
    ckpt.close()


def test_a_failed_save_surfaces_at_wait(trainer, tmp_path, monkeypatch):
    """The write runs in the background: its failure is raised by the next
    wait(), and the step never appears."""
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", broken)
    ckpt = Checkpointer(tmp_path / "ck", save_interval_steps=1)
    assert ckpt.save(1, trainer.init_state(), force=True)
    with pytest.raises(RuntimeError, match="failed"):
        ckpt.wait()
    assert ckpt.all_steps() == []
    ckpt.close()


def test_manifest_error_does_not_mask_inflight_exception(trainer, data, tmp_path):
    """fit()'s closing wait() may raise; while another exception unwinds
    it is only logged, and on a clean exit it is the result."""
    class FailingSaves(Checkpointer):
        def restore_latest(self, template):
            restored = super().restore_latest(template)
            self._errors.append(RuntimeError("boom"))
            return restored

    plain = _trainer(guard=False)
    poison = plain.model.layers[0].register_forward_pre_hook(
        lambda module, args: (args[0] * float("nan"), *args[1:]))
    ckpt = FailingSaves(tmp_path / "ck", save_interval_steps=100)
    with pytest.raises(TrainingDiverged):
        fit(plain, data, total_steps=1, checkpointer=ckpt, log_every=1)
    poison.remove()
    ckpt.close()

    ckpt2 = FailingSaves(tmp_path / "ck2", save_interval_steps=100)
    with pytest.raises(RuntimeError, match="failed"):
        # rng=0 draws the parameters anew: the poisoned step above
        # applied its NaN update (no guard).
        fit(plain, data, total_steps=1, rng=0, checkpointer=ckpt2, log_every=1)
    ckpt2.close()


def test_close_joins_the_writer_so_the_process_exits_cleanly(tmp_path):
    """close() ends the writer thread. Left running past close(), it
    aborted the process at exit ("terminate called without an active
    exception", exit 134) once the trainer had been freed, as a
    preempted job worker frees it to hand the card back."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import gc, sys, torch\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from kubeflow_tpu_torch.models import transformer as ttf\n"
        "from kubeflow_tpu_torch.train import (AnomalyGuard, Checkpointer, SyntheticTokens,\n"
        "    TrainConfig, Trainer, fit)\n"
        f"cfg = ttf.TransformerConfig(**{TINY!r}, dtype=torch.float32)\n"
        "trainer = Trainer(ttf.TransformerLM(cfg, device='cpu', seed=0), TrainConfig(\n"
        f"    batch_size={BATCH}, learning_rate=1e-2, total_steps=20, optimizer='adamw',\n"
        "    label_smoothing=0.0, fsdp_params=False, train_metrics='loss'),\n"
        "    input_key='tokens', label_key='labels', device='cpu', guard=AnomalyGuard())\n"
        f"data = SyntheticTokens({BATCH}, {SEQ}, 128, seed=0, vary_per_step=True, device='cpu')\n"
        "ckpt = Checkpointer(sys.argv[2], save_interval_steps=2)\n"
        "fit(trainer, data, 4, rng=0, checkpointer=ckpt, log_every=1)\n"
        "del trainer, data\n"
        "gc.collect()\n"
        "ckpt.close()\n"
        "assert not ckpt._thread.is_alive()\n"
        "print('closed', ckpt.latest_step())\n"
    )
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code, str(root), str(tmp_path / "ckpt")],
                         cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "closed 4"
