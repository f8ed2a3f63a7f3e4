"""The port's training fault plans (`testing/chaos.py`) against the JAX
package's.

- `TrainFaultSchedule`: for the same arguments the port's plan equals
  JAX's, entry for entry (crash, storage, spike and resize faults, the
  spike steps, the per-boundary storage faults, the resize payload and
  the refusals), over 10 seeds and several sizes, elastic and not.
- `apply_checkpoint_fault`: on a copy of the same port checkpoint
  directory, each class damages the same file into the same bytes as
  JAX's function and says the same; the port's `Checkpointer` then
  quarantines each damaged step and restores the newest intact one,
  bitwise, alone and with the three classes stacked at distinct offsets
  as the schedule places them.
- `ResumableWrapper` and `SpikedData` keep the resumable-data protocol:
  state, position, perturb, resume at a position, clean exhaustion,
  scaled float fields only (the same batches as JAX's wrapper on a numpy
  stream), and `rebind` raising until elastic resize is ported.
"""

import dataclasses
import filecmp
import shutil

import numpy as np
import pytest
import torch

from kubeflow_tpu.testing import chaos as jchaos
from kubeflow_tpu_torch.testing import chaos
from kubeflow_tpu_torch.testing.tinymodels import TinyMLP
from kubeflow_tpu_torch.train import (
    AnomalyGuard,
    Checkpointer,
    GuardConfig,
    SyntheticImages,
    TrainConfig,
    Trainer,
)

SEEDS = list(range(9)) + [20260804]
SIZES = [  # (total_steps, save_interval, faults_per_class, guard_warmup)
    (32, 4, 1, 3), (80, 5, 2, 3), (60, 3, 2, 5), (150, 6, 3, 2), (40, 2, 1, 10)]
ELASTIC = [  # (total_steps, save_interval, faults_per_class, dp_full, dp_shrunk)
    (32, 4, 1, 2, 1), (64, 5, 2, 4, 2), (40, 2, 3, 8, 1)]


def _plan(s) -> list:
    return [dataclasses.asdict(f) for f in s.plan]


def _views(s) -> dict:
    return {
        "plan": _plan(s),
        "crash": [dataclasses.asdict(f) for f in s.crash_faults],
        "storage": [dataclasses.asdict(f) for f in s.storage_faults],
        "spike": [dataclasses.asdict(f) for f in s.spike_faults],
        "resize": [dataclasses.asdict(f) for f in s.resize_faults],
        "spike_steps": s.spike_steps,
        "resize_plan": s.resize_plan,
        "after": [[dataclasses.asdict(f) for f in s.storage_after(i)] for i in range(8)],
        "coverage": s.coverage(),
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda z: "x".join(map(str, z)))
def test_train_plan_equals_jax(seed, size):
    total, interval, k, warmup = size
    kw = dict(save_interval=interval, faults_per_class=k, guard_warmup=warmup)
    port = chaos.TrainFaultSchedule(seed, total, **kw)
    jax_ = jchaos.TrainFaultSchedule(seed, total, **kw)
    assert _views(port) == _views(jax_)
    assert set(port.coverage()) == set(chaos.TRAIN_FAULT_CLASSES)
    # Every class planned; the stacked storage faults on one boundary hit
    # distinct checkpoints.
    assert {f.cls for f in port.plan} == set(chaos.TRAIN_FAULT_CLASSES)
    for i in range(2 * k):
        offsets = [f.offset for f in port.storage_after(i)]
        assert len(offsets) == len(set(offsets))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", ELASTIC, ids=lambda z: "x".join(map(str, z)))
def test_elastic_plan_equals_jax(seed, size):
    total, interval, k, full, shrunk = size
    kw = dict(save_interval=interval, faults_per_class=k, elastic=True, dp_full=full,
              dp_shrunk=shrunk)
    port = chaos.TrainFaultSchedule(seed, total, **kw)
    assert _views(port) == _views(jchaos.TrainFaultSchedule(seed, total, **kw))
    assert set(port.coverage()) == set(chaos.ELASTIC_FAULT_CLASSES)


@pytest.mark.parametrize("kw", [
    dict(total_steps=10, save_interval=4),
    dict(total_steps=30, save_interval=4, faults_per_class=2),
    dict(total_steps=32, save_interval=4, elastic=True, dp_full=1, dp_shrunk=1),
    dict(total_steps=8, save_interval=4, elastic=True),
])
def test_refusals_equal_jax(kw):
    kw = dict(kw)
    total = kw.pop("total_steps")
    with pytest.raises(ValueError) as port:
        chaos.TrainFaultSchedule(3, total, **kw)
    with pytest.raises(ValueError) as jax_:
        jchaos.TrainFaultSchedule(3, total, **kw)
    assert str(port.value) == str(jax_.value)


def test_coverage_counts_only_marked_faults():
    s = chaos.TrainFaultSchedule(1, 32, save_interval=4)
    assert set(s.coverage().values()) == {0}
    for f in s.storage_faults:
        s.mark_injected(f)
    assert s.coverage()["truncate_checkpoint"] == 1 and s.coverage()["kill"] == 0
    assert repr(s).startswith("TrainFaultSchedule(seed=1, planned=")


# -- storage faults on the port's checkpoints ---------------------------------

STORAGE = ("truncate_checkpoint", "corrupt_checkpoint", "corrupt_manifest")


def _trainer():
    config = TrainConfig(batch_size=4, learning_rate=0.05, warmup_steps=1, total_steps=8,
                         fsdp_params=False, weight_decay=0.0)
    return Trainer(TinyMLP(8 * 8 * 3, device="cpu"), config, device="cpu",
                   guard=AnomalyGuard(GuardConfig(warmup_steps=3)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A port checkpoint directory with steps 1-4 and the state each step
    saved (CPU copies)."""
    root = tmp_path_factory.mktemp("faults") / "ck"
    trainer = _trainer()
    data = iter(SyntheticImages(4, image_size=8, num_classes=10, vary_per_step=True,
                                device="cpu"))
    ckpt = Checkpointer(root, save_interval_steps=1, max_to_keep=10)
    state = trainer.init_state()
    step_fn = trainer.make_train_step()
    states = {}
    for n in range(1, 5):
        state, _ = step_fn(state, next(data))
        assert ckpt.save(n, state, force=True, data_state={"position": n})
        states[n] = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in _flat(state.state_dict()).items()}
    ckpt.close()
    return root, states


def _restore(root):
    ckpt = Checkpointer(root, save_interval_steps=1)
    restored = ckpt.restore_latest(_trainer().abstract_state())
    ckpt.close()
    return restored


def _assert_equal_state(restored, want: dict):
    got = _flat(restored.state)
    assert got.keys() == want.keys()
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
        else:
            assert torch.equal(got[key], value), key


@pytest.mark.parametrize("cls", STORAGE)
@pytest.mark.parametrize("offset", [0, 1])
def test_fault_damages_like_jax_and_is_quarantined(saved, tmp_path, cls, offset):
    root, states = saved
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(root, port_dir)
    shutil.copytree(root, jax_dir)
    desc = chaos.apply_checkpoint_fault(port_dir, cls, offset=offset)
    assert desc == jchaos.apply_checkpoint_fault(jax_dir, cls, offset=offset)
    damaged = 4 - offset
    assert desc.startswith(f"{cls} step={damaged}")
    cmp = filecmp.dircmp(port_dir / str(damaged), jax_dir / str(damaged))
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    for name in cmp.common_files:
        assert (port_dir / str(damaged) / name).read_bytes() == (
            jax_dir / str(damaged) / name).read_bytes()

    restored = _restore(port_dir)
    want = 4 if offset else 3  # an older damaged step stays until it is reached
    assert restored.step == want and restored.data_state == {"position": want}
    _assert_equal_state(restored, states[want])
    quarantined = sorted(p.name for p in port_dir.iterdir() if p.name.startswith("corrupt-"))
    assert quarantined == ([] if offset else [f"corrupt-{damaged}"])


def test_three_classes_stacked_as_the_schedule_places_them(saved, tmp_path):
    """One crash boundary carrying all three storage faults at offsets 0,
    1 and 2: the fallback walk meets every one and lands on step 1."""
    root, states = saved
    work = tmp_path / "ck"
    shutil.copytree(root, work)
    for offset, cls in enumerate(("corrupt_manifest", "truncate_checkpoint",
                                  "corrupt_checkpoint")):
        assert chaos.apply_checkpoint_fault(work, cls, offset=offset)
    restored = _restore(work)
    assert restored.step == 1
    _assert_equal_state(restored, states[1])
    assert sorted(p.name for p in work.iterdir() if p.name.startswith("corrupt-")) == [
        "corrupt-2", "corrupt-3", "corrupt-4"]


def test_nothing_to_damage_and_unknown_class(tmp_path, saved):
    root, _ = saved
    assert chaos.apply_checkpoint_fault(root, "corrupt_checkpoint", offset=10) is None
    (tmp_path / "empty").mkdir()
    assert chaos.apply_checkpoint_fault(tmp_path / "empty", "truncate_checkpoint") is None
    work = tmp_path / "ck"
    shutil.copytree(root, work)
    with pytest.raises(ValueError, match="unknown storage fault class"):
        chaos.apply_checkpoint_fault(work, "melt")


# -- the wrappers -------------------------------------------------------------


class _NumpyStream:
    """A resumable numpy stream: batch p is a pure function of p."""

    def __init__(self, n=None):
        self.position, self.n = 0, n

    def state_dict(self):
        return {"position": self.position}

    def load_state_dict(self, state):
        self.position = int(state["position"])

    def __iter__(self):
        while self.n is None or self.position < self.n:
            p = self.position
            self.position += 1
            yield {"x": np.full((2, 3), p, np.float32), "y": np.arange(2, dtype=np.int32) + p}


def test_spiked_data_equals_jax_on_a_numpy_stream():
    port = chaos.SpikedData(_NumpyStream(), [2, 5], scale=1e3)
    jax_ = jchaos.SpikedData(_NumpyStream(), [2, 5], scale=1e3)
    for _, a, b in zip(range(8), port, jax_):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    assert port.position == jax_.position == 8


def test_spiked_data_scales_only_float_tensors_at_its_positions():
    base = SyntheticImages(4, image_size=8, num_classes=10, vary_per_step=True, device="cpu")
    bare = [b for b, _ in zip(SyntheticImages(4, image_size=8, num_classes=10,
                                              vary_per_step=True, device="cpu"), range(6))]
    spiked = chaos.SpikedData(base, [1, 4], scale=1e3)
    for pos, (batch, _) in enumerate(zip(spiked, range(6))):
        scale = 1e3 if pos in (1, 4) else 1.0
        assert torch.equal(batch["image"], bare[pos]["image"] * scale)
        assert torch.equal(batch["label"], bare[pos]["label"])
        assert batch["label"].dtype == torch.int64


def test_wrapper_keeps_the_resumable_data_protocol():
    stream = SyntheticImages(4, image_size=8, num_classes=10, vary_per_step=True, device="cpu")
    wrapped = chaos.SpikedData(stream, [3])
    it = iter(wrapped)
    first = [next(it) for _ in range(3)]
    assert wrapped.position == 3 and wrapped.state_dict() == stream.state_dict()
    state = wrapped.state_dict()
    tail = [next(it) for _ in range(3)]

    again = chaos.SpikedData(SyntheticImages(4, image_size=8, num_classes=10,
                                             vary_per_step=True, device="cpu"), [3])
    again.load_state_dict(state)
    assert again.position == 3
    resumed = [b for b, _ in zip(again, range(3))]
    for a, b in zip(tail, resumed):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert not torch.equal(first[0]["image"], tail[0]["image"])

    # perturb is there exactly when the wrapped stream has one
    assert callable(wrapped.perturb)
    wrapped.perturb(7)
    assert wrapped.state_dict()["salt"] == 7
    fixed = chaos.SpikedData(SyntheticImages(4, image_size=8, device="cpu"), [])
    assert not callable(getattr(fixed, "perturb", None))
    assert not hasattr(chaos.SpikedData(_NumpyStream(), []), "perturb")


def test_wrapper_ends_a_finite_stream_cleanly_and_reads_records_positions():
    assert len(list(chaos.SpikedData(_NumpyStream(n=4), [1]))) == 4

    class Records(_NumpyStream):
        def state_dict(self):
            return {"batches_delivered": self.position}

    wrapped = chaos.ResumableWrapper(Records())
    it = iter(wrapped)
    next(it)
    next(it)
    assert wrapped.position == 2


def test_rebind_waits_for_elastic_resize():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        chaos.SpikedData(_NumpyStream(), []).rebind(None)
