"""The port's record loader (`kubeflow_tpu_torch/native/`) and typed
datasets (`train/records.py`) against the JAX package's.

First JAX's own tests (tests/test_records.py) run against the port: the
module's source with its imports pointed at the port, every test but
the 8-device mesh one, whose one-device counterpart below reads
`device_iter("cpu")`. Then both packages run on the same files:

- a file written by either package's writer reads byte for byte the
  same through the other's loader;
- every shard's label sequence is equal between the packages over
  seeds, shard counts, shuffle buffers (none, smaller than a batch,
  between, and the whole shard), epochs and `drop_remainder`: the port
  keeps the JAX loader's round-robin shards and its mt19937_64 buffered
  shuffle;
- `decode_batch` is equal, and `load_state_dict` to positions 0, 3 and
  past an epoch gives equal next batches.

`device_iter("cpu")` yields tensors equal to the dataset's arrays, with
the spec's dtypes, and its `state_dict()` counts the batches it
yielded.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeflow_tpu.native import dataloader as j_loader
from kubeflow_tpu.train import records as j_records
from kubeflow_tpu_torch.native import build as t_build
from kubeflow_tpu_torch.native import dataloader as t_loader
from kubeflow_tpu_torch.train import records as t_records

REPO = Path(__file__).resolve().parents[1]
JAX_ONLY = ("test_device_iter_shards_on_mesh",)


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: its test functions by name."""
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") and callable(v) and k not in JAX_ONLY}


PORT = _jax_tests_on_the_port(REPO / "tests" / "test_records.py")


@pytest.mark.parametrize("name", sorted(PORT))
def test_jax_records_tests_on_the_port(name, tmp_path):
    fn = PORT[name]
    fn(tmp_path) if fn.__code__.co_argcount else fn()


SPEC = t_records.RecordSpec.of(image=("uint8", (4, 4, 3)), label=("int32", ()))
J_SPEC = j_records.RecordSpec.of(image=("uint8", (4, 4, 3)), label=("int32", ()))


def _examples(n: int, offset: int = 0):
    rng = np.random.default_rng(offset)
    return [{"image": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
             "label": np.int32(offset + i)} for i in range(n)]


def test_device_iter_on_one_device(tmp_path):
    """The mesh8 case on one device: `device_iter("cpu")` yields the
    dataset's batches as tensors of the spec's dtypes and shapes."""
    path = str(tmp_path / "a.rec")
    t_records.write_records(path, SPEC, _examples(16))
    ds = t_records.RecordDataset(path, SPEC, batch_size=8, epochs=1)
    batch = next(ds.device_iter("cpu"))
    assert batch["image"].shape == (8, 4, 4, 3) and batch["image"].dtype == torch.uint8
    assert batch["label"].shape == (8,) and batch["label"].dtype == torch.int32
    assert batch["image"].device.type == "cpu"


def test_device_iter_equals_the_arrays_and_counts_yielded_batches(tmp_path):
    path = str(tmp_path / "a.rec")
    t_records.write_records(path, SPEC, _examples(22))
    kwargs = dict(batch_size=4, shuffle_buffer=7, seed=5, epochs=2, drop_remainder=False)
    arrays = list(t_records.RecordDataset(path, SPEC, **kwargs))
    it = t_records.RecordDataset(path, SPEC, **kwargs).device_iter("cpu")
    assert it.state_dict() == {"batches_delivered": 0}
    got = []
    for k, batch in enumerate(it, start=1):
        assert it.state_dict() == {"batches_delivered": k}
        got.append(batch)
    assert len(got) == len(arrays) == 12  # 5 full + 1 short batch, two epochs
    for want, have in zip(arrays, got):
        assert set(have) == set(want)
        for key in want:
            assert have[key].dtype == torch.from_numpy(want[key]).dtype
            np.testing.assert_array_equal(have[key].numpy(), want[key])
    assert got[5]["label"].shape == (2,)  # the short final batch, sliced


def test_device_iter_repositions_and_drops_a_stale_pass(tmp_path):
    path = str(tmp_path / "a.rec")
    t_records.write_records(path, SPEC, _examples(24))
    kwargs = dict(batch_size=4, shuffle_buffer=24, seed=1, epochs=0)
    want = [b["label"] for _, b in zip(range(9), t_records.RecordDataset(path, SPEC, **kwargs))]
    it = t_records.RecordDataset(path, SPEC, **kwargs).device_iter("cpu")
    for _ in range(4):
        next(it)
    it.load_state_dict({"batches_delivered": 7})  # past the first epoch (6 batches)
    assert it.state_dict() == {"batches_delivered": 7}
    np.testing.assert_array_equal(next(it)["label"].numpy(), want[7])
    it.load_state_dict({"batches_delivered": 2})  # backwards: reopen and fast-forward
    np.testing.assert_array_equal(next(iter(it))["label"].numpy(), want[2])
    assert it.state_dict() == {"batches_delivered": 3}


def test_device_iter_defaults_to_cuda_and_refuses_rebind(tmp_path):
    path = str(tmp_path / "a.rec")
    t_records.write_records(path, SPEC, _examples(4))
    ds = t_records.RecordDataset(path, SPEC, batch_size=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ds.device_iter()
    with pytest.raises(NotImplementedError, match="item 12"):
        ds.device_iter("cpu").rebind(object())
    assert not hasattr(ds, "perturb") and not hasattr(ds.device_iter("cpu"), "perturb")


def test_loader_builds_from_the_port_sources_alone():
    lib = t_build.build("dataloader")
    assert lib.parent == REPO / "build" / "kubeflow_tpu_torch"
    assert lib == t_build.target("dataloader") and lib.exists()
    assert t_build.sources("dataloader") == (t_build.CSRC / "dataloader.cc",)
    assert {p.name for p in t_build.CSRC.glob("dataloader*")} == {"dataloader.cc",
                                                                  "dataloader.h"}


def test_loader_build_without_a_compiler_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        t_build._cxx()


def test_loader_next_fills_a_caller_buffer(tmp_path):
    path = str(tmp_path / "a.rec")
    t_records.write_records(path, SPEC, _examples(6))
    loader = t_loader.RecordLoader(path, batch_size=4, epochs=1, drop_remainder=False)
    out = np.zeros((4, SPEC.record_bytes), np.uint8)
    raw, n = loader.next(out=out)
    assert raw is out and n == 4
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        loader.next(out=np.zeros((4, SPEC.record_bytes + 1), np.uint8))
    raw, n = loader.next(out=out)
    assert n == 2 and loader.next(out=out) is None


# -- the two packages on the same files ---------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_read_identically_across_packages(tmp_path, writer):
    path = str(tmp_path / "a.rec")
    examples = _examples(13, offset=7)
    if writer == "jax":
        j_records.write_records(path, J_SPEC, iter(examples))
    else:
        t_records.write_records(path, SPEC, iter(examples))
    assert t_loader.stat_record_file(path) == j_loader.stat_record_file(path)
    kwargs = dict(batch_size=5, shuffle_buffer=6, seed=2, epochs=2, drop_remainder=False)
    j_batches = list(j_loader.RecordLoader(path, **kwargs))
    t_batches = list(t_loader.RecordLoader(path, **kwargs))
    assert [n for _, n in t_batches] == [n for _, n in j_batches] == [5, 5, 3] * 2
    for (tr, tn), (jr, jn) in zip(t_batches, j_batches):
        np.testing.assert_array_equal(tr[:tn], jr[:jn])
    raw = t_batches[0][0]
    t_dec, j_dec = SPEC.decode_batch(raw), J_SPEC.decode_batch(raw)
    for key in j_dec:
        assert t_dec[key].dtype == j_dec[key].dtype
        np.testing.assert_array_equal(t_dec[key], j_dec[key])


def _label_sequences(records, path, spec, shards, **kwargs):
    out = []
    for shard in range(shards):
        env = records.ProcessEnv(coordinator="c:1", num_processes=shards, process_id=shard) \
            if shards > 1 else None
        ds = records.RecordDataset(path, spec, batch_size=4 * shards, process_env=env, **kwargs)
        out.append([[int(x) for x in b["label"]] for b in ds])
    return out


@pytest.fixture(scope="module")
def shared_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("records") / "shared.rec")
    t_records.write_records(path, SPEC, _examples(37))
    return path


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("shuffle_buffer", [0, 5, 12, 64])
@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("seed", [0, 3, 4])
def test_label_sequence_equals_jax(shared_file, seed, shards, shuffle_buffer, epochs,
                                   drop_remainder):
    kwargs = dict(shuffle_buffer=shuffle_buffer, seed=seed, epochs=epochs,
                  drop_remainder=drop_remainder)
    want = _label_sequences(j_records, shared_file, J_SPEC, shards, **kwargs)
    got = _label_sequences(t_records, shared_file, SPEC, shards, **kwargs)
    assert got == want
    assert sum(len(b) for seq in got for b in seq) > 0


@pytest.mark.parametrize("position", [0, 3, 12])
def test_load_state_dict_positions_equal_jax(shared_file, position):
    """12 batches of 4 lie past the first epoch's 9 (37 records,
    drop_remainder)."""
    kwargs = dict(batch_size=4, shuffle_buffer=37, seed=4, epochs=0)
    j_ds = j_records.RecordDataset(shared_file, J_SPEC, **kwargs)
    t_ds = t_records.RecordDataset(shared_file, SPEC, **kwargs)
    next(iter(j_ds)), next(iter(t_ds))  # a loader that has moved
    j_ds.load_state_dict({"batches_delivered": position})
    t_ds.load_state_dict({"batches_delivered": position})
    assert t_ds.state_dict() == j_ds.state_dict() == {"batches_delivered": position}
    for _ in range(3):
        j_batch, t_batch = next(iter(j_ds)), next(iter(t_ds))
        for key in j_batch:
            np.testing.assert_array_equal(t_batch[key], j_batch[key])
