"""The record dataset's CUDA iterator on the card (`train/records.py`).
These tests need an NVIDIA GPU and skip without one. They import
neither JAX nor the JAX package, so on a GPU machine without JAX they
run with the repository's conftest left out:

    python -m pytest tests/test_torch_cuda_records.py -q --noconftest

- the pinned ring: batches on the card equal the dataset's arrays (the
  short final batch sliced), with the spec's dtypes; the host buffers
  are pinned; the position counts yielded batches while the reader
  thread reads ahead; a reposition drops what was read ahead;
- int32 labels (as records carry them) gather in
  `softmax_cross_entropy` on the card exactly as int64 labels do.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.train import records
from kubeflow_tpu_torch.train.trainer import softmax_cross_entropy

SPEC = records.RecordSpec.of(image=("uint8", (8, 8, 3)), label=("int32", ()),
                             weight=("float32", (2,)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the iterator's pinned ring copies to the card")
    return torch.device("cuda")


def _file(tmp_path, n=45):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "a.rec")
    records.write_records(path, SPEC, ({
        "image": rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
        "label": np.int32(i), "weight": rng.standard_normal(2).astype(np.float32),
    } for i in range(n)))
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_pinned_ring_batches_equal_the_arrays(cuda, tmp_path, drop_remainder):
    path = _file(tmp_path)
    kwargs = dict(batch_size=8, shuffle_buffer=45, seed=3, epochs=2,
                  drop_remainder=drop_remainder)
    want = list(records.RecordDataset(path, SPEC, **kwargs))
    it = records.RecordDataset(path, SPEC, **kwargs).device_iter()
    got = []
    for k, batch in enumerate(it, start=1):
        assert it.state_dict() == {"batches_delivered": k}
        assert all(t.device.type == "cuda" for t in batch.values())
        got.append({key: t.cpu().numpy() for key, t in batch.items()})
    assert it._reader is not None and all(b.is_pinned() for b in it._reader._host)
    assert len(got) == len(want) == (10 if drop_remainder else 12)
    for a, b in zip(got, want):
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.cuda
def test_reposition_drops_the_read_ahead(cuda, tmp_path):
    path = _file(tmp_path)
    kwargs = dict(batch_size=4, shuffle_buffer=45, seed=1, epochs=0)
    want = [b["label"] for _, b in zip(range(20), records.RecordDataset(path, SPEC, **kwargs))]
    it = records.RecordDataset(path, SPEC, **kwargs).device_iter()
    for _ in range(3):
        next(it)
    torch.cuda.synchronize()
    # The reader thread has read ahead of the three batches yielded.
    assert it._dataset.state_dict()["batches_delivered"] > 3
    assert it.state_dict() == {"batches_delivered": 3}
    it.load_state_dict({"batches_delivered": 13})  # past the first epoch (11 batches)
    np.testing.assert_array_equal(next(it)["label"].cpu().numpy(), want[13])
    it.load_state_dict({"batches_delivered": 2})
    for k in range(2, 6):
        np.testing.assert_array_equal(next(it)["label"].cpu().numpy(), want[k])
    assert it.state_dict() == {"batches_delivered": 6}


@pytest.mark.cuda
def test_int32_labels_gather_in_the_loss_on_the_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    logits = torch.randn(256, 1000, generator=gen, device=cuda)
    labels = torch.randint(0, 1000, (256,), generator=gen, device=cuda)
    for smoothing in (0.0, 0.1):
        a = softmax_cross_entropy(logits, labels.to(torch.int32), smoothing)
        b = softmax_cross_entropy(logits, labels, smoothing)
        assert torch.equal(a, b)
