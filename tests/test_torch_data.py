"""The port's synthetic token stream and its resumable-data protocol.

The batches themselves cannot match JAX's (threefry draws), so these
tests hold the protocol of `kubeflow_tpu/train/data.py:37-111`: the
position counts batches yielded, ``load_state_dict`` resumes the exact
sequence, ``perturb`` changes the future without moving the position
and is absent on a fixed stream, and the labels are the next tokens.
"""

import itertools

import pytest
import torch

from kubeflow_tpu_torch.train import SyntheticTokens


def _take(stream, n):
    return list(itertools.islice(iter(stream), n))


def test_batches_are_next_token_pairs():
    stream = SyntheticTokens(3, 16, 50, seed=1, device="cpu")
    batch = _take(stream, 1)[0]
    assert batch["tokens"].shape == (3, 16) and batch["labels"].shape == (3, 16)
    assert batch["tokens"].dtype == torch.int64
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < 50


def test_fixed_stream_repeats_one_batch_and_has_no_perturb():
    stream = SyntheticTokens(2, 8, 100, device="cpu")
    a, b, c = _take(stream, 3)
    assert a is b is c
    assert stream.perturb is None
    assert stream.state_dict() == {"position": 3, "salt": 0}
    again = SyntheticTokens(2, 8, 100, device="cpu")
    assert torch.equal(_take(again, 1)[0]["tokens"], a["tokens"])


def test_varying_stream_resumes_exactly():
    stream = SyntheticTokens(2, 8, 1000, seed=3, vary_per_step=True, device="cpu")
    first = _take(stream, 5)
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    resumed = SyntheticTokens(2, 8, 1000, seed=3, vary_per_step=True, device="cpu")
    resumed.load_state_dict({"position": 2, "salt": 0})
    for want, got in zip(first[2:], _take(resumed, 3)):
        assert torch.equal(want["tokens"], got["tokens"])
    assert resumed.state_dict()["position"] == 5


def test_perturb_changes_the_future_not_the_position():
    stream = SyntheticTokens(2, 8, 1000, vary_per_step=True, device="cpu")
    base = _take(SyntheticTokens(2, 8, 1000, vary_per_step=True, device="cpu"), 4)
    _take(stream, 2)
    stream.perturb(7)
    assert stream.state_dict() == {"position": 2, "salt": 7}
    after = _take(stream, 2)
    assert not torch.equal(after[0]["tokens"], base[2]["tokens"])
    replay = SyntheticTokens(2, 8, 1000, vary_per_step=True, device="cpu")
    replay.load_state_dict({"position": 2, "salt": 7})
    assert torch.equal(_take(replay, 1)[0]["tokens"], after[0]["tokens"])


def test_seeds_differ_and_bad_batch_is_refused():
    a = _take(SyntheticTokens(2, 8, 1000, seed=0, device="cpu"), 1)[0]
    b = _take(SyntheticTokens(2, 8, 1000, seed=1, device="cpu"), 1)[0]
    assert not torch.equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError):
        SyntheticTokens(0, 8, 10, device="cpu")
