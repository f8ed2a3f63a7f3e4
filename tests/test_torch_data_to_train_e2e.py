"""The port's data path end to end on the CPU: record files on disk → the
port's compiled prefetching loader → `RecordDataset.device_iter` →
`fit()` with checkpointing.

- JAX's `test_records_feed_training_and_loss_drops`
  (tests/test_data_to_train_e2e.py) on the port: tiny_resnet learns a
  label that is a function of its image, from disk, through `fit()`,
  from the weights JAX's `fit()` starts that test from (its
  `init_state(PRNGKey(0))`, converted): the two packages draw their
  inits differently, and the test's bar is relative to the first loss.
  The port's loss curve is held to JAX's too. JAX's cross-topology
  restore needs a multi-device mesh, which the port does not have yet
  (ROADMAP Queue 1 item 12).
- The position: `device_iter`'s `state_dict()` after k yielded batches
  is k at every step and in every checkpoint's manifest, and a `fit()`
  run preempted by SIGTERM and resumed from its save, across an epoch
  boundary of a reshuffled stream, ends bitwise equal to a straight run
  in parameters, momentum and batch-norm statistics.
"""

import json
import os
import signal

import jax
import numpy as np
import torch

from kubeflow_tpu.models import resnet as jr
from kubeflow_tpu.parallel import MeshSpec, build_mesh
from kubeflow_tpu.train import TrainConfig as JTrainConfig
from kubeflow_tpu.train import Trainer as JTrainer
from kubeflow_tpu.train.loop import fit as j_fit
from kubeflow_tpu.train.records import RecordDataset as JRecordDataset
from kubeflow_tpu.train.records import RecordSpec as JRecordSpec
from kubeflow_tpu_torch.models import convert, tiny_resnet
from kubeflow_tpu_torch.train import AnomalyGuard, Checkpointer, Preempted, TrainConfig, Trainer, fit
from kubeflow_tpu_torch.train.records import RecordDataset, RecordSpec, write_records


def _write_dataset(tmp_path, n=64, image=12):
    spec = RecordSpec.of(image=("float32", (image, image, 3)), label=("int32", ()))
    rng = np.random.RandomState(0)
    examples = []
    for _ in range(n):
        # Learnable signal: label = 1 when the image mean is positive.
        img = rng.randn(image, image, 3).astype(np.float32)
        examples.append({"image": img, "label": np.int32(1 if img.mean() > 0 else 0)})
    path = tmp_path / "train.rec"
    write_records(str(path), spec, examples)
    return spec, [str(path)]


def test_records_feed_training_and_loss_drops(tmp_path):
    spec, paths = _write_dataset(tmp_path)
    config = dict(batch_size=16, learning_rate=0.05, warmup_steps=2, total_steps=30)
    mesh = build_mesh(MeshSpec(dp=2), jax.devices()[:2])
    j_trainer = JTrainer(jr.tiny_resnet(num_classes=2), JTrainConfig(**config), mesh,
                         example_input_shape=(2, 12, 12, 3))
    init = j_trainer.init_state(jax.random.PRNGKey(0))
    model = tiny_resnet(num_classes=2, device="cpu")
    model.load_state_dict(convert.resnet_from_flax(
        jax.tree.map(np.asarray, init.params), jax.tree.map(np.asarray, init.batch_stats)))
    trainer = Trainer(model, TrainConfig(**config), device="cpu")
    dataset = RecordDataset(paths, spec, batch_size=16, seed=3, shuffle_buffer=32,
                            drop_remainder=True, epochs=0)
    losses = []
    fit(trainer, dataset.device_iter("cpu"), total_steps=30,
        on_metrics=lambda step, m: losses.append(float(m["loss"])), log_every=1)
    assert len(losses) == 30 and all(np.isfinite(losses))
    # The label is a deterministic function of the image: 30 steps of SGD
    # must make clear progress (typ. 0.75 -> 0.60 here).
    assert min(losses[-5:]) < losses[0] * 0.87, losses[:3] + losses[-3:]

    j_spec = JRecordSpec.of(image=("float32", (12, 12, 3)), label=("int32", ()))
    j_data = JRecordDataset(paths, j_spec, batch_size=16, seed=3, shuffle_buffer=32,
                            drop_remainder=True, epochs=0)
    j_losses = []
    j_fit(j_trainer, j_data.device_iter(mesh), total_steps=30,
          on_metrics=lambda step, m: j_losses.append(float(m["loss"])), log_every=1)
    # The same weights on the same batches: the curves agree to f32
    # rounding over 30 steps of batch-norm training.
    np.testing.assert_allclose(losses, j_losses, rtol=0, atol=1e-5)


# -- the position and a bitwise resume -----------------------------------------

STEPS, SAVE_EVERY, SIGTERM_AT = 9, 3, 5  # Preempted at 6; 5 batches an epoch


def _uint8_dataset(tmp_path):
    spec = RecordSpec.of(image=("uint8", (16, 16, 3)), label=("int32", ()))
    rng = np.random.default_rng(1)
    path = str(tmp_path / "u8.rec")
    write_records(path, spec, ({"image": rng.integers(0, 256, (16, 16, 3), dtype=np.uint8),
                                "label": np.int32(rng.integers(0, 10))} for _ in range(40)))
    return spec, path


def _state(trainer, opt_state):
    return {
        "params": {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
        "momentum": {n: t.clone() for n, t in opt_state["trace"].items()},
        "batch_stats": {n: b.clone() for n, b in trainer.model.named_buffers()},
    }


def test_fit_sigterm_resume_from_records_is_bitwise(tmp_path):
    spec, path = _uint8_dataset(tmp_path)
    trainer = Trainer(tiny_resnet(num_classes=10, device="cpu"),
                      TrainConfig(batch_size=8, learning_rate=0.1, total_steps=100),
                      device="cpu", guard=AnomalyGuard())

    def data():
        return RecordDataset(path, spec, batch_size=8, shuffle_buffer=40, seed=7,
                             epochs=0).device_iter("cpu")

    positions = []

    def track(it, sigterm_at=None):
        def on_metrics(step, rec):
            positions.append((step, it.state_dict()["batches_delivered"]))
            if step == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return on_metrics

    it = data()
    straight = fit(trainer, it, STEPS, rng=0, log_every=1, on_metrics=track(it))
    want = _state(trainer, straight.state.opt_state)

    ckpt = Checkpointer(tmp_path / "ckpt", save_interval_steps=SAVE_EVERY)
    it = data()
    first = fit(trainer, it, STEPS, rng=0, checkpointer=ckpt, log_every=1,
                on_metrics=track(it, SIGTERM_AT))
    ckpt.close()
    assert isinstance(first, Preempted) and first.signum == signal.SIGTERM
    assert int(first.state.step) == SIGTERM_AT + 1
    assert ckpt.all_steps() == [SAVE_EVERY, SIGTERM_AT + 1]
    for step in ckpt.all_steps():
        manifest = json.loads((tmp_path / "ckpt" / str(step) / "kftpu_manifest.json").read_text())
        assert manifest["data_state"] == {"batches_delivered": step}

    ckpt = Checkpointer(tmp_path / "ckpt", save_interval_steps=SAVE_EVERY)
    it = data()
    resumed = fit(trainer, it, STEPS, rng=1, checkpointer=ckpt, log_every=1,
                  on_metrics=track(it))
    ckpt.close()
    assert resumed.resumed_from == SIGTERM_AT + 1 and int(resumed.state.step) == STEPS
    got = _state(trainer, resumed.state.opt_state)
    for group in want:
        for name in want[group]:
            assert torch.equal(got[group][name], want[group][name]), (group, name)
    assert all(step == delivered for step, delivered in positions), positions
    assert len(positions) == STEPS + (SIGTERM_AT + 1) + (STEPS - SIGTERM_AT - 1)
