"""Serving ResNet from the port's checkpoints, and the model-server binary.

`Servable.from_checkpoint` against JAX's logits on the same weights
(modelled on tests/test_serving.py's round trip): the port's checkpoint
holds `tiny_resnet` weights converted from numpy arrays in flax's layout
(tests/test_torch_resnet.py's `flax_weights`), and the restored servable
must answer as JAX's eval forward does, f32 atol = rtol = 1e-4. A
checkpoint that `fit()` wrote serves in eval mode at its step's version.
Then the binary's app, with and without ``--model``, batching on, and
its refusals.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_resnet import flax_weights  # noqa: E402

from kubeflow_tpu.models import resnet as jr  # noqa: E402
from kubeflow_tpu_torch.models import convert  # noqa: E402
from kubeflow_tpu_torch.models import resnet as tr  # noqa: E402
from kubeflow_tpu_torch.serving import Servable  # noqa: E402
from kubeflow_tpu_torch.serving import __main__ as binary  # noqa: E402
from kubeflow_tpu_torch.train import (  # noqa: E402
    Checkpointer,
    SyntheticImages,
    TrainConfig,
    Trainer,
    fit,
)
from kubeflow_tpu_torch.train.trainer import batch_stats  # noqa: E402
from kubeflow_tpu_torch.web import TestClient  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


def _images(n, side=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, side, side, 3)).astype(np.float32)


def test_from_checkpoint_roundtrip_matches_jax(tmp_path):
    params, stats = flax_weights(jr.tiny_resnet(), 32)
    model = tr.tiny_resnet(device="cpu")
    model.load_state_dict(convert.resnet_from_flax(params, stats))
    trainer = Trainer(model, TrainConfig(batch_size=4), device="cpu")
    ckpt = Checkpointer(tmp_path / "ckpt", save_interval_steps=1)
    ckpt.save(7, trainer.init_state(), force=True)
    ckpt.close()

    # A fresh module from another seed: everything served is restored.
    servable = Servable.from_checkpoint(
        "restored", tr.tiny_resnet(device="cpu", seed=5), tmp_path / "ckpt",
        np.zeros((1, 32, 32, 3), np.float32), max_batch=4, device="cpu")
    assert servable.version == 7 and not servable.variables.training
    x = _images(3, seed=1)
    want = np.asarray(jr.tiny_resnet().apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    np.testing.assert_allclose(servable.predict(x), want, **TOL)
    with pytest.raises(FileNotFoundError):
        Servable.from_checkpoint("none", tr.tiny_resnet(device="cpu"), tmp_path / "missing",
                                 np.zeros((1, 32, 32, 3), np.float32), device="cpu")


def test_fit_checkpoint_serves_in_eval_mode_at_its_step(tmp_path):
    trainer = Trainer(tr.tiny_resnet(device="cpu"), TrainConfig(batch_size=8, warmup_steps=1),
                      device="cpu")
    data = SyntheticImages(8, 32, 10, vary_per_step=True, device="cpu")
    fit(trainer, data, 3, rng=0, checkpointer=Checkpointer(tmp_path / "ckpt",
                                                           save_interval_steps=2),
        log_every=1, handle_signals=False)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2", "3"]
    servable = Servable.from_checkpoint(
        "resnet", tr.tiny_resnet(device="cpu", seed=9), tmp_path / "ckpt",
        np.zeros((1, 32, 32, 3), np.float32), max_batch=4, device="cpu")
    assert servable.version == 3
    served = servable.variables
    restored = {n: b.clone() for n, b in batch_stats(trainer.model).items()}
    for name, value in restored.items():
        assert torch.equal(batch_stats(served)[name], value), name
    x = _images(4, seed=2)
    trainer.model.eval()
    with torch.no_grad():
        want = trainer.model(torch.from_numpy(x)).numpy()
        trainer.model.train()
        in_train_mode = trainer.model(torch.from_numpy(x)).numpy()
    got = servable.predict(x)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - in_train_mode).max() > 1e-3
    # Serving never moved the statistics.
    for name, value in batch_stats(served).items():
        assert torch.equal(value, restored[name]), name


def test_from_module_serves_in_eval_mode():
    model = tr.tiny_resnet(device="cpu").train()
    servable = Servable.from_module("m", model, max_batch=2, device="cpu")
    assert not model.training
    before = {n: b.clone() for n, b in batch_stats(model).items()}
    servable.predict(_images(2))
    for name, value in batch_stats(model).items():
        assert torch.equal(value, before[name]), name


def test_binary_app_serves_the_demo_model_batched():
    app = binary.build_app([], max_batch=4, batch_timeout_ms=20.0, device="cpu")
    client = TestClient(app)
    try:
        assert client.get("/v1/models").json() == {"models": ["demo"]}
        outs = [None] * 4

        def post(i):
            outs[i] = client.post("/v1/models/demo:predict",
                                  {"instances": _images(1, seed=i).tolist()})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        servable = app.repository.get("demo")
        for i, resp in enumerate(outs):
            assert resp.status == 200, resp.body
            got = np.asarray(resp.json()["predictions"], np.float32)
            np.testing.assert_allclose(got, servable.predict(_images(1, seed=i)), **TOL)
        batches = app._metrics_registry.expose_text()
        assert "serving_batches_total" in batches
        assert app._batchers[("demo", 1)].config.timeout_ms == 20.0
    finally:
        app.close_batchers()
    unbatched = binary.build_app([], max_batch=2, device="cpu")
    assert unbatched._batching is None


def test_binary_app_restores_resnet50_from_a_checkpoint(tmp_path):
    """`--model resnet=DIR`: the newest step restored into resnet50() at
    that step's version (max_batch 2 keeps the CPU warm-up small)."""
    model = tr.resnet50(device="cpu", seed=3)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, tr.BatchNorm):
                bn.running_var.fill_(2.0)
    tree = {"params": {n: p.detach() for n, p in model.named_parameters()},
            "batch_stats": batch_stats(model)}
    ckpt = Checkpointer(tmp_path / "r50")
    ckpt.save(12, tree, force=True)
    ckpt.close()
    app = binary.build_app([binary.parse_model_spec(f"resnet={tmp_path / 'r50'}")],
                           max_batch=2, device="cpu")
    servable = app.repository.get("resnet")
    assert servable.version == 12
    x = _images(1, side=224, seed=4)
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    got = TestClient(app).post("/v1/models/resnet:predict", {"instances": x.tolist()})
    assert got.status == 200
    np.testing.assert_array_equal(np.asarray(got.json()["predictions"], np.float32), want)


@pytest.mark.parametrize("argv,match", [
    (["--apiserver", "http://x"], "--apiserver and --replica go together"),
    (["--replica", "r"], "--apiserver and --replica go together"),
    (["--model", "nodir"], "NAME=CKPT_DIR"),
    (["--model", "=dir"], "NAME=CKPT_DIR"),
])
def test_binary_refuses(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        binary.main(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err
