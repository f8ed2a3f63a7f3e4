"""The port's serving stack against the JAX package's, on the CPU.

A tiny f32 TransformerLM, converted from the JAX model's init, behind
the port's `Servable` → `ModelRepository` → `ModelServerApp`; the JAX
`Servable` on the same weights is the golden. Also: the port imports no
JAX, and its entry points refuse to run on the CPU unless asked to.
"""

import ast
import pathlib
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import transformer as jtf
from kubeflow_tpu.serving.servable import Servable as JaxServable
from kubeflow_tpu.serving.servable import _buckets as jax_buckets
from kubeflow_tpu_torch.models import convert
from kubeflow_tpu_torch.models import transformer as ttf
from kubeflow_tpu_torch.serving import ModelRepository, ModelServerApp, Servable
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.servable import _buckets
from kubeflow_tpu_torch.web import TestClient, serve

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, head_dim=16,
            d_ff=128, flash_block_q=64, flash_block_k=64)
SEQ = 24
TOL = dict(atol=1e-5, rtol=1e-5)


def _last_logits(model, tokens):
    return model(tokens)[:, -1]


@pytest.fixture(scope="module")
def models():
    jmodel = jtf.TransformerLM(
        jtf.TransformerConfig(**TINY, dtype=jnp.float32, attention_impl="flash")
    )
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
    tmodel = ttf.TransformerLM(
        ttf.TransformerConfig(**TINY, dtype=torch.float32), device="cpu"
    )
    params = jax.tree.map(np.asarray, fnn.meta.unbox(variables["params"]))
    tmodel.load_state_dict(convert.from_flax(params))
    golden = JaxServable(
        "lm", lambda v, batch: jmodel.apply(v, batch)[:, -1], variables,
        max_batch=4,
    )
    return golden, tmodel


@pytest.fixture(scope="module")
def servable(models):
    return Servable("lm", _last_logits, models[1], max_batch=4, device="cpu")


@pytest.fixture(scope="module")
def client(servable):
    return TestClient(ModelServerApp(ModelRepository([servable])))


def _instances(n, seed=0, seq=SEQ):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (n, seq))


def test_buckets_match_jax():
    for max_batch in (1, 4, 6, 8, 64):
        assert _buckets(max_batch) == jax_buckets(max_batch)
    assert _buckets(6) == [1, 2, 4, 6]


def test_predict_matches_jax_servable(models, servable):
    golden, _ = models
    batch = _instances(3)  # padded to bucket 4
    np.testing.assert_allclose(
        servable.predict(batch), golden.predict(batch), **TOL
    )


def test_padding_and_chunking_keep_rows(servable, models):
    golden, _ = models
    batch = _instances(9, seed=1)  # > max_batch: chunks 4 + 4 + 1
    got = servable.predict(batch)
    assert got.shape == (9, TINY["vocab_size"])
    np.testing.assert_allclose(got, golden.predict(batch), **TOL)
    solo = np.concatenate([servable.predict(batch[i:i + 1]) for i in range(9)])
    np.testing.assert_allclose(got, solo, **TOL)


def test_warmup_runs_every_bucket(models):
    calls = []

    def apply_fn(model, tokens):
        calls.append(tokens.shape[0])
        return _last_logits(model, tokens)

    s = Servable("lm", apply_fn, models[1], max_batch=4, device="cpu")
    s.warmup_with(_instances(1)[0])
    assert calls == [1, 2, 4]
    with pytest.raises(ValueError):
        s.predict(np.zeros((0, SEQ), np.int64))


def test_from_module_wraps_the_module(models):
    s = Servable.from_module(
        "lm", models[1], max_batch=2, device="cpu",
        warmup_example=_instances(1)[0],
    )
    out = s.predict(_instances(2, seed=5))
    assert out.shape == (2, SEQ, TINY["vocab_size"])


def test_model_list_and_status(client):
    assert client.get("/v1/models").json() == {"models": ["lm"]}
    status = client.get("/v1/models/lm").json()["model_version_status"]
    assert status == [{"version": "1", "state": "AVAILABLE",
                       "status": {"error_code": "OK", "error_message": ""}}]
    assert client.get("/v1/models/lm/versions/1").status == 200
    assert client.get("/v1/models/lm:predict").status == 405
    assert client.get("/healthz").json()["ok"] is True


def test_json_predict_matches_jax(client, models):
    golden, _ = models
    batch = _instances(3, seed=2)
    resp = client.post("/v1/models/lm:predict", {"instances": batch.tolist()})
    assert resp.status == 200, resp.body
    got = np.asarray(resp.json()["predictions"])
    assert got.shape == (3, TINY["vocab_size"])
    np.testing.assert_allclose(got, golden.predict(batch), **TOL)
    versioned = client.post(
        "/v1/models/lm/versions/1:predict", {"instances": batch.tolist()}
    )
    np.testing.assert_allclose(
        np.asarray(versioned.json()["predictions"]), got, atol=0, rtol=0
    )


def test_binary_predict_matches_jax(client, models):
    golden, _ = models
    batch = _instances(2, seed=3).astype(np.int32)
    resp = client.post(
        "/v1/models/lm:predict", raw=wire.encode_tensor(batch),
        content_type=wire.TENSOR_CONTENT_TYPE,
    )
    assert resp.status == 200, resp.body
    assert resp.content_type == wire.TENSOR_CONTENT_TYPE
    got = wire.decode_tensor(resp.body)
    assert got.dtype == np.float32 and got.shape == (2, TINY["vocab_size"])
    np.testing.assert_allclose(got, golden.predict(batch), **TOL)


def test_json_request_can_ask_for_a_tensor_answer(client):
    batch = _instances(1, seed=6)
    resp = client.post(
        "/v1/models/lm:predict", {"instances": batch.tolist()},
        headers={"Accept": wire.TENSOR_CONTENT_TYPE},
    )
    assert resp.status == 200
    assert wire.decode_tensor(resp.body).shape == (1, TINY["vocab_size"])


def test_repository_versions(models):
    v1 = Servable("lm", _last_logits, models[1], version=1, device="cpu")
    v2 = Servable("lm", _last_logits, models[1], version=2, device="cpu")
    repo = ModelRepository([v1, v2])
    client = TestClient(ModelServerApp(repo))
    versions = client.get("/v1/models/lm").json()["model_version_status"]
    assert [v["version"] for v in versions] == ["1", "2"]
    assert repo.get("lm") is v2 and repo.get("lm", 1) is v1
    repo.unload("lm", 1)
    assert client.get("/v1/models/lm/versions/1").status == 404
    repo.unload("lm", 2)
    assert repo.names() == [] and client.get("/v1/models/lm").status == 404


@pytest.mark.parametrize(
    "path,body,status",
    [
        ("/v1/models/lm:predict", {"instances": [[1, 2, 3], [4, 5]]}, 400),
        ("/v1/models/lm:predict", {"instances": []}, 400),
        ("/v1/models/lm:explain", {"instances": [[1, 2]]}, 400),
        ("/v1/models/nope:predict", {"instances": [[1, 2]]}, 404),
        ("/v1/models/lm/versions/7:predict", {"instances": [[1, 2]]}, 404),
    ],
    ids=["ragged", "empty", "verb", "unknown-model", "unknown-version"],
)
def test_bad_requests(client, path, body, status):
    assert client.post(path, body).status == status


def test_bad_tensor_frame_is_400(client):
    resp = client.post(
        "/v1/models/lm:predict", raw=b"not a frame",
        content_type=wire.TENSOR_CONTENT_TYPE,
    )
    assert resp.status == 400


def test_device_fault_is_500_and_counted(models):
    def oom(model, tokens):
        raise torch.OutOfMemoryError("CUDA out of memory")

    app = ModelServerApp(
        ModelRepository([Servable("lm", oom, models[1], device="cpu")])
    )
    client = TestClient(app)
    assert client.post("/v1/models/lm:predict", {"instances": [[1]]}).status == 500
    assert app.request_count.value(model="lm", outcome="error") == 1
    assert 'outcome="error"' in client.get("/metrics").body.decode()


def test_http_server_answers_predict(servable, models):
    """The threaded HTTP/1.1 server end to end (predict runs on a
    server thread, where inference_mode must be entered anew)."""
    import json
    import urllib.request

    golden, _ = models
    server, thread = serve(
        ModelServerApp(ModelRepository([servable])), host="127.0.0.1", port=0
    )
    try:
        batch = _instances(2, seed=4)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_port}/v1/models/lm:predict",
            data=json.dumps({"instances": batch.tolist()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = np.asarray(json.loads(resp.read())["predictions"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    np.testing.assert_allclose(got, golden.predict(batch), **TOL)


# -- the port stands alone ---------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "kubeflow_tpu")


# The training job's modules, the ResNet slice's (the model, the
# batching scheduler, the binary) and the multi-model front door's,
# imported by the walk below like every other.
_TRAIN = tuple(f"kubeflow_tpu_torch.train.{m}" for m in (
    "guard", "trainer", "checkpoint", "profiling", "loop", "data")) + (
    "kubeflow_tpu_torch.utils.threads", "kubeflow_tpu_torch.models.resnet",
    "kubeflow_tpu_torch.models.convert", "kubeflow_tpu_torch.serving.batching",
    "kubeflow_tpu_torch.serving.__main__", "kubeflow_tpu_torch.web.wsgi") + tuple(
    f"kubeflow_tpu_torch.serving.{m}" for m in (
        "admission", "router", "registry", "replica")) + tuple(
    f"kubeflow_tpu_torch.testing.{m}" for m in ("tinymodels", "loadgen", "chaos"))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys, kubeflow_tpu_torch\n"
        "for m in pkgutil.walk_packages(kubeflow_tpu_torch.__path__, "
        "'kubeflow_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}))\n"
        f"print(sorted(m for m in {_TRAIN!r} if m not in sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.split("\n")[:2] == ["[]", "[]"], out.stdout


def test_no_port_file_imports_jax():
    files = sorted((REPO / "kubeflow_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_entry_points_refuse_cpu_without_device(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttf.TransformerConfig(**TINY, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Servable("lm", _last_logits, models[1])
    # The front door's model factories: the binary's (both of its
    # branches) and the tiny models.
    from kubeflow_tpu_torch.serving.__main__ import build_servable_from_rspec
    from kubeflow_tpu_torch.testing.tinymodels import TinyMLP

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_servable_from_rspec({"model": "demo"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_servable_from_rspec({"model": "r", "checkpointDir": "/nonexistent"})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TinyMLP(8)
