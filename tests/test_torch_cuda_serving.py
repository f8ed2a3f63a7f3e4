"""The multi-model serving path on the GPU: weight paging and the front door.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so on a GPU machine without JAX run them with

    python -m pytest tests/test_torch_cuda_serving.py -q --noconftest

- Page-out gives the weights' memory back: eight `tiny_resnet`s paged
  through ``max_resident=2`` twice; `torch.cuda.memory_allocated()`
  after the second cycle is within 1 MiB of the first, every servable
  of the first cycle is gone (weak references, garbage collector off),
  and closing the registry returns to the memory before it. Each
  reading lets cuBLAS's per-thread workspaces go first (`_allocated`):
  every scheduler thread that runs a product gets one, and they are not
  weights.
- A `FrontDoorApp` over two multiplexed replicas of `tiny_resnet`s on
  the card answers each model's requests as that model's own forward on
  the card does (f32, atol = rtol = 1e-5: the same module on the same
  batch of one).
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.models.resnet import tiny_resnet
from kubeflow_tpu_torch.serving import (
    BatchingConfig,
    FrontDoorApp,
    MultiModelReplica,
    PagingConfig,
    Router,
    Servable,
    ServableRegistry,
    wire,
)
from kubeflow_tpu_torch.web import TestClient

MIB = 2 ** 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paging path's device memory")
    return torch.device("cuda")


def _factory(cuda, built=None):
    """Model "m<i>" is tiny_resnet(seed=i) on the card, every bucket
    warmed; `built` collects a weak reference to each servable."""

    def factory(rspec):
        seed = int(rspec["model"][1:])
        servable = Servable.from_module(
            rspec["model"], tiny_resnet(num_classes=10, device=cuda, seed=seed),
            max_batch=4, warmup_example=np.zeros((32, 32, 3), np.float32),
            device=cuda)
        if built is not None:
            built.append(weakref.ref(servable))
        return servable

    return factory


def _allocated() -> int:
    """Bytes of live tensors on the card, once the device is done and
    cuBLAS's per-handle workspaces are released (nothing runs a product
    meanwhile; the next product allocates its workspace anew)."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _instance(seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((1, 32, 32, 3)).astype(np.float32)


@pytest.mark.cuda
def test_page_out_gives_the_weights_back(cuda):
    built = []
    registry = ServableRegistry(
        _factory(cuda, built), batching=BatchingConfig(max_batch=4, timeout_ms=1.0),
        paging=PagingConfig(max_resident=2))
    names = [f"m{i}" for i in range(8)]
    for name in names:
        registry.ensure({"model": name})
    before = _allocated()
    after_cycle = []
    gc.disable()
    try:
        for _ in range(2):
            for name in names:
                out = registry.predict(name, _instance(0))
                assert out.shape == (1, 10) and np.isfinite(out).all()
            after_cycle.append(_allocated())
        # Only the two resident models of the second cycle stay alive.
        alive = [ref for ref in built if ref() is not None]
        assert len(built) == 16 and len(alive) == 2
    finally:
        gc.enable()
        registry.close()
    closed = _allocated()
    assert abs(after_cycle[1] - after_cycle[0]) <= MIB, after_cycle
    assert abs(closed - before) <= MIB, (before, closed)
    assert registry.stats()["resident"] == 0


@pytest.mark.cuda
def test_front_door_fleet_answers_as_the_direct_forward(cuda):
    names = [f"m{i}" for i in range(4)]
    router = Router(retry_jitter_seed=0)
    for r in range(2):
        registry = ServableRegistry(
            _factory(cuda), batching=BatchingConfig(max_batch=4, timeout_ms=1.0),
            paging=PagingConfig(max_resident=2))
        for name in names:
            registry.ensure({"model": name})
        router.add(MultiModelReplica(f"fd-{r}", registry))
    client = TestClient(FrontDoorApp(router))
    try:
        for rnd in range(2):
            for i, name in enumerate(names):
                x = _instance(10 * rnd + i)
                resp = client.post(
                    f"/v1/models/{name}:predict", raw=wire.encode_tensor(x),
                    content_type=wire.TENSOR_CONTENT_TYPE,
                    headers={"Accept": wire.TENSOR_CONTENT_TYPE})
                assert resp.status == 200, resp.body
                model = tiny_resnet(num_classes=10, device=cuda, seed=i).eval()
                with torch.inference_mode():
                    want = model(torch.tensor(x, device=cuda)).cpu().numpy()
                np.testing.assert_allclose(wire.decode_tensor(resp.body), want,
                                           atol=1e-5, rtol=1e-5)
        assert client.post("/v1/models/ghost:predict",
                           {"instances": [[0.0]]}).status == 404
    finally:
        for name in router.replica_names():
            router.replica(name).close()
