"""The port's multi-model front door, by the JAX package's own tests.

Every test of tests/test_serving_front_door.py but the one that goes
through the serving controller (not ported), run against
`kubeflow_tpu_torch.serving.FrontDoorApp` over the real registry →
replica → router stack on the same stand-in servables: the path selects
the model, priority and tenant ride headers, and every router verdict
maps onto an honest status code (429 with a jittered fractional
Retry-After for sheds, 404 for an unknown model, 400 for client errors,
503 for a dead fleet).

Then parity: an 8-model `TinyMLP` fleet (flax weights, converted by
`models.convert.tinymlp_from_flax`) behind both packages' front doors,
JAX's over JAX `Servable`s on the CPU and the port's over
`Servable(device="cpu")`, answers one request sequence with the same
status codes, the same Retry-After headers and the same predictions
(f32, atol = rtol = 1e-5: XLA's and PyTorch's CPU matmuls sum in other
orders).
"""

import numpy as np
import pytest

from kubeflow_tpu_torch.serving import (
    AdmissionController,
    BatchingConfig,
    FrontDoorApp,
    MultiModelReplica,
    PagingConfig,
    QuotaSpec,
    Router,
    ServableRegistry,
)
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.server import PRIORITY_HEADER, TENANT_HEADER
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import TestClient


class Doubler:
    def __init__(self, name):
        self.name = name
        self.version = 1

    def predict(self, instances):
        return np.asarray(instances, dtype=np.float32) * 2.0


@pytest.fixture()
def stack():
    metrics = MetricsRegistry()
    admission = AdmissionController(
        quotas={"capped": QuotaSpec(rate=0.001, burst=1.0)},
        metrics=metrics,
    )
    router = Router(metrics, admission=admission, retry_jitter_seed=42)
    registries = []
    for i in range(2):
        registry = ServableRegistry(
            lambda rspec: Doubler(rspec["model"]),
            batching=BatchingConfig(max_batch=4, timeout_ms=2.0),
            paging=PagingConfig(max_resident=1),
            metrics=metrics,
        )
        for model in ("alpha", "beta"):
            registry.ensure({"model": model})
        registries.append(registry)
        router.add(MultiModelReplica(f"fd-{i}", registry))
    app = FrontDoorApp(router, metrics=metrics)
    yield app, TestClient(app), router
    for name in list(router.replica_names()):
        replica = router.replica(name)
        router.remove(name)
        replica.close()


def test_models_list_aggregates_catalog(stack):
    app, client, _ = stack
    resp = client.get("/v1/models")
    assert resp.status == 200
    assert resp.json() == {"models": ["alpha", "beta"]}


def test_predict_selects_model_from_path(stack):
    app, client, _ = stack
    for model in ("alpha", "beta"):
        resp = client.post(
            f"/v1/models/{model}:predict",
            {"instances": [[1.0, 2.0]]},
        )
        assert resp.status == 200, resp.body
        assert resp.json()["predictions"] == [[2.0, 4.0]]


def test_binary_predict_roundtrip(stack):
    app, client, _ = stack
    x = np.ones((2, 3), np.float32)
    resp = client.post(
        "/v1/models/alpha:predict",
        raw=wire.encode_tensor(x),
        content_type=wire.TENSOR_CONTENT_TYPE,
        headers={"Accept": wire.TENSOR_CONTENT_TYPE},
    )
    assert resp.status == 200, resp.body
    assert resp.content_type == wire.TENSOR_CONTENT_TYPE
    np.testing.assert_array_equal(wire.decode_tensor(resp.body), x * 2.0)


def test_model_status_reports_residency(stack):
    app, client, _ = stack
    client.post("/v1/models/alpha:predict", {"instances": [[1.0]]})
    resp = client.get("/v1/models/alpha")
    assert resp.status == 200
    body = resp.json()
    assert body["resident_replicas"] >= 1
    assert body["model_version_status"][0]["state"] == "AVAILABLE"
    assert client.get("/v1/models/ghost").status == 404


def test_unknown_model_predict_is_404(stack):
    app, client, _ = stack
    resp = client.post(
        "/v1/models/ghost:predict", {"instances": [[1.0]]}
    )
    assert resp.status == 404


def test_unknown_priority_is_400_not_shed(stack):
    app, client, router = stack
    shed_before = router.shed_total.value()
    resp = client.post(
        "/v1/models/alpha:predict",
        {"instances": [[1.0]]},
        headers={PRIORITY_HEADER: "vip"},
    )
    assert resp.status == 400
    assert router.shed_total.value() == shed_before  # client error != shed


def test_quota_shed_is_429_with_fractional_retry_after(stack):
    app, client, router = stack
    acked_before = router.acked_total.value()
    first = client.post(
        "/v1/models/alpha:predict",
        {"instances": [[1.0]]},
        headers={TENANT_HEADER: "capped"},
    )
    assert first.status == 200  # the burst token
    resp = client.post(
        "/v1/models/alpha:predict",
        {"instances": [[1.0]]},
        headers={TENANT_HEADER: "capped"},
    )
    assert resp.status == 429, resp.body
    retry_after = dict(resp.headers)["Retry-After"]
    assert "." in retry_after  # fractional seconds, docs/serving.md
    assert float(retry_after) > 0.0
    # One acked request total: the shed was refused pre-ack.
    assert router.acked_total.value() == acked_before + 1
    assert router.shed_total.value() >= 1


def test_bad_tensor_frame_is_400_with_invalid_counter(stack):
    app, client, _ = stack
    before = app.request_count.value(model="alpha", outcome="invalid")
    resp = client.post(
        "/v1/models/alpha:predict",
        raw=b"KFT1 definitely not a frame",
        content_type=wire.TENSOR_CONTENT_TYPE,
    )
    assert resp.status == 400
    after = app.request_count.value(model="alpha", outcome="invalid")
    assert after == before + 1


def test_empty_instances_is_400(stack):
    app, client, _ = stack
    resp = client.post("/v1/models/alpha:predict", {"instances": []})
    assert resp.status == 400


def test_dead_fleet_is_503(stack):
    app, client, router = stack
    for name in router.replica_names():
        router.replica(name).kill()
    resp = client.post(
        "/v1/models/alpha:predict", {"instances": [[1.0]]}
    )
    assert resp.status == 503


def test_metrics_endpoint_exposes_front_door_counters(stack):
    app, client, _ = stack
    client.post("/v1/models/alpha:predict", {"instances": [[1.0]]})
    text = client.get("/metrics").body.decode()
    assert "serving_front_door_requests_total" in text
    assert "serving_page_ins_total" in text


# -- parity: a TinyMLP fleet behind both front doors --------------------------

N_MODELS = 8
FEATURES = 12


@pytest.fixture(scope="module")
def mlp_params():
    """Flax params of eight TinyMLPs (seeds 0-7), as numpy arrays."""
    import jax

    from kubeflow_tpu.testing.tinymodels import TinyMLP

    module = TinyMLP(hidden=16, num_classes=10)
    return [
        jax.tree.map(np.asarray, module.init(
            jax.random.PRNGKey(seed), np.zeros((1, FEATURES), np.float32))["params"])
        for seed in range(N_MODELS)
    ]


def _mlp_front_door(pkg: str, mlp_params):
    """`pkg`'s ("jax" or "torch") front door over two multiplexed
    replicas of the eight models at ``max_resident=3``, with a tenant
    quota and a per-model quota, and the router's jitter seeded."""
    if pkg == "jax":
        import jax

        from kubeflow_tpu import serving
        from kubeflow_tpu.testing.tinymodels import TinyMLP
        from kubeflow_tpu.utils.metrics import MetricsRegistry as Metrics
        from kubeflow_tpu.web import TestClient as Client

        module, cpu = TinyMLP(hidden=16, num_classes=10), jax.devices("cpu")[0]

        def factory(rspec):
            i = int(rspec["model"].split("-")[1])
            return serving.Servable.from_module(
                rspec["model"], module, {"params": mlp_params[i]},
                max_batch=4, device=cpu)
    else:
        import torch

        from kubeflow_tpu_torch import serving
        from kubeflow_tpu_torch.models import convert
        from kubeflow_tpu_torch.testing.tinymodels import TinyMLP
        from kubeflow_tpu_torch.utils.metrics import MetricsRegistry as Metrics
        from kubeflow_tpu_torch.web import TestClient as Client

        def factory(rspec):
            i = int(rspec["model"].split("-")[1])
            module = TinyMLP(FEATURES, device="cpu", seed=100 + i)
            module.load_state_dict(convert.tinymlp_from_flax(mlp_params[i]))
            return serving.Servable.from_module(
                rspec["model"], module, max_batch=4, device="cpu")

        del torch
    metrics = Metrics()
    admission = serving.AdmissionController(
        quotas={"capped": serving.QuotaSpec(rate=0.001, burst=2.0),
                "model:mlp-7": serving.QuotaSpec(rate=0.001, burst=3.0)},
        metrics=metrics, clock=lambda: 0.0,  # no refill: hints are exact
    )
    router = serving.Router(metrics, admission=admission, retry_jitter_seed=5)
    for r in range(2):
        registry = serving.ServableRegistry(
            factory, batching=serving.BatchingConfig(max_batch=4, timeout_ms=1.0),
            paging=serving.PagingConfig(max_resident=3), metrics=metrics,
        )
        for i in range(N_MODELS):
            registry.ensure({"model": f"mlp-{i}"})
        router.add(serving.MultiModelReplica(f"fd-{r}", registry))
    return router, Client(serving.FrontDoorApp(router, metrics=metrics))


def _mlp_requests():
    """(model, body, frame?, headers) for every request of the parity
    run: each model in JSON and in binary frames, batches of 1-5 rows
    (5: one request over max_batch), the quotas exhausted, an unknown
    model and priority, an empty body, a bad frame, a ragged list."""
    rng = np.random.default_rng(0)
    out = []
    for rnd in range(3):
        for i in range(N_MODELS):
            x = rng.standard_normal((1 + (i + rnd) % 5, FEATURES)).astype(np.float32)
            out.append((f"mlp-{i}", x, (i + rnd) % 2 == 0, {}))
    x = rng.standard_normal((2, FEATURES)).astype(np.float32)
    out += [("mlp-1", x, False, {TENANT_HEADER: "capped"})] * 3
    out += [("mlp-7", x, True, {PRIORITY_HEADER: "critical"})] * 2
    out += [
        ("ghost", x, False, {}),
        ("mlp-2", x, True, {PRIORITY_HEADER: "vip"}),
        ("mlp-3", np.zeros((0, FEATURES), np.float32), False, {}),
        ("mlp-4", b"KFT1 not a frame", True, {}),
        ("mlp-5", [[1.0, 2.0], [3.0]], False, {}),
        ("mlp-6", x, False, {PRIORITY_HEADER: "batch"}),
    ]
    return out


def _mlp_drive(pkg: str, mlp_params):
    router, client = _mlp_front_door(pkg, mlp_params)
    answers = []
    try:
        for model, x, frame, headers in _mlp_requests():
            path = f"/v1/models/{model}:predict"
            if frame:
                raw = x if isinstance(x, bytes) else wire.encode_tensor(x)
                resp = client.post(
                    path, raw=raw, content_type=wire.TENSOR_CONTENT_TYPE,
                    headers={"Accept": wire.TENSOR_CONTENT_TYPE, **headers})
            else:
                body = {"instances": x.tolist() if isinstance(x, np.ndarray) else x}
                resp = client.post(path, body, headers=headers)
            pred = None
            if resp.status == 200:
                pred = (wire.decode_tensor(resp.body) if frame
                        else np.asarray(resp.json()["predictions"], np.float32))
            answers.append((resp.status, dict(resp.headers).get("Retry-After"), pred))
        stats = router.stats()["replicas"]
        return answers, {
            name: {m: row["page_ins"] for m, row in r["models"].items()}
            for name, r in stats.items()
        }
    finally:
        for name in list(router.replica_names()):
            replica = router.replica(name)
            router.remove(name)
            replica.close()


def test_mlp_fleet_answers_as_the_jax_front_door(mlp_params):
    jax_answers, jax_page_ins = _mlp_drive("jax", mlp_params)
    torch_answers, torch_page_ins = _mlp_drive("torch", mlp_params)
    assert [a[:2] for a in torch_answers] == [a[:2] for a in jax_answers]
    for (status, _, want), (_, _, got) in zip(jax_answers, torch_answers):
        if status == 200:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert torch_page_ins == jax_page_ins
    statuses = [a[0] for a in jax_answers]
    assert {200, 400, 404, 429} <= set(statuses)
    # Sequential requests all go to the first replica: eight models
    # through three slots, three rounds.
    assert sum(jax_page_ins["fd-0"].values()) > N_MODELS
