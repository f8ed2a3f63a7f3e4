"""Model server: the TF-Serving REST surface over the port's servables.

Counterpart of `kubeflow_tpu/serving/server.py` (`ModelRepository`,
`ModelServerApp`, `FrontDoorApp`). Clients POST
``/v1/models/<name>:predict`` with ``{"instances": [...]}`` and get
``{"predictions": [...]}`` back, or send and receive binary tensor
frames (`serving/wire.py`) on the same route; ``GET /v1/models/<name>``
reports version state as TF Serving's model-status API does.

With a `BatchingConfig` (``batching=``) every predict goes through a
`BatchingQueue` per (model, version), so concurrent requests merge into
one execution; a full queue answers 429 with a jittered Retry-After.

A device fault on well-formed input (out of memory, a CUDA error, a
refused kernel launch) is the server's error, 500; anything else that
``predict`` raises is a bad request, 400.

`FrontDoorApp` is the same surface over a `Router` for a whole,
possibly multiplexed, fleet (`serving/replica.py`,
`serving/registry.py`): the path selects the model on every replica,
and priority class and tenant ride request headers.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Iterable

import torch

from kubeflow_tpu_torch.ops._kernels import KernelLaunchError
from kubeflow_tpu_torch.serving import wire
from kubeflow_tpu_torch.serving.batching import BatchingQueue, QueueClosed, QueueFull
from kubeflow_tpu_torch.serving.registry import ModelNotFound
from kubeflow_tpu_torch.serving.router import (
    NoReadyReplicas,
    Overloaded,
    ReplicaGone,
    Router,
)
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import App, HttpError, Request, Response, json_response

log = logging.getLogger(__name__)

# Faults of the device or runtime, not of the request.
_DEVICE_ERRORS = (torch.OutOfMemoryError, torch.AcceleratorError, KernelLaunchError)

# Priority and tenant ride request headers, so the admission decision
# needs no body parse.
PRIORITY_HEADER = "x-kftpu-priority"
TENANT_HEADER = "x-kftpu-tenant"


def _format_retry_after(seconds: float) -> str:
    """Retry-After in fractional seconds (two decimals): rounding a
    jittered sub-second hint up to 1 would re-synchronise the herd that
    the jitter spreads."""
    return f"{max(0.01, seconds):.2f}"


def _request_instances(req: Request, name: str, request_count):
    """The instances of a :predict request: a tensor frame (a read-only
    view over the request bytes; the servable copies it to the device)
    or a JSON ``instances`` list. A malformed body counts as invalid in
    `request_count` and answers 400."""
    if wire.is_tensor_request(req.headers):
        try:
            instances = wire.decode_tensor(req.body)
        except wire.WireFormatError as e:
            request_count.inc(model=name, outcome="invalid")
            raise HttpError(400, f"bad tensor frame: {e}") from None
        if instances.ndim < 1 or instances.shape[0] < 1:
            request_count.inc(model=name, outcome="invalid")
            raise HttpError(
                400, "tensor batch needs a non-empty leading dimension"
            )
        return instances
    instances = req.json().get("instances")
    if not isinstance(instances, list) or not instances:
        request_count.inc(model=name, outcome="invalid")
        raise HttpError(400, "body must have a non-empty 'instances' list")
    return instances


def _predictions_response(req: Request, predictions) -> Response:
    """The predictions as a tensor frame when the request asks for one,
    else TF Serving's JSON envelope."""
    if wire.wants_tensor_response(req.headers):
        return Response(
            body=wire.encode_tensor(predictions),
            content_type=wire.TENSOR_CONTENT_TYPE,
        )
    return json_response({"predictions": predictions.tolist()})


class ModelRepository:
    """Named servables, several live versions per model.

    TF-Serving semantics: loading a new version makes it the default
    (latest) for unversioned requests while older versions stay
    addressable at ``/versions/<v>`` until unloaded."""

    def __init__(self, servables: Iterable[Servable] = ()):
        # The WSGI server is threaded and load()/unload() are the live
        # rollout path: a reader must never see a half-applied change.
        self._lock = threading.Lock()
        self._models: dict[str, dict[int, Servable]] = {}
        for s in servables:
            self.load(s)

    def load(self, servable: Servable) -> None:
        with self._lock:
            versions = self._models.setdefault(servable.name, {})
            if versions:
                log.info(
                    "model %s: +version %d (latest was %d)",
                    servable.name, servable.version, max(versions),
                )
            versions[servable.version] = servable

    def unload(self, name: str, version: int) -> None:
        with self._lock:
            versions = self._models.get(name) or {}
            if version not in versions:
                raise HttpError(
                    404, f"model {name!r} version {version} not found"
                )
            del versions[version]
            if not versions:
                del self._models[name]

    def get(self, name: str, version: int | None = None) -> Servable:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise HttpError(404, f"model {name!r} not found")
            if version is None:
                return versions[max(versions)]
            try:
                return versions[version]
            except KeyError:
                raise HttpError(
                    404, f"model {name!r} version {version} not found"
                ) from None

    def versions(self, name: str) -> list[Servable]:
        with self._lock:
            versions = self._models.get(name)
            if not versions:
                raise HttpError(404, f"model {name!r} not found")
            return [versions[v] for v in sorted(versions)]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)


class ModelServerApp(App):
    def __init__(
        self,
        repository: ModelRepository,
        *,
        metrics: MetricsRegistry | None = None,
        batching=None,
    ):
        """`batching`: a `BatchingConfig` turns on the batching
        scheduler: concurrent requests merge into one execution per
        flush (`serving/batching.py`)."""
        super().__init__("model-server")
        self.repository = repository
        self._batching = batching
        self._batchers: dict = {}
        self._batcher_lock = threading.Lock()
        # ±50% Retry-After spread, seeded: a fixed hint brings every shed
        # client back in one wave.
        self._retry_rng = random.Random(0)
        metrics = metrics or MetricsRegistry()
        self.request_count = metrics.counter(
            "serving_requests_total", "predict requests", ("model", "outcome")
        )
        self._metrics_registry = metrics
        # The :predict verb rides the final path segment (TF Serving
        # convention), so one route captures `name` or `name:verb`.
        self.add_route("/v1/models/<name>", self.model_get)
        self.add_route("/v1/models/<name>", self.model_post, ("POST",))
        self.add_route(
            "/v1/models/<name>/versions/<version>", self.model_get
        )
        self.add_route(
            "/v1/models/<name>/versions/<version>", self.model_post, ("POST",)
        )
        self.add_route("/v1/models", self.models_list)
        self.add_route("/metrics", self.metrics_text)

    @staticmethod
    def _split_verb(raw: str) -> tuple[str, str | None]:
        if ":" in raw:
            name, verb = raw.split(":", 1)
            return name, verb
        return raw, None

    def models_list(self, req: Request) -> Response:
        return json_response({"models": self.repository.names()})

    @staticmethod
    def _version_param(req: Request) -> tuple[int | None, str | None]:
        """(version, verb) from a /versions/<v> segment, when present."""
        raw = req.path_params.get("version")
        if raw is None:
            return None, None
        raw, verb = ModelServerApp._split_verb(raw)
        try:
            return int(raw), verb
        except ValueError:
            raise HttpError(400, f"version must be an integer, got {raw!r}")

    def model_get(self, req: Request) -> Response:
        name, verb = self._split_verb(req.path_params["name"])
        version, vverb = self._version_param(req)
        if verb is not None or vverb is not None:
            raise HttpError(405, "verbs require POST")
        if version is not None:
            statuses = [self.repository.get(name, version)]
        else:
            statuses = self.repository.versions(name)
        return json_response(
            {
                "model_version_status": [
                    {
                        "version": str(m.version),
                        "state": "AVAILABLE",
                        "status": {"error_code": "OK", "error_message": ""},
                    }
                    for m in statuses
                ]
            }
        )

    def model_post(self, req: Request) -> Response:
        name, verb = self._split_verb(req.path_params["name"])
        version, vverb = self._version_param(req)
        if version is not None:
            if verb is not None:
                raise HttpError(
                    400, "on versioned routes the :verb goes after the "
                    "version, e.g. /versions/1:predict",
                )
            verb = vverb
        if verb != "predict":
            raise HttpError(400, f"unsupported verb {verb!r}")
        model = self.repository.get(name, version)
        instances = _request_instances(req, name, self.request_count)
        try:
            try:
                predictions = self._predictor(model)(instances)
            except QueueClosed:
                # Raced a version reload: the stale queue closed between
                # lookup and predict. One retry reaches the fresh queue.
                predictions = self._predictor(model)(instances)
        except HttpError:
            raise
        except QueueFull as e:
            self.request_count.inc(model=name, outcome="overload")
            raise HttpError(
                429, str(e), headers=[("Retry-After", self._retry_after())]
            ) from None
        except _DEVICE_ERRORS:
            # The App's catch-all turns this into a 500.
            self.request_count.inc(model=name, outcome="error")
            raise
        except Exception as e:
            # Ragged lists, wrong rank or dtype: the request is at fault.
            self.request_count.inc(model=name, outcome="invalid")
            log.info("predict on %s rejected: %s", name, e)
            raise HttpError(400, f"bad instances: {e}") from None
        self.request_count.inc(model=name, outcome="ok")
        return _predictions_response(req, predictions)

    def _retry_after(self) -> str:
        """One flush window, floored at 1 s (a full queue clears at flush
        cadence), jittered ±50% from the seeded generator."""
        timeout_ms = getattr(self._batching, "timeout_ms", 0.0) or 0.0
        base = float(max(1, -(-int(timeout_ms) // 1000)))
        return _format_retry_after(base * (0.5 + self._retry_rng.random()))

    def _predictor(self, model):
        """model.predict, or its batching queue when batching is on.

        The repository decides which servable is current for (name,
        version): a request racing a reload may hold the old object, and
        deciding on it would let two generations close each other's
        queues in turn. The stale request is served by the current
        generation's queue. Queues of unloaded versions are pruned here
        and drained off the request path."""
        if self._batching is None:
            return model.predict
        try:
            current = self.repository.get(model.name, model.version)
        except HttpError:
            # Unloaded between the route lookup and here: serve the
            # caller's object directly, unbatched.
            return model.predict
        key = (model.name, model.version)
        stale = []
        with self._batcher_lock:
            queue = self._batchers.get(key)
            if queue is None or queue.servable is not current:
                if queue is not None:
                    stale.append(queue)
                queue = self._batchers[key] = BatchingQueue(
                    current, self._batching, metrics=self._metrics_registry
                )
            for other_key in list(self._batchers):
                try:
                    live = self.repository.get(*other_key)
                except HttpError:
                    live = None
                if live is not self._batchers[other_key].servable:
                    if other_key != key:
                        stale.append(self._batchers.pop(other_key))
        for old in stale:
            # close() joins the scheduler through its remaining device
            # work: not on the request path.
            threading.Thread(
                target=old.close, name="batcher-drain", daemon=True
            ).start()
        return queue.predict

    def close_batchers(self) -> None:
        """Drain and stop every batching queue (server shutdown)."""
        with self._batcher_lock:
            queues = list(self._batchers.values())
            self._batchers.clear()
        for queue in queues:
            queue.close()

    def metrics_text(self, req: Request) -> Response:
        return Response(
            body=self._metrics_registry.expose_text().encode(),
            content_type="text/plain; version=0.0.4",
        )


class FrontDoorApp(App):
    """The multi-model front door: one HTTP surface over the drain-aware
    `Router` for a whole (possibly multiplexed) fleet.

    Same routes and negotiation as `ModelServerApp` — ``/v1/models/<m>``
    stops being decorative: the path segment selects the servable on
    every replica, priority class and tenant ride the
    ``X-KFTPU-Priority`` / ``X-KFTPU-Tenant`` headers, and the router's
    verdicts map onto honest status codes:

    - `Overloaded` (capacity, priority headroom, or tenant quota) →
      429 with the router's already-jittered ``retry_after`` as a
      fractional-seconds Retry-After;
    - `NoReadyReplicas` / a dead fleet mid-request → 503;
    - `ModelNotFound` → 404 (every replica carries the same catalog);
    - an unknown priority class → 400 (client error, not a shed).
    """

    def __init__(
        self,
        router: Router,
        *,
        metrics: MetricsRegistry | None = None,
    ):
        super().__init__("serving-front-door")
        self.router = router
        metrics = metrics or MetricsRegistry()
        self._metrics_registry = metrics
        self.request_count = metrics.counter(
            "serving_front_door_requests_total",
            "front-door predict requests",
            ("model", "outcome"),
        )
        self.add_route("/v1/models/<name>", self.model_get)
        self.add_route("/v1/models/<name>", self.model_post, ("POST",))
        self.add_route("/v1/models", self.models_list)
        self.add_route("/metrics", self.metrics_text)

    # -- catalog views (aggregated across the fleet) -----------------------

    def _catalog(self) -> dict:
        """model → per-replica state rows, from the router's aggregated
        stats (MultiModelReplica exposes its registry snapshot there)."""
        catalog: dict[str, dict[str, dict]] = {}
        for rname, row in self.router.stats()["replicas"].items():
            for model, mrow in (row.get("models") or {}).items():
                catalog.setdefault(model, {})[rname] = mrow
        return catalog

    def models_list(self, req: Request) -> Response:
        return json_response({"models": sorted(self._catalog())})

    def model_get(self, req: Request) -> Response:
        name, verb = ModelServerApp._split_verb(req.path_params["name"])
        if verb is not None:
            raise HttpError(405, "verbs require POST")
        rows = self._catalog().get(name)
        if rows is None:
            raise HttpError(404, f"model {name!r} not found")
        resident = sum(
            1 for r in rows.values() if r.get("state") == "resident"
        )
        return json_response(
            {
                "model_version_status": [
                    {
                        "version": str(
                            max(r.get("version", 0) for r in rows.values())
                        ),
                        "state": "AVAILABLE",
                        "status": {"error_code": "OK", "error_message": ""},
                    }
                ],
                "replicas": {
                    rname: {
                        "state": r.get("state", "resident"),
                        "version": r.get("version", 0),
                    }
                    for rname, r in rows.items()
                },
                "resident_replicas": resident,
            }
        )

    # -- predict -----------------------------------------------------------

    def model_post(self, req: Request) -> Response:
        name, verb = ModelServerApp._split_verb(req.path_params["name"])
        if verb != "predict":
            raise HttpError(400, f"unsupported verb {verb!r}")
        instances = _request_instances(req, name, self.request_count)
        # No header → None → the router applies the model's
        # catalog-declared default class before falling back to
        # "standard".
        priority = req.headers.get(PRIORITY_HEADER) or None
        tenant = req.headers.get(TENANT_HEADER) or None
        try:
            predictions = self.router.predict(
                instances, model=name, priority=priority, tenant=tenant
            )
        except Overloaded as e:
            # Honest shed: never acked by the router, surfaced as 429
            # with the (already jittered) backoff hint.
            self.request_count.inc(model=name, outcome="overload")
            raise HttpError(
                429,
                str(e),
                headers=[
                    ("Retry-After", _format_retry_after(e.retry_after))
                ],
            ) from None
        except (NoReadyReplicas, ReplicaGone) as e:
            # No fleet left (or it died out from under an acked request
            # after the retry budget) — unavailable, retryable.
            self.request_count.inc(model=name, outcome="unavailable")
            raise HttpError(503, str(e)) from None
        except ModelNotFound:
            self.request_count.inc(model=name, outcome="invalid")
            raise HttpError(404, f"model {name!r} not found") from None
        except ValueError as e:
            # Unknown priority class, ragged instances — client errors.
            self.request_count.inc(model=name, outcome="invalid")
            raise HttpError(400, str(e)) from None
        self.request_count.inc(model=name, outcome="ok")
        return _predictions_response(req, predictions)

    metrics_text = ModelServerApp.metrics_text
