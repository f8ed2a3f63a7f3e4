"""Model server: the TF-Serving REST surface over the port's servables.

Counterpart of `kubeflow_tpu/serving/server.py` (`ModelRepository`,
`ModelServerApp`). Clients POST ``/v1/models/<name>:predict`` with
``{"instances": [...]}`` and get ``{"predictions": [...]}`` back, or
send and receive binary tensor frames (`serving/wire.py`) on the same
route; ``GET /v1/models/<name>`` reports version state as TF Serving's
model-status API does.

With a `BatchingConfig` (``batching=``) every predict goes through a
`BatchingQueue` per (model, version), so concurrent requests merge into
one execution; a full queue answers 429 with a jittered Retry-After.

A device fault on well-formed input (out of memory, a CUDA error, a
refused kernel launch) is the server's error, 500; anything else that
``predict`` raises is a bad request, 400. Not ported yet (ROADMAP Queue
1): the front door with its router and registry.
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
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import App, HttpError, Request, Response, json_response

log = logging.getLogger(__name__)

# Faults of the device or runtime, not of the request.
_DEVICE_ERRORS = (torch.OutOfMemoryError, torch.AcceleratorError, KernelLaunchError)


def _format_retry_after(seconds: float) -> str:
    """Retry-After in fractional seconds (two decimals): rounding a
    jittered sub-second hint up to 1 would re-synchronise the herd that
    the jitter spreads."""
    return f"{max(0.01, seconds):.2f}"


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
        if wire.is_tensor_request(req.headers):
            instances = self._binary_instances(req, name)
        else:
            instances = req.json().get("instances")
            if not isinstance(instances, list) or not instances:
                self.request_count.inc(model=name, outcome="invalid")
                raise HttpError(
                    400, "body must have a non-empty 'instances' list"
                )
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
        if wire.wants_tensor_response(req.headers):
            return Response(
                body=wire.encode_tensor(predictions),
                content_type=wire.TENSOR_CONTENT_TYPE,
            )
        return json_response({"predictions": predictions.tolist()})

    def _binary_instances(self, req: Request, name: str):
        """Decode a tensor-framed request body (a read-only view over the
        request bytes; the servable copies it to the device)."""
        try:
            arr = wire.decode_tensor(req.body)
        except wire.WireFormatError as e:
            self.request_count.inc(model=name, outcome="invalid")
            raise HttpError(400, f"bad tensor frame: {e}") from None
        if arr.ndim < 1 or arr.shape[0] < 1:
            self.request_count.inc(model=name, outcome="invalid")
            raise HttpError(
                400, "tensor batch needs a non-empty leading dimension"
            )
        return arr

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
