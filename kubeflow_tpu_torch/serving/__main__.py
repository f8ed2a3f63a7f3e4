"""Model-server binary.

    python -m kubeflow_tpu_torch.serving --model NAME=CKPT_DIR ... [--port 8500]

Counterpart of `python -m kubeflow_tpu.serving`. Each ``--model``
restores the newest valid step of a checkpoint directory that the
training loop (`train.fit`) wrote into `resnet50()` and serves it at
``/v1/models/NAME``, its version the checkpoint's step. With no
``--model`` a demo model, ``tiny_resnet(num_classes=10)`` with weights
from seed 0, is served as "demo" so that the REST surface can be probed
alone. ``--batch-timeout-ms`` turns on the batching scheduler with that
flush window (``--max-batch`` instances at most); without it every
request runs on its own. The models run on CUDA.
`build_servable_from_rspec` builds the same models from a replica spec
dict, the factory a multiplexed fleet's registries page models in with.
``--device cpu`` runs the models on the CPU instead.

Replica mode (the ServingDeployment data plane):

    python -m kubeflow_tpu_torch.serving --apiserver URL --replica NAME \
        [--namespace NS] [--advertise HOST:PORT]

The worker joins the fleet the serving controller materialized: it reads
its own ``ServingReplica`` object through the apiserver facade
(`testing/apiserver_http.py`) for its config (model, checkpoint
directory, modelVersion), loads the servable, stamps ``status.ready``,
its version, its endpoint and its pid, and loads a new version whenever
the controller pushes one (`run_replica`: the watch is the push
channel). It exits when its object is deleted.
"""

from __future__ import annotations

import argparse
import logging
import os
import threading

import numpy as np
import torch

from kubeflow_tpu_torch.api import serving as serving_api
from kubeflow_tpu_torch.models.resnet import resnet50, tiny_resnet
from kubeflow_tpu_torch.serving.batching import BatchingConfig
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.serving.replica import LocalReplicaRuntime
from kubeflow_tpu_torch.serving.server import ModelRepository, ModelServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import Conflict, NotFound
from kubeflow_tpu_torch.utils import threads
from kubeflow_tpu_torch.web.wsgi import HttpError, serve

log = logging.getLogger(__name__)

REPLICA_KIND = serving_api.REPLICA_KIND


def parse_model_spec(spec: str) -> tuple[str, str]:
    """"NAME=CKPT_DIR" → (NAME, CKPT_DIR); ValueError when either is
    empty."""
    name, _, ckpt_dir = spec.partition("=")
    if not name or not ckpt_dir:
        raise ValueError(f"--model {spec!r} must be NAME=CKPT_DIR")
    return name, ckpt_dir


def build_servable_from_rspec(rspec: dict, *, device=None) -> Servable:
    """The replica spec's model: with ``checkpointDir`` set, the step
    ``modelVersion`` names restored into `resnet50()` while that
    directory holds it valid, else the directory's newest valid step
    (version = the step, every bucket up to ``maxBatch`` warmed at
    224x224x3); without one, the demo `tiny_resnet(num_classes=10)` with
    weights from seed 0 at the spec's ``modelVersion``. `device`
    defaults to CUDA."""
    name = rspec.get("model", "demo")
    max_batch = int(rspec.get("maxBatch", 64))
    ckpt_dir = rspec.get("checkpointDir") or ""
    if ckpt_dir:
        return Servable.from_checkpoint(
            name, resnet50(device=device), ckpt_dir,
            np.zeros((1, 224, 224, 3), np.float32), max_batch=max_batch,
            device=device, step=int(rspec.get("modelVersion") or 0) or None,
        )
    return Servable.from_module(
        name, tiny_resnet(num_classes=10, device=device),
        version=int(rspec.get("modelVersion") or 1), max_batch=max_batch,
        warmup_example=np.zeros((32, 32, 3), np.float32), device=device,
    )


def build_app(
    models: list[tuple[str, str]],
    *,
    max_batch: int = 64,
    batch_timeout_ms: float | None = None,
    device=None,
    demo: bool = True,
) -> ModelServerApp:
    """The binary's app: each (name, checkpoint directory) restored into
    `resnet50()` (every bucket warmed at 224x224x3), or, when `models` is
    empty and `demo` is set, the "demo" `tiny_resnet` (replica mode
    starts empty and loads what its object asks for); batching on when
    `batch_timeout_ms` is given. `device` defaults to CUDA."""
    rspecs = [{"model": name, "checkpointDir": ckpt_dir, "maxBatch": max_batch}
              for name, ckpt_dir in models]
    if not rspecs and demo:
        rspecs = [{"model": "demo", "maxBatch": max_batch}]
    servables = [build_servable_from_rspec(rspec, device=device) for rspec in rspecs]
    batching = (
        BatchingConfig(max_batch=max_batch, timeout_ms=batch_timeout_ms)
        if batch_timeout_ms is not None
        else None
    )
    return ModelServerApp(ModelRepository(servables), batching=batching)


def _live_version(repository, name: str) -> int | None:
    try:
        return repository.get(name).version
    except (HttpError, KeyError):  # not loaded yet
        return None


def _load_current(repository, rspec: dict, build_servable) -> int:
    """Load the rspec's model unless the live version is current
    (`serving_api.version_current`), as the model's one version (the
    JAX worker keeps every version it loaded resident); returns the
    live version."""
    name = rspec.get("model", "demo")
    want = int(rspec.get("modelVersion") or 0)
    live = _live_version(repository, name)
    if live is None or not serving_api.version_current(
        live, want, rspec.get("checkpointDir") or ""
    ):
        servable = build_servable(rspec)
        repository.replace(servable)
        live = servable.version
        log.info("serving %s version %s", name, live)
    return live


def sync_replica_once(
    api,
    name: str,
    namespace: str,
    repository,
    *,
    build_servable,
    endpoint: str = "",
    queue_stats=None,
) -> int | None:
    """One reconcile of the worker against its ServingReplica object:
    load the spec's model version unless the live one is current, then
    stamp status (ready, version, endpoint, pid, the queue signal).
    Returns the live version, or None when the object is gone (the
    deployment was deleted: the caller shuts down). Idempotent: all
    state lives in the object and the repository.

    A checkpoint-backed model past the spec's version is current when
    the directory no longer holds that version: the JAX worker wants
    equality and so restores the checkpoint at every heartbeat once
    training commits past the spec. A worker that has CUDA initialized
    also stamps its card memory (``cudaMemoryMiB``: allocated and
    reserved, whole MiB)."""
    try:
        replica = api.get(REPLICA_KIND, name, namespace)
    except NotFound:
        return None
    rspec = dict(replica.spec)
    model_rows: dict[str, int] = {}
    if rspec.get("models"):
        # Multiplexed fleet: one worker serves every listed model, all
        # resident (the worker owns its address space; LRU paging is the
        # in-process replica's concern).
        for mspec in rspec["models"]:
            mr = LocalReplicaRuntime.model_rspec(rspec, mspec)
            model_rows[mr["model"]] = _load_current(repository, mr, build_servable)
        live = max(model_rows.values())
    else:
        live = _load_current(repository, rspec, build_servable)
    status = {"ready": True, "version": live, "endpoint": endpoint, "pid": os.getpid()}
    if model_rows:
        status["models"] = model_rows
    if torch.cuda.is_initialized():
        status["cudaMemoryMiB"] = {
            "allocated": torch.cuda.memory_allocated() >> 20,
            "reserved": torch.cuda.memory_reserved() >> 20,
        }
    if queue_stats is not None:
        stats = queue_stats()
        status["queueDepth"] = int(stats.get("queue_depth") or 0)
        status["inflight"] = int(stats.get("inflight") or 0)
    try:
        fresh = api.get(REPLICA_KIND, name, namespace).thaw()
        new_status = {**fresh.status, **status}
        if new_status != fresh.status:
            fresh.status = new_status
            api.update_status(fresh)
    except (NotFound, Conflict):
        pass  # the next heartbeat retries against fresh state
    return live


def run_replica(
    api,
    name: str,
    namespace: str,
    repository,
    *,
    build_servable,
    endpoint: str = "",
    queue_stats=None,
    heartbeat_s: float = 1.0,
    stop: threading.Event | None = None,
) -> None:
    """The worker loop: sync once, then again on every watch event that
    changes this worker's spec or deletes its object (the config push:
    no polling for spec changes) and at a slow heartbeat that keeps the
    status fresh. A status write does not wake it: the worker's own
    writes would, and a reading that moves under load (queue depth,
    memory) would then be written back at once, without end. Returns
    when the object is gone or `stop` is set."""
    stop = stop or threading.Event()
    dirty = threading.Event()
    seen_spec: list = [None]

    def on_event(event: str, obj) -> None:
        if obj.metadata.name != name or obj.metadata.namespace != namespace:
            return
        if event == "DELETED" or obj.spec != seen_spec[0]:
            seen_spec[0] = obj.spec
            dirty.set()

    api.watch(on_event, REPLICA_KIND)
    while not stop.is_set():
        dirty.clear()
        if sync_replica_once(
            api, name, namespace, repository,
            build_servable=build_servable, endpoint=endpoint, queue_stats=queue_stats,
        ) is None:
            log.info("replica %s: object gone; shutting down", name)
            return
        dirty.wait(heartbeat_s)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-model-server")
    parser.add_argument("--host", default="0.0.0.0")
    # TF Serving's REST port.
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument(
        "--model", action="append", default=[], metavar="NAME=CKPT_DIR",
        help="serve a training checkpoint as /v1/models/NAME (repeatable)",
    )
    parser.add_argument("--max-batch", type=int, default=64)
    parser.add_argument(
        "--batch-timeout-ms", type=float, default=None, metavar="MS",
        help="enable cross-request dynamic batching with this flush window "
        "(the TF-Serving batch_timeout_micros analog); concurrent requests "
        "merge into one execution",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device the models run on (default: CUDA, which must exist)",
    )
    parser.add_argument(
        "--apiserver", default=None,
        help="apiserver facade URL; enables replica mode with --replica",
    )
    parser.add_argument(
        "--replica", default=None, metavar="NAME",
        help="ServingReplica object this worker embodies (replica mode)",
    )
    parser.add_argument("--namespace", default="default")
    parser.add_argument(
        "--advertise", default=None, metavar="HOST:PORT",
        help="endpoint to publish in ServingReplica status "
        "(default: 127.0.0.1:<bound port>)",
    )
    args = parser.parse_args(argv)
    if bool(args.apiserver) != bool(args.replica):
        parser.error("--apiserver and --replica go together")
    try:
        models = [parse_model_spec(spec) for spec in args.model]
    except ValueError as e:
        parser.error(str(e))

    app = build_app(models, max_batch=args.max_batch,
                    batch_timeout_ms=args.batch_timeout_ms, device=args.device,
                    demo=not args.replica)
    server, thread = serve(app, host=args.host, port=args.port)
    log.info("model server on :%d serving %s", server.server_port,
             app.repository.names())
    if args.replica:
        from kubeflow_tpu_torch.testing.apiserver_http import (
            HttpApiClient,
            endpoints_from_env,
        )

        client = HttpApiClient(endpoints_from_env(args.apiserver))
        try:
            run_replica(
                client, args.replica, args.namespace, app.repository,
                build_servable=lambda rspec: build_servable_from_rspec(
                    rspec, device=args.device),
                endpoint=args.advertise or f"127.0.0.1:{server.server_port}",
            )
        finally:
            server.shutdown()
            server.server_close()
            app.close_batchers()
            client.close()
            threads.join_thread(thread, timeout=10.0, what="model server thread")
        return
    # Foreground serve in bounded slices; ^C shuts the server down and
    # bounds the final join.
    if threads.run_until_interrupt(thread):
        server.shutdown()
        app.close_batchers()
        threads.join_thread(thread, timeout=10.0, what="model server thread")


if __name__ == "__main__":
    main()
