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

Not ported yet: replica mode (``--apiserver``/``--replica``), which
needs the serving controller and the apiserver client; the flags are
refused.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from kubeflow_tpu_torch.models.resnet import resnet50, tiny_resnet
from kubeflow_tpu_torch.serving.batching import BatchingConfig
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.serving.server import ModelRepository, ModelServerApp
from kubeflow_tpu_torch.utils import threads
from kubeflow_tpu_torch.web.wsgi import serve

log = logging.getLogger(__name__)


def parse_model_spec(spec: str) -> tuple[str, str]:
    """"NAME=CKPT_DIR" → (NAME, CKPT_DIR); ValueError when either is
    empty."""
    name, _, ckpt_dir = spec.partition("=")
    if not name or not ckpt_dir:
        raise ValueError(f"--model {spec!r} must be NAME=CKPT_DIR")
    return name, ckpt_dir


def build_app(
    models: list[tuple[str, str]],
    *,
    max_batch: int = 64,
    batch_timeout_ms: float | None = None,
    device=None,
) -> ModelServerApp:
    """The binary's app: each (name, checkpoint directory) restored into
    `resnet50()` (every bucket warmed at 224x224x3), or the "demo"
    `tiny_resnet` when `models` is empty; batching on when
    `batch_timeout_ms` is given. `device` defaults to CUDA."""
    servables = [
        Servable.from_checkpoint(
            name, resnet50(device=device), ckpt_dir,
            np.zeros((1, 224, 224, 3), np.float32), max_batch=max_batch,
            device=device,
        )
        for name, ckpt_dir in models
    ]
    if not servables:
        servables.append(Servable.from_module(
            "demo", tiny_resnet(num_classes=10, device=device), max_batch=max_batch,
            warmup_example=np.zeros((32, 32, 3), np.float32), device=device,
        ))
    batching = (
        BatchingConfig(max_batch=max_batch, timeout_ms=batch_timeout_ms)
        if batch_timeout_ms is not None
        else None
    )
    return ModelServerApp(ModelRepository(servables), batching=batching)


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
    parser.add_argument("--apiserver", default=None,
                        help="replica mode (not ported yet)")
    parser.add_argument("--replica", default=None, metavar="NAME",
                        help="replica mode (not ported yet)")
    args = parser.parse_args(argv)
    if args.apiserver or args.replica:
        parser.error(
            "replica mode (--apiserver/--replica) needs the serving "
            "controller and the apiserver client, which are not ported yet"
        )
    try:
        models = [parse_model_spec(spec) for spec in args.model]
    except ValueError as e:
        parser.error(str(e))

    app = build_app(models, max_batch=args.max_batch,
                    batch_timeout_ms=args.batch_timeout_ms)
    server, thread = serve(app, host=args.host, port=args.port)
    log.info("model server on :%d serving %s", server.server_port,
             app.repository.names())
    # Foreground serve in bounded slices; ^C shuts the server down and
    # bounds the final join.
    if threads.run_until_interrupt(thread):
        server.shutdown()
        app.close_batchers()
        threads.join_thread(thread, timeout=10.0, what="model server thread")


if __name__ == "__main__":
    main()
