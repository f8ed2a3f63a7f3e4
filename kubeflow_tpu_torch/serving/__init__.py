"""Model serving: the TF-Serving REST surface (`serving/server.py`) over
bucketed servables (`serving/servable.py`), with JSON or binary tensor
frames (`serving/wire.py`) on the same routes, and the batching
scheduler (`serving/batching.py`) that merges concurrent requests. The
model-server binary is ``python -m kubeflow_tpu_torch.serving``
(`serving/__main__.py`)."""

from kubeflow_tpu_torch.serving.batching import (
    BatchingConfig,
    BatchingQueue,
    QueueClosed,
    QueueFull,
)
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.serving.server import ModelRepository, ModelServerApp

__all__ = [
    "BatchingConfig",
    "BatchingQueue",
    "ModelRepository",
    "ModelServerApp",
    "QueueClosed",
    "QueueFull",
    "Servable",
]
