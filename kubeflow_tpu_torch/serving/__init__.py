"""Model serving: the TF-Serving REST surface (`serving/server.py`) over
bucketed servables (`serving/servable.py`), with JSON or binary tensor
frames (`serving/wire.py`) on the same routes."""

from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.serving.server import ModelRepository, ModelServerApp

__all__ = ["ModelRepository", "ModelServerApp", "Servable"]
