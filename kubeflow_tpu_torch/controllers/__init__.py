"""Controllers: the reconcile runtime (`controllers/runtime.py`) and the
serving controller (`controllers/serving.py`), which reconciles a
ServingDeployment into a replica fleet."""

from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    ControllerManager,
    Result,
)
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController

__all__ = ["Controller", "ControllerManager", "Result", "ServingDeploymentController"]
