"""Controllers: the reconcile runtime (`controllers/runtime.py`), the
serving controller (`controllers/serving.py`, a ServingDeployment into a
replica fleet), the TpuJob operator (`controllers/tpujob.py`, a job into
a gang of worker pods, placed by `controllers/gang.py`), the Study
controller (`controllers/study.py`, a search into trial TpuJobs),
ResourceQuota admission (`controllers/quota.py`), leader election over a
Lease with write fencing (`controllers/leader.py`) and the
controller-manager binary (``python -m kubeflow_tpu_torch.controllers``)."""

from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    ControllerManager,
    Result,
)
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.controllers.study import StudyController
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController

__all__ = ["Controller", "ControllerManager", "Result", "ServingDeploymentController",
           "StudyController", "TpuJobController"]
