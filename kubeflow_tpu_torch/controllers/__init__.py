"""Controllers: the reconcile runtime (`controllers/runtime.py`, on the
compiled work queue), the serving controller (`controllers/serving.py`, a
ServingDeployment into a replica fleet), the TpuJob operator
(`controllers/tpujob.py`, a job into a gang of worker pods, placed by
the compiled gang scheduler, `native/scheduler.py`), the Study
controller (`controllers/study.py`, a search into trial TpuJobs), the
pipeline controllers (`controllers/workflow.py`, a DAG into step pods and
TpuJob slice steps; `controllers/cronworkflow.py`, Workflows spawned on a
schedule), the tenant controllers (`controllers/profile.py`, a user's
namespace; `controllers/notebook.py` and `controllers/tensorboard.py`,
a Notebook or a Tensorboard into its workload, Service and route),
ResourceQuota admission (`controllers/quota.py`), PodDefault admission
(`controllers/poddefault.py`) and its standalone HTTPS webhook server
(`controllers/webhook.py`), leader election over a Lease with write
fencing (`controllers/leader.py`) and the controller-manager binary
(``python -m kubeflow_tpu_torch.controllers``)."""

from kubeflow_tpu_torch.controllers.cronworkflow import CronWorkflowController
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.controllers.runtime import (
    Controller,
    ControllerManager,
    Result,
)
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.controllers.study import StudyController
from kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.controllers.workflow import WorkflowController

__all__ = ["Controller", "ControllerManager", "CronWorkflowController", "NotebookController",
           "ProfileController", "Result", "ServingDeploymentController", "StudyController",
           "TensorboardController", "TpuJobController", "WorkflowController"]
