"""The API object model the control planes speak: K8s-style resources
(`api/objects.py`), the ServingDeployment CRD (`api/serving.py`), the
TpuJob training-job CRD (`api/tpujob.py`), the Study
hyperparameter-search CRD (`api/study.py`), and the pipeline CRDs: the
Workflow DAG of steps (`api/workflow.py`) and the CronWorkflow that
spawns one on a schedule (`api/cron.py`)."""

from kubeflow_tpu_torch.api.cron import CronSchedule, CronWorkflowSpec
from kubeflow_tpu_torch.api.objects import (
    GROUP,
    ObjectMeta,
    Resource,
    new_resource,
    owner_ref,
)
from kubeflow_tpu_torch.api.tpujob import TpuJobSpec, make_tpujob
from kubeflow_tpu_torch.api.workflow import StepSpec, WorkflowSpec

__all__ = ["GROUP", "CronSchedule", "CronWorkflowSpec", "ObjectMeta", "Resource", "StepSpec",
           "TpuJobSpec", "WorkflowSpec", "make_tpujob", "new_resource", "owner_ref"]
