"""The API object model the control planes speak: K8s-style resources
(`api/objects.py`), the ServingDeployment CRD (`api/serving.py`), the
TpuJob training-job CRD (`api/tpujob.py`) and the Study
hyperparameter-search CRD (`api/study.py`)."""

from kubeflow_tpu_torch.api.objects import (
    GROUP,
    ObjectMeta,
    Resource,
    new_resource,
    owner_ref,
)
from kubeflow_tpu_torch.api.tpujob import TpuJobSpec, make_tpujob

__all__ = ["GROUP", "ObjectMeta", "Resource", "TpuJobSpec", "make_tpujob", "new_resource",
           "owner_ref"]
