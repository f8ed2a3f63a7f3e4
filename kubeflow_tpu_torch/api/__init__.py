"""The API object model the serving control plane speaks: K8s-style
resources (`api/objects.py`) and the ServingDeployment CRD
(`api/serving.py`)."""

from kubeflow_tpu_torch.api.objects import (
    GROUP,
    ObjectMeta,
    Resource,
    new_resource,
    owner_ref,
)

__all__ = ["GROUP", "ObjectMeta", "Resource", "new_resource", "owner_ref"]
