"""Runtimes that execute the control plane's objects: the local pod
runner (`runtime/local.py`), the kubelet of a one-host rig, and the
workload materializer (`runtime/workloads.py`), its StatefulSet and
Deployment controller."""

from kubeflow_tpu_torch.runtime.local import LocalPodRunner
from kubeflow_tpu_torch.runtime.workloads import WorkloadMaterializer

__all__ = ["LocalPodRunner", "WorkloadMaterializer"]
