"""Runtimes that execute the control plane's objects: the local pod
runner (`runtime/local.py`), the kubelet of a one-host rig."""

from kubeflow_tpu_torch.runtime.local import LocalPodRunner

__all__ = ["LocalPodRunner"]
