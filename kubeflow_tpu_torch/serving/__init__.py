"""Model serving: the TF-Serving REST surface (`serving/server.py`) over
bucketed servables (`serving/servable.py`), with JSON or binary tensor
frames (`serving/wire.py`) on the same routes, and the batching
scheduler (`serving/batching.py`) that merges concurrent requests. The
model-server binary is ``python -m kubeflow_tpu_torch.serving``
(`serving/__main__.py`).

The multi-model front door: `FrontDoorApp` over a drain-aware `Router`
(`serving/router.py`, with priority and quota admission from
`serving/admission.py`) over replicas (`serving/replica.py`), each a
`ServableRegistry` (`serving/registry.py`) that pages models' weights
in and out of the device under an LRU limit. A ServingDeployment CR
(`api/serving.py`) reconciled by the serving controller
(`controllers/serving.py`) materializes that fleet in process
(`LocalReplicaRuntime`) or as worker processes in replica mode
(`ProcessReplicaRuntime`)."""

import importlib

# Name -> submodule, imported at first use: a process that needs only
# the wire codec (a load client) must not load torch with the servables.
_EXPORTS = {
    "AdmissionController": "admission", "QuotaSpec": "admission",
    "BatchingConfig": "batching", "BatchingQueue": "batching",
    "QueueClosed": "batching", "QueueFull": "batching",
    "ModelNotFound": "registry", "PagingConfig": "registry", "ServableRegistry": "registry",
    "HttpReplica": "replica", "LocalReplica": "replica", "LocalReplicaRuntime": "replica",
    "MultiModelReplica": "replica", "ProcessReplicaRuntime": "replica",
    "NoReadyReplicas": "router", "Overloaded": "router", "ReplicaGone": "router",
    "ReplicaOverloaded": "router", "Router": "router",
    "Servable": "servable",
    "FrontDoorApp": "server", "ModelRepository": "server", "ModelServerApp": "server",
}


def __getattr__(name: str):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionController",
    "BatchingConfig",
    "BatchingQueue",
    "FrontDoorApp",
    "HttpReplica",
    "LocalReplica",
    "LocalReplicaRuntime",
    "ModelNotFound",
    "ModelRepository",
    "ModelServerApp",
    "MultiModelReplica",
    "NoReadyReplicas",
    "Overloaded",
    "PagingConfig",
    "ProcessReplicaRuntime",
    "QueueClosed",
    "QueueFull",
    "QuotaSpec",
    "ReplicaGone",
    "ReplicaOverloaded",
    "Router",
    "Servable",
    "ServableRegistry",
]
