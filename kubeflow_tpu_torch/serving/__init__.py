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
in and out of the device under an LRU limit."""

from kubeflow_tpu_torch.serving.admission import (
    AdmissionController,
    QuotaSpec,
)
from kubeflow_tpu_torch.serving.batching import (
    BatchingConfig,
    BatchingQueue,
    QueueClosed,
    QueueFull,
)
from kubeflow_tpu_torch.serving.registry import (
    ModelNotFound,
    PagingConfig,
    ServableRegistry,
)
from kubeflow_tpu_torch.serving.replica import (
    HttpReplica,
    LocalReplica,
    LocalReplicaRuntime,
    MultiModelReplica,
)
from kubeflow_tpu_torch.serving.router import (
    NoReadyReplicas,
    Overloaded,
    ReplicaGone,
    ReplicaOverloaded,
    Router,
)
from kubeflow_tpu_torch.serving.servable import Servable
from kubeflow_tpu_torch.serving.server import (
    FrontDoorApp,
    ModelRepository,
    ModelServerApp,
)

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
    "QueueClosed",
    "QueueFull",
    "QuotaSpec",
    "ReplicaGone",
    "ReplicaOverloaded",
    "Router",
    "Servable",
    "ServableRegistry",
]
