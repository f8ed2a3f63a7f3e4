"""Deployment tooling — the kfctl / bootstrap analog, on GPU node pools.

Counterpart of `kubeflow_tpu/deploy/`, whole, its imports pointed at the
port. The reference's L0 is "kfctl-as-a-service": a KfDef CR describing
the whole platform, driven through a two-phase apply — `Apply(PLATFORM)`
creates cloud infrastructure, `Apply(K8S)` kustomize-applies every
component manifest (`bootstrap/cmd/bootstrap/app/kfctlServer.go:105-294`).

- `PlatformSpec` (kfdef.py) — the KfDef: its platform block describes
  GPU node pools (an accelerator such as `h100` and a GPU count);
- `CloudProvider` / `FakeCloud` (provisioner.py) — the PLATFORM phase
  boundary (Deployment Manager in the reference); `GkeCloud` (gke.py)
  builds GKE's container-v1 payloads and sends them through a
  `Transport` (`RecordingTransport` for dry runs, `credentials.py`'s
  `AuthTransport` for a real cloud);
- component bundles (bundles.py) and kustomize-style overlays
  (overlays.py);
- `apply_platform` (apply.py) — the two-phase driver with retried K8S
  apply and KfAvailable/KfDegraded conditions;
- `DeployServer` (server.py) — the click-to-deploy HTTP service with the
  router/worker split (threads, or one worker process per deployment,
  worker.py) and gc; ``python -m kubeflow_tpu_torch.deploy`` (the
  kfctl CLI: apply, delete, generate, serve).

The GPU translation, TPU capacity to GPU capacity, is one table in
`deploy/kfdef.py`. None of these modules imports torch.
"""

from kubeflow_tpu_torch.deploy.apply import ApplyResult, apply_platform, delete_platform
from kubeflow_tpu_torch.deploy.bundles import BUNDLES, bundle_resources
from kubeflow_tpu_torch.deploy.kfdef import NodePool, PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import CloudProvider, FakeCloud

__all__ = [
    "BUNDLES",
    "ApplyResult",
    "CloudProvider",
    "FakeCloud",
    "NodePool",
    "PlatformSpec",
    "apply_platform",
    "bundle_resources",
    "delete_platform",
]
