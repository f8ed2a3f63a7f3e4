"""Cloud provisioning boundary: the PLATFORM phase, on GPU node pools.

Counterpart of `kubeflow_tpu/deploy/provisioner.py`. The reference's
PLATFORM apply drives GCP Deployment Manager to create the GKE cluster
and its GPU node pools (`kfctlServer.go:219`, gcp plugin). A pool here
is `num_hosts` GPU hosts, surfaced to Kubernetes as Nodes carrying
`nvidia.com/gpu` capacity and the accelerator, pool and topology labels.

The GPU translation (the table in `deploy/kfdef.py`): the capacity is
`GPU_RESOURCE` (`nvidia.com/gpu`, the name `api/tpujob.py` asks for)
where JAX's is `google.com/tpu`, and the accelerator label is GKE's
`cloud.google.com/gke-accelerator` with GKE's value
(`kfdef.gke_accelerator`: `nvidia-h100-80gb`) where JAX's is
`cloud.google.com/tpu-accelerator: v5e`. The platform, pool and topology
labels keep JAX's names.

A deployed Node has neither `spec.pool` nor `spec.chips`, as in JAX, so
the TpuJob operator places on it as pool ``default`` with 4 chips
(`controllers/tpujob.py`, as JAX's does; ROADMAP Queue 3, Facts).

`CloudProvider` is the seam (the reference injects a TokenSource-backed
client the same way, `kfctlServer.go:179-201`); `FakeCloud` implements it
against the in-process API server for tests and local runs, with
injectable flakiness, because idempotent retry on a cloud flake is the
behavior the reference's deploy loop most depends on
(`kfctlServer.go:290-294`).
"""

from __future__ import annotations

import threading
from typing import Protocol

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.deploy.kfdef import NodePool, PlatformSpec, gke_accelerator
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
TOPOLOGY_LABEL = "cloud.google.com/tpu-topology"
POOL_LABEL = "cloud.google.com/tpu-node-pool"
PLATFORM_LABEL = "kubeflow-tpu.org/platform"
GPU_RESOURCE = "nvidia.com/gpu"


class CloudError(Exception):
    """Transient cloud-API failure (the retried class)."""


class CloudProvider(Protocol):
    def ensure_cluster(self, spec: PlatformSpec) -> None: ...

    def ensure_node_pool(self, spec: PlatformSpec, pool: NodePool) -> None: ...

    def delete_node_pool(self, spec: PlatformSpec, pool_name: str) -> None: ...

    def list_node_pools(self, spec: PlatformSpec) -> list[str]: ...


class FakeCloud:
    """In-process provider: a node pool materializes as `num_hosts` Node
    objects with GPU capacity and the accelerator/topology labels."""

    def __init__(self, api: FakeApiServer, *, fail_next: int = 0):
        self.api = api
        self._lock = threading.Lock()
        self._pools: dict[tuple[str, str], NodePool] = {}
        self._clusters: set[str] = set()
        self.fail_next = fail_next  # injectable flakiness
        self.calls = 0

    def _maybe_fail(self) -> None:
        with self._lock:
            self.calls += 1
            if self.fail_next > 0:
                self.fail_next -= 1
                raise CloudError("injected transient cloud failure")

    def ensure_cluster(self, spec: PlatformSpec) -> None:
        """In-process clusters always exist; record the ask. (Flake
        injection targets the pool calls so existing fail_next counts in
        tests keep their meaning.)"""
        with self._lock:
            self._clusters.add(spec.name)

    def ensure_node_pool(self, spec: PlatformSpec, pool: NodePool) -> None:
        self._maybe_fail()
        with self._lock:
            self._pools[(spec.name, pool.name)] = pool
        gpus_per_host = max(1, pool.num_chips // pool.num_hosts)
        for host in range(pool.num_hosts):
            node = new_resource(
                "Node",
                f"{spec.name}-{pool.name}-{host}",
                "",
                labels={
                    PLATFORM_LABEL: spec.name,
                    POOL_LABEL: pool.name,
                    ACCELERATOR_LABEL: gke_accelerator(pool.accelerator),
                    TOPOLOGY_LABEL: pool.topology,
                    "cloud.google.com/gke-preemptible": str(
                        pool.preemptible
                    ).lower(),
                },
            )
            node.spec = {
                "capacity": {GPU_RESOURCE: gpus_per_host},
                "podCIDR": f"10.{host}.0.0/24",
            }
            # Create-or-update: a re-apply after a pool spec change must
            # refresh topology/capacity, not keep stale labels.
            self.api.apply(node)

    def delete_node_pool(self, spec: PlatformSpec, pool_name: str) -> None:
        self._maybe_fail()
        with self._lock:
            self._pools.pop((spec.name, pool_name), None)
        # Filter on the platform label, never a name prefix — platform
        # 'kf' must not collect platform 'kf-2's nodes.
        for node in self.api.list(
            "Node",
            "",
            label_selector={PLATFORM_LABEL: spec.name, POOL_LABEL: pool_name},
        ):
            self.api.delete("Node", node.metadata.name, "")

    def list_node_pools(self, spec: PlatformSpec) -> list[str]:
        with self._lock:
            return sorted(
                name for (dep, name) in self._pools if dep == spec.name
            )
