"""GKE provider: node-pool and cluster API payloads for GPU pools,
transport-separated.

Counterpart of `kubeflow_tpu/deploy/gke.py`, whole, with the GPU
translation (the table in `deploy/kfdef.py`). The reference's PLATFORM
phase builds actual GCP requests (Deployment Manager / GKE / IAM,
`bootstrap/cmd/bootstrap/app/kfctlServer.go:219-294`, `gcpUtils.go`) and
its tests exercise request *construction* without a cloud
(`gcpUtils_test.go`, `tokenSource_test.go`). Same split here: `GkeCloud`
implements the `CloudProvider` seam by building the container-API v1
payloads for **GPU node pools** and handing them to a `Transport`. Tests
and ``--dry-run`` use `RecordingTransport`, which records every request
and answers from a canned map, so nothing goes over the network; a real
deployment plugs in a token-bearing HTTP transport
(`credentials.AuthTransport`). `apps/cloud_metrics.py` sends its
requests through the same `Request`/`Transport` seam. FakeCloud remains
the provider that also materializes Node objects for the platform in a
box.

What the GPU payloads must get right:

- the machine type encodes the GPU model AND the GPUs per host
  (`a3-highgpu-1g` = one H100, ... `a3-highgpu-8g` = eight); a pool's
  `initialNodeCount` is its host count, `topology_chips / GPUS_PER_HOST`,
  not a free choice;
- each pool's `config.accelerators` names GKE's accelerator type
  (`nvidia-h100-80gb`) and its count per host, where JAX's TPU machine
  types carry the chips themselves;
- a pool of more than one host is placed `COMPACT` (close together on
  the network), with no `tpuTopology`: a GPU pool is not one ICI domain;
- preemptible pools are `spot` capacity.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Protocol

from kubeflow_tpu_torch.deploy.kfdef import (
    DEFAULT_GPUS_PER_HOST,
    GPUS_PER_HOST,
    NodePool,
    PlatformSpec,
    gke_accelerator,
    topology_chips,
)
from kubeflow_tpu_torch.deploy.provisioner import (
    ACCELERATOR_LABEL,
    CloudError,
    PLATFORM_LABEL,
    POOL_LABEL,
    TOPOLOGY_LABEL,
)

API_BASE = "https://container.googleapis.com/v1"

# GKE machine types per GPU model at its GPUs per host.
MACHINE_TYPES = {
    ("h100", 1): "a3-highgpu-1g",
    ("h100", 2): "a3-highgpu-2g",
    ("h100", 4): "a3-highgpu-4g",
    ("h100", 8): "a3-highgpu-8g",
}


def machine_type(accelerator: str, chips_per_host: int) -> str:
    try:
        return MACHINE_TYPES[(accelerator, chips_per_host)]
    except KeyError:
        raise CloudError(
            f"no GKE machine type for {accelerator} at "
            f"{chips_per_host} GPUs/host"
        )


@dataclasses.dataclass(frozen=True)
class Request:
    """One cloud API call, fully constructed but not sent."""

    method: str
    url: str
    body: dict | None = None

    def to_json(self) -> str:
        return json.dumps(
            {"method": self.method, "url": self.url, "body": self.body},
            indent=2,
        )


def _location(spec: PlatformSpec, cluster: str) -> str:
    return (
        f"projects/{spec.project}/locations/{spec.zone}"
        f"/clusters/{cluster}"
    )


def cluster_create_request(
    spec: PlatformSpec, cluster: str | None = None
) -> Request:
    """The cluster itself (the reference creates it through Deployment
    Manager, `kfctlServer.go:268`; the direct v1 API is the modern path).
    GPU pools are attached separately — the default pool is CPU-only for
    the control-plane components."""
    name = cluster or spec.name
    return Request(
        "POST",
        f"{API_BASE}/projects/{spec.project}/locations/{spec.zone}/clusters",
        {
            "cluster": {
                "name": name,
                "initialNodeCount": 2,
                "nodeConfig": {
                    "machineType": "e2-standard-8",
                    "oauthScopes": [
                        "https://www.googleapis.com/auth/cloud-platform"
                    ],
                },
                "releaseChannel": {"channel": "REGULAR"},
                "workloadIdentityConfig": {
                    "workloadPool": f"{spec.project}.svc.id.goog"
                },
                "resourceLabels": {PLATFORM_LABEL.replace("/", "_"): spec.name},
            }
        },
    )


def cluster_get_request(spec: PlatformSpec, cluster: str | None = None) -> Request:
    return Request("GET", f"{API_BASE}/{_location(spec, cluster or spec.name)}")


def node_pool_create_request(
    spec: PlatformSpec, pool: NodePool, cluster: str | None = None
) -> Request:
    """A GPU node pool (`nvidia.com/gpu` capacity, as the reference asks,
    `tf-cnn/create_job_specs.py:168`): the host count and GPUs per host
    follow JAX's formulas with `GPUS_PER_HOST` for the chips per host."""
    chips = topology_chips(pool.topology)
    per_host = GPUS_PER_HOST.get(pool.accelerator, DEFAULT_GPUS_PER_HOST)
    num_hosts = max(1, chips // per_host)
    gpus_per_host = min(chips, per_host) if num_hosts == 1 else per_host
    body = {
        "nodePool": {
            "name": pool.name,
            "initialNodeCount": num_hosts,
            "config": {
                "machineType": machine_type(pool.accelerator, gpus_per_host),
                "accelerators": [
                    {
                        "acceleratorType": gke_accelerator(pool.accelerator),
                        "acceleratorCount": gpus_per_host,
                    }
                ],
                "spot": pool.preemptible,
                "labels": {
                    PLATFORM_LABEL: spec.name,
                    POOL_LABEL: pool.name,
                    ACCELERATOR_LABEL: gke_accelerator(pool.accelerator),
                    TOPOLOGY_LABEL: pool.topology,
                },
                "oauthScopes": [
                    "https://www.googleapis.com/auth/cloud-platform"
                ],
            },
            "management": {"autoRepair": True, "autoUpgrade": False},
        }
    }
    if num_hosts > 1:
        # Several hosts: placed close together on the network.
        body["nodePool"]["placementPolicy"] = {"type": "COMPACT"}
    return Request(
        "POST",
        f"{API_BASE}/{_location(spec, cluster or spec.name)}/nodePools",
        body,
    )


def node_pool_delete_request(
    spec: PlatformSpec, pool_name: str, cluster: str | None = None
) -> Request:
    return Request(
        "DELETE",
        f"{API_BASE}/{_location(spec, cluster or spec.name)}"
        f"/nodePools/{pool_name}",
    )


def node_pool_list_request(
    spec: PlatformSpec, cluster: str | None = None
) -> Request:
    return Request(
        "GET",
        f"{API_BASE}/{_location(spec, cluster or spec.name)}/nodePools",
    )


class Transport(Protocol):
    """The network edge: send one constructed request, return the parsed
    response body. Real deployments back this with an authenticated HTTP
    client (the reference injects a TokenSource the same way,
    `kfctlServer.go:179-201`)."""

    def send(self, request: Request) -> dict: ...


class RecordingTransport:
    """Dry-run / golden-test transport: records every request; responses
    come from a canned map (url-suffix matched) or default to {}."""

    def __init__(self, responses: dict[str, dict] | None = None):
        self.requests: list[Request] = []
        self.responses = dict(responses or {})

    def send(self, request: Request) -> dict:
        self.requests.append(request)
        for suffix, response in self.responses.items():
            if request.url.endswith(suffix):
                return response
        return {}


class GkeCloud:
    """CloudProvider over real GKE payloads. Idempotent the GKE way:
    list-then-create, and a 409 from the create (a concurrent apply won
    the race) is treated as success — second apply must no-op
    (`kfctl_second_apply.py`). The ensure/create-409 contract needs a
    transport that classifies statuses (`credentials.AuthTransport`);
    `RecordingTransport` never raises, so dry runs just record."""

    def __init__(self, transport: Transport, cluster: str | None = None):
        self.transport = transport
        self.cluster = cluster

    def ensure_cluster(self, spec: PlatformSpec) -> None:
        """The cluster itself, before any pools (the reference's PLATFORM
        phase creates it via Deployment Manager, `kfctlServer.go:268`)."""
        from kubeflow_tpu_torch.deploy.credentials import (
            CloudConflict,
            CloudNotFound,
        )

        try:
            existing = self.transport.send(
                cluster_get_request(spec, self.cluster)
            )
            # An empty body means "no such cluster" on transports that
            # don't classify statuses (RecordingTransport returns {}): a
            # real GET returns the cluster object with its name, so this
            # keeps recorded traffic identical to real traffic (dry runs
            # record the cluster create too).
            if existing.get("name"):
                return
        except CloudNotFound:
            pass
        try:
            self.transport.send(cluster_create_request(spec, self.cluster))
        except CloudConflict:
            pass  # concurrent apply created it between GET and POST

    def ensure_node_pool(self, spec: PlatformSpec, pool: NodePool) -> None:
        from kubeflow_tpu_torch.deploy.credentials import CloudConflict

        existing = self.list_node_pools(spec)
        if pool.name in existing:
            return
        try:
            self.transport.send(
                node_pool_create_request(spec, pool, self.cluster)
            )
        except CloudConflict:
            pass  # lost a list/create race to a concurrent apply — fine

    def delete_node_pool(self, spec: PlatformSpec, pool_name: str) -> None:
        from kubeflow_tpu_torch.deploy.credentials import CloudNotFound

        try:
            self.transport.send(
                node_pool_delete_request(spec, pool_name, self.cluster)
            )
        except CloudNotFound:
            pass  # already gone — teardown retries/gc must be idempotent

    def list_node_pools(self, spec: PlatformSpec) -> list[str]:
        response = self.transport.send(
            node_pool_list_request(spec, self.cluster)
        )
        return sorted(
            p.get("name", "") for p in response.get("nodePools", [])
        )


def dry_run_requests(spec: PlatformSpec) -> list[Request]:
    """Everything the PLATFORM phase would send, in order — the payloads
    `--dry-run` prints."""
    out = [cluster_create_request(spec)]
    for pool in spec.node_pools:
        out.append(node_pool_create_request(spec, pool))
    return out
