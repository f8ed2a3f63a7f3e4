"""PlatformSpec, the KfDef analog, with GPU node pools.

Counterpart of `kubeflow_tpu/deploy/kfdef.py`. The reference's KfDef CR
is the platform's whole desired state as one YAML document
(`kfctlServer.go:105-140` writes it to app.yaml and loads it through
`coordinator.NewLoadKfAppFromURI`). It describes:

- `platform`: the cloud side: project/zone and the **GPU node pools**
  (an accelerator such as `h100`, the pool's GPU count written as a
  topology such as `4x8`, a preemptible flag), each Node carrying
  `nvidia.com/gpu` capacity;
- `applications`: the component bundles to apply, each with optional
  overlay patches.

The YAML keys, the round trip, `topology_chips` and the `num_chips` /
`num_hosts` formulas are JAX's. The GPU translation, TPU capacity to GPU
capacity, lives here and in `deploy/provisioner.py`; every other module
reads it from them:

| JAX package (TPU)                          | port (GPU)                                 |
|--------------------------------------------|--------------------------------------------|
| `TPU_CHIPS_PER_HOST` (v4/v5e/v5p/v6e: 4)   | `GPUS_PER_HOST` (h100: 8)                  |
| unknown accelerator: 4 chips a host        | unknown accelerator: 8 GPUs a host         |
| `NodePool.accelerator` default `v5e`       | `h100`                                     |
| default pool `tpu-pool-0`, `v5e` `4x4` (4 hosts) | `gpu-pool-0`, `h100` `4x8` (4 hosts)  |
| capacity `google.com/tpu`                  | `nvidia.com/gpu` (`provisioner.GPU_RESOURCE`) |
| label `cloud.google.com/tpu-accelerator`: `v5e` | `cloud.google.com/gke-accelerator`: `nvidia-h100-80gb` (`GKE_ACCELERATORS`) |
| GKE machine `ct5lp-hightpu-4t` etc.        | `a3-highgpu-1g/-2g/-4g/-8g` (`gke.MACHINE_TYPES`) |
| multi-host `placementPolicy.tpuTopology`   | `COMPACT` placement, no `tpuTopology`      |

The platform, pool and topology labels keep their names.
"""

from __future__ import annotations

import dataclasses

import yaml

GPUS_PER_HOST = {
    # GPUs on one host VM: an H100 host (GKE's a3-highgpu-8g) holds 8.
    "h100": 8,
}
DEFAULT_GPUS_PER_HOST = 8

# The value of GKE's accelerator label and of a node pool's
# acceleratorType for each accelerator a spec names.
GKE_ACCELERATORS = {
    "h100": "nvidia-h100-80gb",
}


def gke_accelerator(accelerator: str) -> str:
    """GKE's name for `accelerator` (names not in the table pass
    through)."""
    return GKE_ACCELERATORS.get(accelerator, accelerator)


def topology_chips(topology: str) -> int:
    """'2x2' -> 4, '4x8' -> 32. Empty -> 1."""
    if not topology:
        return 1
    n = 1
    for part in topology.lower().split("x"):
        n *= int(part)
    return n


@dataclasses.dataclass
class NodePool:
    name: str
    accelerator: str = "h100"  # GPU model
    topology: str = "2x2"  # GPU count as dims, e.g. 1, 2x2, 4x8
    preemptible: bool = False

    @property
    def num_chips(self) -> int:
        return topology_chips(self.topology)

    @property
    def num_hosts(self) -> int:
        per_host = GPUS_PER_HOST.get(self.accelerator, DEFAULT_GPUS_PER_HOST)
        return max(1, self.num_chips // per_host)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "accelerator": self.accelerator,
            "topology": self.topology,
            "preemptible": self.preemptible,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NodePool":
        return cls(
            name=d["name"],
            accelerator=d.get("accelerator", "h100"),
            topology=d.get("topology", "2x2"),
            preemptible=bool(d.get("preemptible", False)),
        )


@dataclasses.dataclass
class PlatformSpec:
    name: str
    project: str = "local"
    zone: str = "local-a"
    # Cloud provider for the PLATFORM phase: "fake" materializes Nodes
    # in-process (platform-in-a-box/CI); "gke" constructs real
    # container-v1 payloads through `deploy.gke.GkeCloud`'s Transport
    # seam (GKE materializes the nodes). The reference's KfDef carried
    # the same choice as its platform plugin list.
    provider: str = "fake"
    node_pools: list[NodePool] = dataclasses.field(default_factory=list)
    applications: list[str] = dataclasses.field(default_factory=list)
    email: str | None = None  # platform admin (IAM seed)
    # Kustomize-style overlays (deploy.overlays.Overlay dicts), applied in
    # order to every bundle resource by the K8S phase — the reference's
    # per-component config/overlays, carried on the KfDef itself.
    overlays: list[dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "apiVersion": "kubeflow-tpu.org/v1",
            "kind": "PlatformSpec",
            "metadata": {"name": self.name},
            "spec": {
                "project": self.project,
                "zone": self.zone,
                "provider": self.provider,
                "email": self.email,
                "nodePools": [p.to_dict() for p in self.node_pools],
                "applications": list(self.applications),
                "overlays": [dict(o) for o in self.overlays],
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PlatformSpec":
        spec = d.get("spec", {})
        return cls(
            name=d.get("metadata", {}).get("name", "kubeflow-tpu"),
            project=spec.get("project", "local"),
            zone=spec.get("zone", "local-a"),
            provider=spec.get("provider", "fake"),
            email=spec.get("email"),
            node_pools=[
                NodePool.from_dict(p) for p in spec.get("nodePools", [])
            ],
            applications=list(spec.get("applications", [])),
            overlays=[dict(o) for o in spec.get("overlays", [])],
        )

    @classmethod
    def from_yaml(cls, text: str) -> "PlatformSpec":
        return cls.from_dict(yaml.safe_load(text))

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def default_spec(name: str = "kubeflow-tpu") -> PlatformSpec:
    """The default full deployment: every bundle and one GPU pool of four
    H100 hosts (32 GPUs), as JAX's default pool is four TPU hosts."""
    from kubeflow_tpu_torch.deploy.bundles import BUNDLES

    return PlatformSpec(
        name=name,
        node_pools=[NodePool(name="gpu-pool-0", accelerator="h100", topology="4x8")],
        applications=list(BUNDLES),
    )
