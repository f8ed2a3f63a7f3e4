"""TpuJob: the platform's training-job CRD.

Counterpart of `kubeflow_tpu/api/tpujob.py` (a module with no JAX in
it), the same CR: users submit the same object to either operator. One
homogeneous worker gang; the accelerator count per worker is
`tpu.chipsPerWorker` (on the port's operator, GPUs per worker: the pods
ask ``nvidia.com/gpu``); the operator injects the TPUJOB_* env contract
that `kubeflow_tpu_torch.parallel.distributed.initialize_from_env`
consumes, and restarts the whole gang on any worker failure, bounded by
`maxRestarts`.

`priority` orders gangs for preemption: a pending gang evicts gangs of
strictly lower priority when that lets it place. `elasticMinReplicas`
is parsed and validated as in JAX, but the port's operator does not
resize a gang yet: `unported_fields` names elastic resize, and the
port's admission and reconcile refuse such a spec (ROADMAP Queue 1 item
12). A rigid gang of several workers trains as one model
(`train/trainer.py` on a process mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from kubeflow_tpu_torch.api.objects import Resource, new_resource, parse_quantity

KIND = "TpuJob"
COORDINATOR_PORT = 8476
# The resource a worker pod asks for, one per accelerator
# (`tpu.chipsPerWorker`): the JAX operator's pods ask "google.com/tpu".
ACCELERATOR_RESOURCE = "nvidia.com/gpu"


@dataclasses.dataclass(frozen=True)
class TpuJobSpec:
    """Typed view over a TpuJob's spec dict."""

    replicas: int = 1
    image: str = "kubeflow-tpu/worker:latest"
    command: tuple[str, ...] = ()
    args: tuple[str, ...] = ()
    env: tuple[tuple[str, str], ...] = ()
    tpu_chips_per_worker: int = 4
    topology: str = ""  # e.g. "4x4"; empty = any pool
    num_slices: int = 1
    max_restarts: int = 3
    checkpoint_dir: str = ""
    # Per-worker host-resource limits (K8s quantities, e.g.
    # ("cpu", "500m"), ("memory", "2Gi")).
    resources: tuple[tuple[str, str], ...] = ()
    # Gang priority: a pending gang may evict strictly lower ones.
    priority: int = 0
    # Elastic gang floor (shrink instead of eviction): not ported.
    elastic_min_replicas: int = 0

    def validate(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.tpu_chips_per_worker < 0:
            raise ValueError("tpu_chips_per_worker must be >= 0")
        if self.num_slices < 1 or self.replicas % self.num_slices:
            raise ValueError(
                f"num_slices ({self.num_slices}) must divide replicas "
                f"({self.replicas}) evenly"
            )
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if not 0 <= self.elastic_min_replicas <= self.replicas:
            raise ValueError(
                f"elastic_min_replicas ({self.elastic_min_replicas}) "
                f"must be between 0 (rigid gang) and replicas "
                f"({self.replicas})"
            )
        for resource, value in self.resources:
            if resource in ("google.com/tpu", ACCELERATOR_RESOURCE):
                raise ValueError(
                    f"spec the accelerator count via tpu.chipsPerWorker, not "
                    f"resources[{resource!r}] — one source of truth"
                )
            try:
                parse_quantity(value)
            except ValueError as e:
                raise ValueError(f"resources[{resource!r}]: {e}") from e

    def unported_fields(self) -> list[str]:
        """What this spec asks that the port's operator cannot do yet,
        one sentence each; empty when it can run the spec as written."""
        out = []
        if self.elastic_min_replicas > 0:
            out.append(
                f"elasticMinReplicas {self.elastic_min_replicas}: elastic gang "
                "resize is not ported to the PyTorch operator yet; a rigid "
                "gang (elasticMinReplicas 0) of any size trains"
            )
        return out

    def to_dict(self) -> dict[str, Any]:
        return {
            "replicas": self.replicas,
            "image": self.image,
            "command": list(self.command),
            "args": list(self.args),
            "env": [{"name": k, "value": v} for k, v in self.env],
            "tpu": {
                "chipsPerWorker": self.tpu_chips_per_worker,
                "topology": self.topology,
                "numSlices": self.num_slices,
            },
            "maxRestarts": self.max_restarts,
            "checkpointDir": self.checkpoint_dir,
            "priority": self.priority,
            "elasticMinReplicas": self.elastic_min_replicas,
            "resources": {k: v for k, v in self.resources},
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TpuJobSpec":
        # Strict: a typo'd field silently dropped would leave e.g. an
        # empty command and a gang that can never run.
        unknown = set(d) - KNOWN_FIELDS
        if unknown:
            raise ValueError(
                f"unknown TpuJob spec field(s) {sorted(unknown)}; known: "
                f"{sorted(KNOWN_FIELDS)}"
            )
        tpu = d.get("tpu") or {}
        if not isinstance(tpu, dict):
            raise ValueError(
                f"spec.tpu must be a mapping "
                f"(chipsPerWorker/topology/numSlices), got {tpu!r}"
            )
        unknown_tpu = set(tpu) - KNOWN_TPU_FIELDS
        if unknown_tpu:
            raise ValueError(
                f"unknown TpuJob spec.tpu field(s) {sorted(unknown_tpu)}; "
                f"known: {sorted(KNOWN_TPU_FIELDS)}"
            )
        spec = cls(
            replicas=d.get("replicas", 1),
            image=d.get("image", "kubeflow-tpu/worker:latest"),
            command=tuple(d.get("command") or ()),
            args=tuple(d.get("args") or ()),
            env=tuple((e["name"], e["value"]) for e in (d.get("env") or [])),
            tpu_chips_per_worker=tpu.get("chipsPerWorker", 4),
            topology=tpu.get("topology", ""),
            num_slices=tpu.get("numSlices", 1),
            max_restarts=d.get("maxRestarts", 3),
            checkpoint_dir=d.get("checkpointDir", ""),
            priority=int(d.get("priority", 0)),
            elastic_min_replicas=int(d.get("elasticMinReplicas", 0)),
            resources=tuple(sorted((d.get("resources") or {}).items())),
        )
        spec.validate()
        return spec


# Derived from the serializer so the allowlists never drift from what
# to_dict emits.
KNOWN_FIELDS = frozenset(TpuJobSpec().to_dict())
KNOWN_TPU_FIELDS = frozenset(TpuJobSpec().to_dict()["tpu"])


def make_tpujob(name: str, namespace: str = "default", **spec_kwargs) -> Resource:
    spec = TpuJobSpec(**spec_kwargs)
    spec.validate()
    return new_resource(KIND, name, namespace, spec=spec.to_dict())
