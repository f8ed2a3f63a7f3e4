"""ServingDeployment: the platform's online-serving CRD.

A copy of `kubeflow_tpu/api/serving.py` (a module with no JAX in it),
plus `version_current`, the one rule for when a replica serves the
version its spec asks for. One CR declares a fleet of model replicas
that the serving controller (`controllers/serving.py`) reconciles into
N replica workers behind the drain-aware router: replica config is
pushed through owned ``ServingReplica`` objects, and a checkpoint roll
drains one replica at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.train.checkpoint import holds_step

KIND = "ServingDeployment"
# Owned per-replica object: the config-push channel (controller writes
# spec, replica worker watches it and stamps status.ready / queue stats).
REPLICA_KIND = "ServingReplica"

LABEL_DEPLOYMENT = "serving.kubeflow-tpu.dev/deployment"


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """Queue-signal-driven target-replica policy.

    The controller computes ``targetReplicas`` from the fleet's aggregate
    queue depth (the `BatchingQueue` gauges are the input signal) and
    surfaces it through status; replica count then converges to it.
    """

    min_replicas: int = 1
    max_replicas: int = 1
    # Desired steady-state queued requests per replica. Depth above this
    # scales out; an idle fleet settles back to min_replicas.
    target_queue_depth: int = 32
    # Observed-latency signal: rolling p99 queue-wait above this scales
    # out even when queues look shallow (slow-drain pathology: a fleet
    # whose batches execute slowly can hold SLO-busting waits at modest
    # depth). 0 disables the signal — depth-only, the original policy.
    target_latency_ms: float = 0.0
    # Scale-down stabilization window (HPA's stabilizationWindowSeconds
    # posture): the controller only shrinks the fleet to the MAXIMUM
    # target computed over this many trailing seconds, so one quiet
    # reconcile between bursts can't flap replicas down and back up —
    # the latency signal is especially spiky (p99 over a small rolling
    # window). Scale-UP stays immediate. 0 disables (original policy).
    scale_down_stabilization_s: float = 0.0

    def validate(self) -> None:
        if self.min_replicas < 1:
            raise ValueError(
                f"autoscale.minReplicas must be >= 1, got {self.min_replicas}"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscale.maxReplicas ({self.max_replicas}) must be >= "
                f"minReplicas ({self.min_replicas})"
            )
        if self.target_queue_depth < 1:
            raise ValueError(
                f"autoscale.targetQueueDepth must be >= 1, got "
                f"{self.target_queue_depth}"
            )
        if self.target_latency_ms < 0:
            raise ValueError(
                f"autoscale.targetLatencyMs must be >= 0, got "
                f"{self.target_latency_ms}"
            )
        if self.scale_down_stabilization_s < 0:
            raise ValueError(
                f"autoscale.scaleDownStabilizationSeconds must be >= 0, "
                f"got {self.scale_down_stabilization_s}"
            )

    def target(
        self,
        total_queue_depth: int,
        *,
        p99_latency_ms: float | None = None,
        current_replicas: int | None = None,
    ) -> int:
        """Desired replica count from the observed signals.

        Two signals, scale-up wins (HPA's max-over-metrics rule): the
        queue-depth want is ``ceil(depth / target_depth)``; the latency
        want is the HPA proportional form ``ceil(current * p99/target)``
        — when they disagree the fleet converges to the larger, so a
        latency breach is never masked by shallow queues and a deep
        backlog is never masked by fast batches."""
        want = math.ceil(total_queue_depth / self.target_queue_depth)
        if (
            self.target_latency_ms > 0
            and p99_latency_ms is not None
            and current_replicas
        ):
            latency_want = math.ceil(
                current_replicas * p99_latency_ms / self.target_latency_ms
            )
            want = max(want, latency_want)
        return max(self.min_replicas, min(self.max_replicas, want))


# Priority classes a CR may assign to a model (the admission ladder in
# `serving/admission.DEFAULT_PRIORITIES`). Kept as a literal so the API
# layer does not import the serving package.
KNOWN_PRIORITY_CLASSES = ("critical", "standard", "batch")


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One servable on a multiplexed fleet (``spec.models[*]``).

    Per-model knobs: its own version (rolls are per-model), its own
    checkpoint dir, the priority class its traffic defaults to, and a
    token-bucket quota (``quotaRate``/``quotaBurst``) the admission
    controller charges the model's tenants against. ``quotaRate`` 0 =
    uncapped."""

    name: str = "model"
    model_version: int = 0
    checkpoint_dir: str = ""
    priority: str = "standard"
    quota_rate: float = 0.0
    quota_burst: float = 1.0

    def validate(self) -> None:
        if not self.name:
            raise ValueError("models[].name must be non-empty")
        if self.model_version < 0:
            raise ValueError("models[].modelVersion must be >= 0")
        if self.priority not in KNOWN_PRIORITY_CLASSES:
            raise ValueError(
                f"models[].priority must be one of "
                f"{list(KNOWN_PRIORITY_CLASSES)}, got {self.priority!r}"
            )
        if self.quota_rate < 0:
            raise ValueError("models[].quotaRate must be >= 0")
        if self.quota_burst < 1:
            raise ValueError("models[].quotaBurst must be >= 1")

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "modelVersion": self.model_version,
            "checkpointDir": self.checkpoint_dir,
            "priority": self.priority,
            "quotaRate": self.quota_rate,
            "quotaBurst": self.quota_burst,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelEntry":
        unknown = set(d) - KNOWN_MODEL_FIELDS
        if unknown:
            raise ValueError(
                f"unknown spec.models field(s) {sorted(unknown)}; "
                f"known: {sorted(KNOWN_MODEL_FIELDS)}"
            )
        entry = cls(
            name=d.get("name", "model"),
            model_version=int(d.get("modelVersion", 0)),
            checkpoint_dir=d.get("checkpointDir", ""),
            priority=d.get("priority", "standard"),
            quota_rate=float(d.get("quotaRate", 0.0)),
            quota_burst=float(d.get("quotaBurst", 1.0)),
        )
        entry.validate()
        return entry


@dataclasses.dataclass(frozen=True)
class ServingDeploymentSpec:
    """Typed view over a ServingDeployment's spec dict."""

    model: str = "model"
    replicas: int = 1
    max_batch: int = 64
    batch_timeout_ms: float = 5.0
    max_pending: int = 1024
    # Continuous batching: late-admit compatible arrivals into the
    # in-flight flush window. Kept in the CR for the JAX package's
    # schema; the port's batching queue always late-admits.
    continuous: bool = True
    # Where replica workers restore the model from. Empty = the replica
    # runtime's built-in demo model (dev/bench shape).
    checkpoint_dir: str = ""
    # Desired live model version (the checkpoint step). 0 = whatever the
    # replica loaded; a bump triggers a one-replica-at-a-time drain-based
    # roll (zero downtime — the rest of the fleet keeps admitting).
    model_version: int = 0
    # How replicas are materialized: "local" = in-process servables
    # behind the controller's router (dev/bench single-binary shape);
    # "process" = real `python -m kubeflow_tpu_torch.serving` worker
    # processes that join the fleet over the apiserver facade and
    # self-roll on config push.
    runtime: str = "local"
    autoscale: AutoscaleSpec | None = None
    # Multiplexing: N servables on one replica fleet. Empty =
    # the original single-model deployment (spec.model/.checkpointDir/
    # .modelVersion). Non-empty = every replica hosts a ServableRegistry
    # over these entries and spec.model only names the deployment's
    # default servable for clients that don't say which model they want.
    models: tuple[ModelEntry, ...] = ()
    # LRU weight paging: how many of `models` may hold device-resident
    # weights per replica at once. 0 = unlimited (everything stays
    # resident once touched). Ignored for single-model deployments.
    max_resident: int = 0

    def validate(self) -> None:
        if not self.model:
            raise ValueError("model name must be non-empty")
        if self.max_resident < 0:
            raise ValueError(
                f"paging.maxResident must be >= 0, got {self.max_resident}"
            )
        if self.models:
            names = [m.name for m in self.models]
            if len(set(names)) != len(names):
                raise ValueError(
                    f"models[].name entries must be unique, got {names}"
                )
            for m in self.models:
                m.validate()
        if self.runtime not in ("local", "process"):
            raise ValueError(
                f"runtime must be 'local' or 'process', got {self.runtime!r}"
            )
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.max_batch < 1:
            raise ValueError(f"maxBatch must be >= 1, got {self.max_batch}")
        if self.batch_timeout_ms < 0:
            raise ValueError("batching.timeoutMs must be >= 0")
        if self.max_pending < 1:
            raise ValueError("batching.maxPending must be >= 1")
        if self.model_version < 0:
            raise ValueError("modelVersion must be >= 0")
        if self.autoscale is not None:
            self.autoscale.validate()

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "model": self.model,
            "replicas": self.replicas,
            "maxBatch": self.max_batch,
            "batching": {
                "timeoutMs": self.batch_timeout_ms,
                "maxPending": self.max_pending,
                "continuous": self.continuous,
            },
            "checkpointDir": self.checkpoint_dir,
            "modelVersion": self.model_version,
            "runtime": self.runtime,
            # Always emitted (even when unset) so KNOWN_FIELDS, derived
            # from this serializer, admits them on the way back in.
            "models": [m.to_dict() for m in self.models],
            "paging": {"maxResident": self.max_resident},
            "autoscale": (
                {
                    "minReplicas": self.autoscale.min_replicas,
                    "maxReplicas": self.autoscale.max_replicas,
                    "targetQueueDepth": self.autoscale.target_queue_depth,
                    "targetLatencyMs": self.autoscale.target_latency_ms,
                    "scaleDownStabilizationSeconds": (
                        self.autoscale.scale_down_stabilization_s
                    ),
                }
                if self.autoscale is not None
                else None
            ),
        }
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ServingDeploymentSpec":
        # Strict field validation (same contract as TpuJobSpec): a typo'd
        # field silently dropped would leave e.g. a fleet that never
        # autoscales, with nothing pointing at the cause.
        unknown = set(d) - KNOWN_FIELDS
        if unknown:
            raise ValueError(
                f"unknown ServingDeployment spec field(s) {sorted(unknown)}; "
                f"known: {sorted(KNOWN_FIELDS)}"
            )
        batching = d.get("batching") or {}
        if not isinstance(batching, dict):
            raise ValueError(
                f"spec.batching must be a mapping "
                f"(timeoutMs/maxPending/continuous), got {batching!r}"
            )
        unknown_b = set(batching) - KNOWN_BATCHING_FIELDS
        if unknown_b:
            raise ValueError(
                f"unknown spec.batching field(s) {sorted(unknown_b)}; "
                f"known: {sorted(KNOWN_BATCHING_FIELDS)}"
            )
        autoscale_d = d.get("autoscale")
        autoscale = None
        if autoscale_d is not None:
            if not isinstance(autoscale_d, dict):
                raise ValueError(
                    f"spec.autoscale must be a mapping, got {autoscale_d!r}"
                )
            unknown_a = set(autoscale_d) - KNOWN_AUTOSCALE_FIELDS
            if unknown_a:
                raise ValueError(
                    f"unknown spec.autoscale field(s) {sorted(unknown_a)}; "
                    f"known: {sorted(KNOWN_AUTOSCALE_FIELDS)}"
                )
            autoscale = AutoscaleSpec(
                min_replicas=int(autoscale_d.get("minReplicas", 1)),
                max_replicas=int(autoscale_d.get("maxReplicas", 1)),
                target_queue_depth=int(
                    autoscale_d.get("targetQueueDepth", 32)
                ),
                target_latency_ms=float(
                    autoscale_d.get("targetLatencyMs", 0.0)
                ),
                scale_down_stabilization_s=float(
                    autoscale_d.get("scaleDownStabilizationSeconds", 0.0)
                ),
            )
        models_d = d.get("models") or []
        if not isinstance(models_d, list):
            raise ValueError(
                f"spec.models must be a list of model entries, got "
                f"{models_d!r}"
            )
        paging_d = d.get("paging") or {}
        if not isinstance(paging_d, dict):
            raise ValueError(
                f"spec.paging must be a mapping (maxResident), got "
                f"{paging_d!r}"
            )
        unknown_p = set(paging_d) - KNOWN_PAGING_FIELDS
        if unknown_p:
            raise ValueError(
                f"unknown spec.paging field(s) {sorted(unknown_p)}; "
                f"known: {sorted(KNOWN_PAGING_FIELDS)}"
            )
        spec = cls(
            models=tuple(ModelEntry.from_dict(m) for m in models_d),
            max_resident=int(paging_d.get("maxResident", 0)),
            model=d.get("model", "model"),
            replicas=int(d.get("replicas", 1)),
            max_batch=int(d.get("maxBatch", 64)),
            batch_timeout_ms=float(batching.get("timeoutMs", 5.0)),
            max_pending=int(batching.get("maxPending", 1024)),
            continuous=bool(batching.get("continuous", True)),
            checkpoint_dir=d.get("checkpointDir", ""),
            model_version=int(d.get("modelVersion", 0)),
            runtime=d.get("runtime", "local"),
            autoscale=autoscale,
        )
        spec.validate()
        return spec


# Derived from the serializer so the allowlists can never drift from what
# to_dict emits (same rationale as tpujob.py).
KNOWN_FIELDS = frozenset(ServingDeploymentSpec().to_dict())
KNOWN_BATCHING_FIELDS = frozenset(
    ServingDeploymentSpec().to_dict()["batching"]
)
KNOWN_AUTOSCALE_FIELDS = frozenset(("minReplicas", "maxReplicas",
                                    "targetQueueDepth",
                                    "targetLatencyMs",
                                    "scaleDownStabilizationSeconds"))
KNOWN_MODEL_FIELDS = frozenset(ModelEntry().to_dict())
KNOWN_PAGING_FIELDS = frozenset(
    ServingDeploymentSpec().to_dict()["paging"]
)


def replica_name(deployment: str, index: int) -> str:
    return f"{deployment}-replica-{index}"


def replica_spec(spec: ServingDeploymentSpec) -> dict[str, Any]:
    """The per-replica config the controller pushes through the owned
    ServingReplica object (the watch machinery is the transport:
    the replica worker watches its own object and reacts to spec
    changes — model rolls, batching re-tunes — without re-listing)."""
    out: dict[str, Any] = {
        "model": spec.model,
        "maxBatch": spec.max_batch,
        "batching": {
            "timeoutMs": spec.batch_timeout_ms,
            "maxPending": spec.max_pending,
            "continuous": spec.continuous,
        },
        "checkpointDir": spec.checkpoint_dir,
        "modelVersion": spec.model_version,
    }
    if spec.models:
        out["models"] = [m.to_dict() for m in spec.models]
        out["paging"] = {"maxResident": spec.max_resident}
    return out


def make_serving_deployment(
    name: str, namespace: str = "default", **spec_kwargs
) -> Resource:
    autoscale = spec_kwargs.pop("autoscale", None)
    if isinstance(autoscale, dict):
        autoscale = AutoscaleSpec(**autoscale)
    models = spec_kwargs.pop("models", ())
    models = tuple(
        ModelEntry.from_dict(m) if isinstance(m, dict) else m
        for m in models
    )
    spec = ServingDeploymentSpec(
        autoscale=autoscale, models=models, **spec_kwargs
    )
    spec.validate()
    return new_resource(KIND, name, namespace, spec=spec.to_dict())


def version_current(live: int, want: int, checkpoint_dir: str) -> bool:
    """Whether a replica serving version `live` meets a spec that asks
    for `want` (0 asks for nothing). A checkpoint-backed model restores
    the step `want` while its directory holds it valid, and otherwise
    the newest valid step (`build_servable_from_rspec`): so `live` must
    equal `want`, unless that step is gone (evicted, or never written
    valid) and `live` is past it. The JAX package's controller and worker
    want equality even then, and so roll every replica on every
    reconcile toward a version no restore can give. The demo model has
    no directory and keeps exact equality."""
    if not want or live == want:
        return True
    return bool(checkpoint_dir) and live > want and not holds_step(checkpoint_dir, want)
