"""Generic resource model: metadata + free-form spec/status dicts.

A cut-down copy of `kubeflow_tpu/api/objects.py` (a module with no JAX
in it), holding what the serving and job control planes use: `Resource`,
`ObjectMeta`, `new_resource`, `owner_ref`, frozen snapshots with
`thaw()` and their cached wire bytes, the K8s quantity parser and the
pod limit totals the gang scheduler reserves by. Not copied: the
requests/limits defaulting rule of quota admission (not ported).

The store (`testing/fake_apiserver.py`) commits ONE copy per write,
freezes it and shares that snapshot with every consumer: journal,
watch handlers, get/list results. A consumer that needs to mutate takes
a private copy with `.thaw()` first; mutating a frozen snapshot raises
`FrozenResourceError` instead of corrupting the other consumers.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import time
import uuid
from typing import Any

GROUP = "kubeflow-tpu.org"
VERSION = "v1"


class FrozenResourceError(TypeError):
    """Raised on any mutation of a frozen Resource snapshot."""


_FROZEN_HINT = (
    "this Resource is a frozen shared snapshot (copy-on-write store); "
    "call .thaw() on the Resource for a private mutable copy"
)


class _FrozenDict(dict):
    """Immutable dict for frozen snapshots: still a real dict (json,
    iteration, equality), only the mutating surface is closed;
    deepcopy yields plain mutable containers."""

    __slots__ = ()

    def _frozen(self, *args, **kwargs):
        raise FrozenResourceError(_FROZEN_HINT)

    __setitem__ = __delitem__ = _frozen
    __ior__ = _frozen
    clear = pop = popitem = setdefault = update = _frozen

    def __deepcopy__(self, memo):
        return {k: copy.deepcopy(v, memo) for k, v in self.items()}

    def __copy__(self):
        return dict(self)

    def __reduce__(self):
        return (dict, (), None, None, iter(self.items()))


class _FrozenList(list):
    """Immutable list for frozen snapshots (see _FrozenDict)."""

    __slots__ = ()

    def _frozen(self, *args, **kwargs):
        raise FrozenResourceError(_FROZEN_HINT)

    __setitem__ = __delitem__ = __iadd__ = __imul__ = _frozen
    append = extend = insert = pop = remove = _frozen
    clear = sort = reverse = _frozen

    def __deepcopy__(self, memo):
        return [copy.deepcopy(v, memo) for v in self]

    def __copy__(self):
        return list(self)

    def __reduce__(self):
        return (list, (), None, iter(self))


def _frozen_value(value):
    """Deep-freeze plain JSON-ish containers in one walk."""
    if isinstance(value, dict):
        return _FrozenDict((k, _frozen_value(v)) for k, v in value.items())
    if isinstance(value, list):
        return _FrozenList(_frozen_value(v) for v in value)
    return value


class _Freezable:
    """Attribute-level mutation guard shared by Resource and ObjectMeta.
    Freezing writes through __dict__ (bypassing the guard)."""

    def __setattr__(self, name, value):
        if self.__dict__.get("_kftpu_frozen"):
            raise FrozenResourceError(_FROZEN_HINT)
        object.__setattr__(self, name, value)

    def __delattr__(self, name):
        if self.__dict__.get("_kftpu_frozen"):
            raise FrozenResourceError(_FROZEN_HINT)
        object.__delattr__(self, name)

    @property
    def frozen(self) -> bool:
        return bool(self.__dict__.get("_kftpu_frozen"))


@dataclasses.dataclass
class ObjectMeta(_Freezable):
    name: str
    namespace: str = "default"
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: dict[str, str] = dataclasses.field(default_factory=dict)
    uid: str | None = None
    resource_version: int = 0
    generation: int = 0
    creation_timestamp: float | None = None
    deletion_timestamp: float | None = None
    finalizers: list[str] = dataclasses.field(default_factory=list)
    owner_references: list[dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "namespace": self.namespace,
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
            "uid": self.uid,
            "resourceVersion": self.resource_version,
            "generation": self.generation,
            "creationTimestamp": self.creation_timestamp,
            "deletionTimestamp": self.deletion_timestamp,
            "finalizers": list(self.finalizers),
            "ownerReferences": copy.deepcopy(self.owner_references),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectMeta":
        return cls(
            name=d["name"],
            namespace=d.get("namespace", "default"),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            uid=d.get("uid"),
            resource_version=d.get("resourceVersion", 0),
            generation=d.get("generation", 0),
            creation_timestamp=d.get("creationTimestamp"),
            deletion_timestamp=d.get("deletionTimestamp"),
            finalizers=list(d.get("finalizers") or []),
            owner_references=copy.deepcopy(d.get("ownerReferences") or []),
        )

    def __deepcopy__(self, memo):
        return ObjectMeta.from_dict(self.to_dict())

    def _freeze(self) -> None:
        d = self.__dict__
        for key in ("labels", "annotations", "finalizers", "owner_references"):
            d[key] = _frozen_value(d[key])
        d["_kftpu_frozen"] = True


@dataclasses.dataclass
class Resource(_Freezable):
    kind: str
    metadata: ObjectMeta
    spec: dict[str, Any] = dataclasses.field(default_factory=dict)
    status: dict[str, Any] = dataclasses.field(default_factory=dict)
    api_version: str = f"{GROUP}/{VERSION}"

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.kind, self.metadata.namespace, self.metadata.name)

    def deepcopy(self) -> "Resource":
        return Resource(
            kind=self.kind,
            metadata=ObjectMeta.from_dict(self.metadata.to_dict()),
            spec=copy.deepcopy(self.spec),
            status=copy.deepcopy(self.status),
            api_version=self.api_version,
        )

    def __deepcopy__(self, memo):
        return self.deepcopy()

    def freeze(self) -> "Resource":
        """Make this object deeply immutable, in place, and return it
        (the store's commit point)."""
        d = self.__dict__
        if d.get("_kftpu_frozen"):
            return self
        self.metadata._freeze()
        d["spec"] = _frozen_value(d["spec"])
        d["status"] = _frozen_value(d["status"])
        d["_kftpu_frozen"] = True
        return self

    def thaw(self) -> "Resource":
        """A mutable Resource: a private deep copy when frozen, self
        otherwise (HttpApiClient results are already private parses, so
        the read-modify-write idiom is the same for both clients)."""
        return self.deepcopy() if self.frozen else self

    def _wire_dict(self) -> dict:
        """to_dict() without the defensive copies, for immediate
        serialization only."""
        m = self.metadata
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": {
                "name": m.name,
                "namespace": m.namespace,
                "labels": m.labels,
                "annotations": m.annotations,
                "uid": m.uid,
                "resourceVersion": m.resource_version,
                "generation": m.generation,
                "creationTimestamp": m.creation_timestamp,
                "deletionTimestamp": m.deletion_timestamp,
                "finalizers": m.finalizers,
                "ownerReferences": m.owner_references,
            },
            "spec": self.spec,
            "status": self.status,
        }

    def wire_bytes(self) -> bytes:
        """Compact-JSON wire form. On a frozen snapshot the bytes are
        computed once and cached, so get/list responses and the watch
        stream share one serialization per commit."""
        if not self.frozen:
            return json.dumps(self._wire_dict(), separators=(",", ":")).encode()
        cached = self.__dict__.get("_kftpu_wire")
        if cached is None:
            # A cache of derived state, not a mutation: written through
            # __dict__ past the freeze guard.
            cached = json.dumps(self._wire_dict(), separators=(",", ":")).encode()
            self.__dict__["_kftpu_wire"] = cached
        return cached

    def to_dict(self) -> dict:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "metadata": self.metadata.to_dict(),
            "spec": copy.deepcopy(self.spec),
            "status": copy.deepcopy(self.status),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Resource":
        return cls(
            kind=d["kind"],
            metadata=ObjectMeta.from_dict(d["metadata"]),
            spec=copy.deepcopy(d.get("spec") or {}),
            status=copy.deepcopy(d.get("status") or {}),
            api_version=d.get("apiVersion", f"{GROUP}/{VERSION}"),
        )


def new_resource(
    kind: str,
    name: str,
    namespace: str = "default",
    *,
    spec: dict | None = None,
    labels: dict | None = None,
    annotations: dict | None = None,
    api_version: str = f"{GROUP}/{VERSION}",
) -> Resource:
    return Resource(
        kind=kind,
        metadata=ObjectMeta(
            name=name,
            namespace=namespace,
            labels=dict(labels or {}),
            annotations=dict(annotations or {}),
        ),
        spec=dict(spec or {}),
        api_version=api_version,
    )


def owner_ref(owner: Resource, *, controller: bool = True) -> dict:
    """An ownerReference to `owner`: the cascade edge."""
    return {
        "apiVersion": owner.api_version,
        "kind": owner.kind,
        "name": owner.metadata.name,
        "uid": owner.metadata.uid,
        "controller": controller,
    }


# K8s quantity suffixes (resource.Quantity): decimal SI, binary, milli.
_QUANTITY_SUFFIXES = {
    "m": 1e-3,
    "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18,
    "Ki": 2**10, "Mi": 2**20, "Gi": 2**30,
    "Ti": 2**40, "Pi": 2**50, "Ei": 2**60,
}
_SUFFIXES_BY_LEN = sorted(_QUANTITY_SUFFIXES, key=len, reverse=True)


def parse_quantity(value) -> float:
    """A K8s resource quantity as a float in its base unit (cores,
    bytes, chips): ``"500m"`` → 0.5, ``"128Gi"`` → 137438953472.0,
    ``2`` → 2.0. Raises ValueError on anything unparseable, negative or
    not finite."""

    def _finite(x: float) -> float:
        if not math.isfinite(x) or x < 0:
            raise ValueError(f"not a non-negative finite quantity: {value!r}")
        return x

    if isinstance(value, bool):
        raise ValueError(f"not a quantity: {value!r}")
    if isinstance(value, (int, float)):
        return _finite(float(value))
    s = str(value).strip()
    for suffix in _SUFFIXES_BY_LEN:
        if s.endswith(suffix):
            try:
                return _finite(float(s[: -len(suffix)]) * _QUANTITY_SUFFIXES[suffix])
            except ValueError:
                break  # e.g. "Gi" alone / "xMi": fall through to error
    try:
        return _finite(float(s))
    except ValueError:
        raise ValueError(f"not a quantity: {value!r}") from None


def container_resource_total(pod: "Resource", resource: str, *, source: str) -> int | float:
    """Sum `resource` across a pod's containers from `source`
    ("requests" or "limits"), with the K8s defaulting rule per
    container: absent requests default to the container's limits, and
    absent limits fall back to requests (K8s leaves that to LimitRanger;
    without it a pod sized by one figure slips a cap on the other).
    Integral totals come back as int (chip counts)."""
    other = "limits" if source == "requests" else "requests"
    total = 0.0
    for c in pod.spec.get("containers", []):
        res = c.get("resources", {})
        value = res.get(source, {}).get(resource)
        if value is None:
            value = res.get(other, {}).get(resource, 0)
        total += parse_quantity(value)
    return int(total) if total == int(total) else total


def container_limits_total(pod: "Resource", resource: str) -> int | float:
    """Sum a resource limit across ALL of a pod's containers (an empty
    container list is 0). Values are K8s quantities ("500m", "128Gi",
    4); integral totals come back as int (chip counts)."""
    total = sum(
        parse_quantity(c.get("resources", {}).get("limits", {}).get(resource, 0))
        for c in pod.spec.get("containers", [])
    )
    return int(total) if total == int(total) else total


def fresh_uid() -> str:
    return str(uuid.uuid4())


def now() -> float:
    return time.time()
