"""Multi-version CRDs with hub-and-spoke conversion.

The port's copy of `kubeflow_tpu/api/versioning.py` (a module with no
JAX in it), whole but for one translation: a v1alpha1 Notebook's
`tpuChips` converts to and from the hub's ``nvidia.com/gpu`` limit
(`api/tpujob.ACCELERATOR_RESOURCE`), where JAX's converts the
``google.com/tpu`` one; the port's Notebook controller reads that limit.

- every registered kind declares an ordered list of served versions and
  one **hub** (storage) version;
- each spoke version supplies `to_hub` / `from_hub` spec converters;
- conversions that drop fields stash the leftovers in a round-trip
  annotation (`kubeflow-tpu.org/conversion-stash`) so
  v1 -> v1alpha1 -> v1 loses nothing;
- the storage layer (`FakeApiServer`) normalizes every write to the hub
  version, and readers may ask for any served version.

Status is carried through unchanged: conversion is a spec and metadata
transformation, and status is owned by controllers that always run at
the hub version.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Callable

from kubeflow_tpu_torch.api.objects import GROUP, Resource
from kubeflow_tpu_torch.api.tpujob import ACCELERATOR_RESOURCE

STASH_ANNOTATION = f"{GROUP}/conversion-stash"

# from_hub returns (converted spec, leftover hub fields to stash).
FromHub = Callable[[dict], tuple[dict, dict]]
ToHub = Callable[[dict], dict]


class ConversionError(Exception):
    pass


def _merge_missing(dst: dict, src: dict) -> None:
    """Deep-merge stashed leftovers under the converted spec: the live
    (converted) value wins at every leaf; stashed dict branches merge
    recursively; stashed list items append after the live ones (an env
    list's flattenable entries convert, the valueFrom-style rest is
    stashed and rejoins here)."""
    for key, value in src.items():
        if key not in dst:
            dst[key] = copy.deepcopy(value)
        elif isinstance(dst[key], dict) and isinstance(value, dict):
            _merge_missing(dst[key], value)
        elif isinstance(dst[key], list) and isinstance(value, list):
            dst[key].extend(
                copy.deepcopy(item) for item in value if item not in dst[key]
            )


def _identity_to_hub(spec: dict) -> dict:
    return copy.deepcopy(spec)


def _identity_from_hub(hub: dict) -> tuple[dict, dict]:
    return copy.deepcopy(hub), {}


@dataclasses.dataclass(frozen=True)
class Version:
    name: str
    to_hub: ToHub = _identity_to_hub
    from_hub: FromHub = _identity_from_hub


@dataclasses.dataclass(frozen=True)
class VersionedKind:
    """One kind's version set. `versions` is ordered oldest -> newest;
    `storage` names the hub (must be in `versions`)."""

    kind: str
    versions: tuple[Version, ...]
    storage: str
    group: str = GROUP

    def __post_init__(self):
        if self.storage not in {v.name for v in self.versions}:
            raise ValueError(
                f"storage version {self.storage!r} not among "
                f"{[v.name for v in self.versions]}"
            )

    def version(self, name: str) -> Version:
        for v in self.versions:
            if v.name == name:
                return v
        raise ConversionError(
            f"{self.kind}: version {name!r} not served "
            f"(served: {[v.name for v in self.versions]})"
        )

    def served_versions(self) -> list[str]:
        return [v.name for v in self.versions]

    def api_version(self, version: str) -> str:
        return f"{self.group}/{version}"

    def parse_version(self, api_version: str) -> str:
        """The version segment of an apiVersion, validated as served."""
        group, _, version = api_version.rpartition("/")
        if group and group != self.group:
            raise ConversionError(
                f"{self.kind}: foreign group {group!r} (want {self.group})"
            )
        return self.version(version).name

    def convert(self, resource: Resource, target: str) -> Resource:
        """Convert `resource` (at any served version) to `target`.

        Spec is mapped spoke -> hub -> spoke; fields the target version
        cannot express are stashed in the round-trip annotation, and a
        stash left by an earlier down-conversion is merged back on the
        way up. Metadata (minus the stash) and status pass through."""
        src_name = self.parse_version(resource.api_version)
        target_name = self.version(target).name
        out = resource.deepcopy()
        if src_name == target_name:
            return out

        hub_spec = self.version(src_name).to_hub(out.spec)
        stash_raw = out.metadata.annotations.pop(STASH_ANNOTATION, None)
        if stash_raw and isinstance(stash_raw, str):
            try:
                stash = json.loads(stash_raw)
            except ValueError:
                stash = {}
            if isinstance(stash, dict):
                _merge_missing(hub_spec, stash)

        spec, dropped = self.version(target_name).from_hub(hub_spec)
        if dropped:
            out.metadata.annotations[STASH_ANNOTATION] = json.dumps(
                dropped, sort_keys=True
            )
        out.spec = spec
        out.api_version = self.api_version(target_name)
        return out

    def to_storage(self, resource: Resource) -> Resource:
        return self.convert(resource, self.storage)


class ConversionRegistry:
    def __init__(self):
        self._kinds: dict[str, VersionedKind] = {}

    def register(self, scheme: VersionedKind) -> VersionedKind:
        self._kinds[scheme.kind] = scheme
        return scheme

    def lookup(self, kind: str) -> VersionedKind | None:
        return self._kinds.get(kind)

    def normalize(self, resource: Resource) -> Resource:
        """Storage-side hook: convert a write at any served version to
        the kind's storage version. Unregistered kinds pass through
        untouched (single-version kinds need no scheme)."""
        scheme = self.lookup(resource.kind)
        if scheme is None:
            return resource
        return scheme.to_storage(resource)

    def convert(self, resource: Resource, target: str) -> Resource:
        scheme = self.lookup(resource.kind)
        if scheme is None:
            raise ConversionError(f"{resource.kind}: no versions registered")
        return scheme.convert(resource, target)


# The process-wide registry, mirrored by the apiserver facade. Tests may
# build private registries; controllers always see storage-version specs.
registry = ConversionRegistry()


# ---------------------------------------------------------------------------
# Notebook: the platform's three-version CRD (reference parity with
# notebook-controller's v1alpha1/v1beta1/v1 set).
#
# v1 (hub)     — pod-template-shaped spec: image, env (EnvVar list),
#                resources {requests,limits}, volumeMounts, volumes,
#                tolerations, affinity, nodeSelector, podLabels.
# v1beta1      — same shape minus scheduling (tolerations/affinity/
#                nodeSelector/podLabels), which down-convert to the stash.
# v1alpha1     — original flat form: containerImage, cpu, memory,
#                tpuChips (the accelerator limit), env as a {name: value}
#                map.
# ---------------------------------------------------------------------------

_TPU_RESOURCE = ACCELERATOR_RESOURCE

_V1_FIELDS = (
    "image",
    "env",
    "resources",
    "volumeMounts",
    "volumes",
    "tolerations",
    "affinity",
    "nodeSelector",
    "podLabels",
)
_V1BETA1_FIELDS = ("image", "env", "resources", "volumeMounts", "volumes")


def _split_fields(
    hub: dict, supported: tuple[str, ...]
) -> tuple[dict, dict]:
    kept = {k: copy.deepcopy(v) for k, v in hub.items() if k in supported}
    dropped = {
        k: copy.deepcopy(v) for k, v in hub.items() if k not in supported
    }
    return kept, dropped


def _notebook_v1beta1_from_hub(hub: dict) -> tuple[dict, dict]:
    return _split_fields(hub, _V1BETA1_FIELDS)


def _notebook_v1alpha1_to_hub(spec: dict) -> dict:
    hub: dict[str, Any] = {}
    if spec.get("containerImage"):
        hub["image"] = spec["containerImage"]
    env = spec.get("env") or {}
    if env:
        hub["env"] = [
            {"name": k, "value": env[k]} for k in sorted(env)
        ]
    requests = {}
    for key in ("cpu", "memory"):
        if spec.get(key):
            requests[key] = spec[key]
    resources: dict[str, Any] = {}
    if requests:
        resources["requests"] = requests
    chips = spec.get("tpuChips")
    if chips:
        resources["limits"] = {_TPU_RESOURCE: chips}
    if resources:
        hub["resources"] = resources
    return hub


def _notebook_v1alpha1_from_hub(hub: dict) -> tuple[dict, dict]:
    spec: dict[str, Any] = {}
    dropped: dict[str, Any] = {}
    if hub.get("image"):
        spec["containerImage"] = hub["image"]
    env_map: dict[str, Any] = {}
    env_rest = []
    for entry in hub.get("env") or []:
        if set(entry) <= {"name", "value"} and "name" in entry:
            env_map[entry["name"]] = entry.get("value", "")
        else:
            env_rest.append(copy.deepcopy(entry))  # valueFrom etc.
    if env_map:
        spec["env"] = env_map
    if env_rest:
        dropped["env"] = env_rest
    resources = hub.get("resources") or {}
    requests = dict(resources.get("requests") or {})
    for key in ("cpu", "memory"):
        if key in requests:
            spec[key] = requests.pop(key)
    limits = dict(resources.get("limits") or {})
    if _TPU_RESOURCE in limits:
        spec["tpuChips"] = limits.pop(_TPU_RESOURCE)
    leftover_resources = {}
    if requests:
        leftover_resources["requests"] = requests
    if limits:
        leftover_resources["limits"] = limits
    if leftover_resources:
        dropped["resources"] = leftover_resources
    for key, value in hub.items():
        if key not in ("image", "env", "resources"):
            dropped[key] = copy.deepcopy(value)
    return spec, dropped


NOTEBOOK_SCHEME = registry.register(
    VersionedKind(
        kind="Notebook",
        versions=(
            Version(
                "v1alpha1",
                to_hub=_notebook_v1alpha1_to_hub,
                from_hub=_notebook_v1alpha1_from_hub,
            ),
            Version("v1beta1", from_hub=_notebook_v1beta1_from_hub),
            Version("v1"),
        ),
        storage="v1",
    )
)
