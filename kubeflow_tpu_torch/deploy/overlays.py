"""Overlay engine: kustomize-style customization of bundle resources.

Counterpart of `kubeflow_tpu/deploy/overlays.py`, whole, its imports
pointed at the port.

The reference ships every component as a kustomize base plus overlays
(`*/config/{default,overlays}` throughout `components/`, applied by the
kfctl K8S phase). Here bundles are generated programmatically, so an
overlay is data applied on top of the generated resources — the same
customization surface as a kustomization.yaml:

    namePrefix: dev-
    namespace: kubeflow-dev
    commonLabels: {env: dev}
    images:
      - name: kubeflow-tpu/jupyter-web-app
        newTag: v2.0.0
    patches:
      - target: {kind: Deployment, name: jupyter-web-app}
        patch:
          spec:
            replicas: 2

Patches use strategic-merge semantics: dicts merge recursively, a list
of named objects (e.g. a container list) merges entry-wise by `name`,
any other list replaces wholesale, and an explicit null deletes the key
(the `$patch: delete` analog).

Overlays ride the PlatformSpec (`spec.overlays`, applied in order by the
K8S phase). JAX's CI tool that renders them standalone
(`kubeflow_tpu/ci/application_util.py`) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses
import fnmatch
import pathlib
from typing import Any

import yaml

from kubeflow_tpu_torch.api.objects import Resource


def strategic_merge(base: Any, patch: Any) -> Any:
    """K8s strategic-merge-patch core semantics on plain data."""
    if isinstance(base, dict) and isinstance(patch, dict):
        out = copy.deepcopy(base)
        for key, value in patch.items():
            if value is None:
                out.pop(key, None)
            elif key in out:
                out[key] = strategic_merge(out[key], value)
            else:
                out[key] = copy.deepcopy(value)
        return out
    if isinstance(base, list) and isinstance(patch, list):
        if _named_list(base) and _named_list(patch):
            out = [copy.deepcopy(item) for item in base]
            index = {item["name"]: i for i, item in enumerate(out)}
            for item in patch:
                if item["name"] in index:
                    out[index[item["name"]]] = strategic_merge(
                        out[index[item["name"]]], item
                    )
                else:
                    out.append(copy.deepcopy(item))
            return out
        return copy.deepcopy(patch)
    return copy.deepcopy(patch)


def _named_list(items: list) -> bool:
    return bool(items) and all(
        isinstance(item, dict) and "name" in item for item in items
    )


@dataclasses.dataclass(frozen=True)
class ImageRule:
    name: str  # repo to match (everything before the tag/digest)
    new_name: str | None = None
    new_tag: str | None = None

    def rewrite(self, ref: str) -> str:
        repo, sep, tail = split_image(ref)
        if repo != self.name:
            return ref
        repo = self.new_name or repo
        if self.new_tag is not None:
            return f"{repo}:{self.new_tag}"
        return f"{repo}{sep}{tail}"


@dataclasses.dataclass(frozen=True)
class Patch:
    target_kind: str | None = None  # None = any; fnmatch patterns allowed
    target_name: str | None = None
    patch: dict = dataclasses.field(default_factory=dict)

    def matches(self, res: Resource) -> bool:
        if self.target_kind and not fnmatch.fnmatch(res.kind, self.target_kind):
            return False
        if self.target_name and not fnmatch.fnmatch(
            res.metadata.name, self.target_name
        ):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class Overlay:
    name: str = "overlay"
    name_prefix: str = ""
    namespace: str | None = None
    common_labels: dict[str, str] = dataclasses.field(default_factory=dict)
    images: tuple[ImageRule, ...] = ()
    patches: tuple[Patch, ...] = ()

    KEYS = ("name", "namePrefix", "namespace", "commonLabels", "images",
            "patches")
    IMAGE_KEYS = ("name", "newName", "newTag")
    PATCH_KEYS = ("target", "patch")
    TARGET_KEYS = ("kind", "name")

    @staticmethod
    def _check_keys(d: dict, valid: tuple[str, ...], where: str) -> None:
        unknown = set(d) - set(valid)
        if unknown:
            # A typo'd key must fail loudly, not silently apply nothing —
            # at every nesting level, not just the top.
            raise ValueError(
                f"unknown {where} keys {sorted(unknown)}; "
                f"valid: {list(valid)}"
            )

    @classmethod
    def from_dict(cls, d: dict) -> "Overlay":
        cls._check_keys(d, cls.KEYS, "overlay")
        for i in d.get("images") or ():
            cls._check_keys(i, cls.IMAGE_KEYS, "image-rule")
        for p in d.get("patches") or ():
            cls._check_keys(p, cls.PATCH_KEYS, "patch")
            cls._check_keys(p.get("target") or {}, cls.TARGET_KEYS,
                            "patch target")
        return cls(
            name=d.get("name", "overlay"),
            name_prefix=d.get("namePrefix", ""),
            namespace=d.get("namespace"),
            common_labels=dict(d.get("commonLabels") or {}),
            images=tuple(
                ImageRule(
                    name=i["name"],
                    new_name=i.get("newName"),
                    new_tag=_tag_str(i.get("newTag")),
                )
                for i in d.get("images") or ()
            ),
            patches=tuple(
                Patch(
                    target_kind=(p.get("target") or {}).get("kind"),
                    target_name=(p.get("target") or {}).get("name"),
                    patch=dict(p.get("patch") or {}),
                )
                for p in d.get("patches") or ()
            ),
        )

    @classmethod
    def from_yaml(cls, text: str) -> "Overlay":
        data = yaml.safe_load(text) or {}
        if not isinstance(data, dict):
            raise ValueError("overlay YAML must be a mapping")
        return cls.from_dict(data)

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "Overlay":
        path = pathlib.Path(path)
        overlay = cls.from_yaml(path.read_text())
        if overlay.name == "overlay":
            overlay = dataclasses.replace(overlay, name=path.stem)
        return overlay


def _tag_str(tag) -> str | None:
    return None if tag is None else str(tag)


def split_image(ref: str) -> tuple[str, str, str]:
    """(repo, separator, tag-or-digest) — digest- and registry-port-aware
    (`localhost:5000/app:v1` splits at the LAST colon only if the tail has
    no '/'; `repo@sha256:...` splits at the '@')."""
    if "@" in ref:
        repo, _, digest = ref.partition("@")
        return repo, "@", digest
    repo, sep, tail = ref.rpartition(":")
    if not sep or "/" in tail:
        return ref, "", ""
    return repo, sep, tail


def _rewrite_images(node: Any, rules: tuple[ImageRule, ...]) -> Any:
    if isinstance(node, dict):
        out = {}
        for key, value in node.items():
            if key == "image" and isinstance(value, str):
                for rule in rules:
                    value = rule.rewrite(value)
            else:
                value = _rewrite_images(value, rules)
            out[key] = value
        return out
    if isinstance(node, list):
        return [_rewrite_images(item, rules) for item in node]
    return node


_WORKLOAD_KINDS = ("Deployment", "StatefulSet")
# Kinds whose specs carry cross-resource references that the rename pass
# must fix up (VirtualService route hosts / gateway refs).
_REFERRER_KINDS = ("VirtualService",)


def _relabel(res: Resource, labels: dict[str, str]) -> None:
    """kustomize commonLabels semantics: metadata, and for workloads the
    pod template and selector too (so the labels actually reach pods)."""
    res.metadata.labels.update(labels)
    if res.kind not in _WORKLOAD_KINDS:
        return
    template = res.spec.setdefault("template", {})
    template.setdefault("metadata", {}).setdefault("labels", {}).update(
        labels
    )
    selector = res.spec.setdefault("selector", {})
    selector.setdefault("matchLabels", {}).update(labels)


def _rewrite_strings(node: Any, table: dict[str, str]) -> Any:
    if isinstance(node, dict):
        return {k: _rewrite_strings(v, table) for k, v in node.items()}
    if isinstance(node, list):
        return [_rewrite_strings(item, table) for item in node]
    if isinstance(node, str):
        for old, new in table.items():
            node = node.replace(old, new)
    return node


def apply_overlay(
    resources: list[Resource], overlay: Overlay
) -> list[Resource]:
    """A new resource list with the overlay applied (inputs untouched).

    Transformer order follows kustomize: patches, then image rewrites
    (so images a patch introduces are still pinned), then the rename
    pass (prefix/namespace/labels) with name-reference fixups — route
    hosts like `<svc>.<ns>.svc...` and `<ns>/<gateway>` refs inside
    VirtualServices track the renamed Services/Gateways/namespace.
    """
    out = []
    renames: dict[str, str] = {}
    for res in resources:
        res = res.deepcopy()
        for patch in overlay.patches:
            if patch.matches(res):
                # Whole-object patch (metadata and spec both reachable),
                # like a kustomize patchesStrategicMerge entry.
                res = Resource.from_dict(
                    strategic_merge(res.to_dict(), patch.patch)
                )
        if overlay.images:
            res.spec = _rewrite_images(res.spec, overlay.images)

        old_name, old_ns = res.metadata.name, res.metadata.namespace
        if res.kind == "Namespace" and overlay.namespace is not None:
            # kustomize's namespace transformer: the Namespace resource
            # itself becomes the target namespace (prefix not applied).
            res.metadata.name = overlay.namespace
        elif overlay.name_prefix:
            res.metadata.name = overlay.name_prefix + res.metadata.name
        if overlay.namespace is not None and res.metadata.namespace:
            # Cluster-scoped resources (namespace "") keep their scope.
            res.metadata.namespace = overlay.namespace
        _relabel(res, overlay.common_labels)

        if res.kind in ("Service", "Gateway"):
            renames[f"{old_name}.{old_ns}.svc"] = (
                f"{res.metadata.name}.{res.metadata.namespace}.svc"
            )
            renames[f"{old_ns}/{old_name}"] = (
                f"{res.metadata.namespace}/{res.metadata.name}"
            )
        out.append(res)

    if renames:
        for res in out:
            if res.kind in _REFERRER_KINDS:
                res.spec = _rewrite_strings(res.spec, renames)
    return out


def apply_overlays(
    resources: list[Resource], overlays: list[Overlay]
) -> list[Resource]:
    for overlay in overlays:
        resources = apply_overlay(resources, overlay)
    return resources
