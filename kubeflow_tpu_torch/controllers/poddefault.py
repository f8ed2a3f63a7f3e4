"""PodDefault mutating admission: label-matched pod defaults injection.

A copy of `kubeflow_tpu/controllers/poddefault.py` (a module with no JAX
in it), whole.

Parity with the reference's admission webhook (SURVEY.md §2 item 9,
`admission-webhook/main.go`): on pod create, select `PodDefault` CRs in the
pod's namespace whose label selector matches the pod
(`filterPodDefaults` :69), check that applying them all is conflict-free
(`safeToApplyPodDefaultsOnPod` :98), then inject env, volumes,
volumeMounts, tolerations, annotations and labels
(`applyPodDefaultsOnPod` :371). Conflicts reject nothing silently: the
pod is admitted unmodified, with the conflict recorded (upstream logs and
skips, main.go:473-492).

Use `register(api)` to hook it into a FakeApiServer as the webhook
boundary, or call `mutate_pod` directly from a real admission endpoint.
"""

from __future__ import annotations

import logging

from kubeflow_tpu_torch.api.objects import Resource
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

log = logging.getLogger(__name__)

KIND = "PodDefault"


def _selector_matches(selector: dict, labels: dict[str, str]) -> bool:
    return all(
        labels.get(k) == v
        for k, v in (selector.get("matchLabels") or {}).items()
    )


def filter_pod_defaults(
    pod: Resource, defaults: list[Resource]
) -> list[Resource]:
    return [
        d
        for d in defaults
        if _selector_matches(d.spec.get("selector", {}), pod.metadata.labels)
    ]


def find_conflicts(defaults: list[Resource]) -> list[str]:
    """Two PodDefaults that set the same env var / volume / mount path to
    different values conflict (safeToApplyPodDefaultsOnPod :98)."""
    conflicts = []
    env_seen: dict[str, tuple[str, dict]] = {}
    vol_seen: dict[str, tuple[str, dict]] = {}
    mount_seen: dict[str, tuple[str, dict]] = {}
    for d in defaults:
        name = d.metadata.name
        for e in d.spec.get("env", []):
            # Compare the full EnvVar, not just .value — two valueFrom
            # sources for the same name are a conflict too.
            prev = env_seen.get(e["name"])
            if prev and prev[1] != e:
                conflicts.append(
                    f"env {e['name']!r} set by both {prev[0]!r} and {name!r}"
                )
            env_seen[e["name"]] = (name, e)
        for v in d.spec.get("volumes", []):
            prev = vol_seen.get(v["name"])
            if prev and prev[1] != v:
                conflicts.append(
                    f"volume {v['name']!r} conflicts between {prev[0]!r} "
                    f"and {name!r}"
                )
            vol_seen[v["name"]] = (name, v)
        for m in d.spec.get("volumeMounts", []):
            prev = mount_seen.get(m["mountPath"])
            if prev and prev[1] != m:
                conflicts.append(
                    f"mountPath {m['mountPath']!r} conflicts between "
                    f"{prev[0]!r} and {name!r}"
                )
            mount_seen[m["mountPath"]] = (name, m)
    return conflicts


def apply_pod_defaults(pod: Resource, defaults: list[Resource]) -> Resource:
    """Inject matched defaults into every container (applyPodDefaults :371).
    Existing pod values win over defaults."""
    spec = pod.spec
    for d in defaults:
        for container in spec.get("containers", []):
            env = container.setdefault("env", [])
            have = {e["name"] for e in env}
            env.extend(
                e for e in d.spec.get("env", []) if e["name"] not in have
            )
            mounts = container.setdefault("volumeMounts", [])
            have_paths = {m["mountPath"] for m in mounts}
            mounts.extend(
                m
                for m in d.spec.get("volumeMounts", [])
                if m["mountPath"] not in have_paths
            )
        vols = spec.setdefault("volumes", [])
        have_vols = {v["name"] for v in vols}
        vols.extend(
            v for v in d.spec.get("volumes", []) if v["name"] not in have_vols
        )
        tols = spec.setdefault("tolerations", [])
        for t in d.spec.get("tolerations", []):
            if t not in tols:
                tols.append(t)
        for k, v in (d.spec.get("annotations") or {}).items():
            pod.metadata.annotations.setdefault(k, v)
        for k, v in (d.spec.get("labels") or {}).items():
            pod.metadata.labels.setdefault(k, v)
        pod.metadata.annotations[
            f"poddefault.kubeflow-tpu.org/{d.metadata.name}"
        ] = "applied"
    return pod


def mutate_pod(api: FakeApiServer, pod: Resource) -> Resource:
    defaults = api.list(KIND, pod.metadata.namespace)
    matched = filter_pod_defaults(pod, defaults)
    if not matched:
        return pod
    conflicts = find_conflicts(matched)
    if conflicts:
        log.warning(
            "pod %s/%s: conflicting PodDefaults, skipping injection: %s",
            pod.metadata.namespace, pod.metadata.name, "; ".join(conflicts),
        )
        pod.metadata.annotations["poddefault.kubeflow-tpu.org/conflict"] = (
            "; ".join(conflicts)
        )
        return pod
    return apply_pod_defaults(pod, matched)


def register(api: FakeApiServer) -> None:
    api.register_admission(lambda pod: mutate_pod(api, pod), kind="Pod")
