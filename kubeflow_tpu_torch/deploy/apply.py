"""Two-phase platform apply — the kfctl coordinator analog.

Counterpart of `kubeflow_tpu/deploy/apply.py`, whole, its imports
pointed at the port (the RBAC seed is `api/rbac.py`'s). One addition:
`apply_platform`'s ``between_phases`` hook, called once the PLATFORM
phase succeeded and before the K8S phase begins (the deploy worker's
kill drill holds there).

`handleDeployment` in the reference (`kfctlServer.go:105-294`) is the
whole deploy path: write the KfDef, `Apply(PLATFORM)` (cloud infra),
build cluster config, then `Apply(K8S)` retried ×3 — with degradation
surfaced as KfAvailable/KfDegraded conditions (:318-327). Same contract
here, cloud-agnostic through `CloudProvider`:

- PLATFORM: ensure every GPU node pool (retried — cloud APIs flake);
- K8S: apply every bundle resource (retried; `api.apply` is
  create-or-update so a second apply is a no-op — the reference tests
  this exact property in `kfctl_second_apply.py`);
- a `PlatformDeployment` resource records phase + conditions, which the
  deploy server surfaces over HTTP.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import (
    make_cluster_role_binding,
    seed_cluster_roles,
)
from kubeflow_tpu_torch.deploy.bundles import bundle_resources
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import CloudProvider
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    FakeApiServer,
    NotFound,
)

log = logging.getLogger(__name__)

RETRIES = 3  # kfctlServer.go:290-294
CONDITION_AVAILABLE = "KfAvailable"
CONDITION_DEGRADED = "KfDegraded"


@dataclasses.dataclass
class ApplyResult:
    name: str
    succeeded: bool
    platform_applied: bool
    k8s_applied: bool
    applied_count: int = 0
    error: str | None = None


def _retry(fn, *, what: str, retries: int = RETRIES, backoff: float = 0.0):
    last: Exception | None = None
    for attempt in range(1, retries + 1):
        try:
            return fn()
        except Exception as e:  # cloud/apiserver boundary — retry all
            last = e
            log.warning("%s failed (attempt %d/%d): %s", what, attempt, retries, e)
            if backoff:
                time.sleep(backoff * attempt)
    raise last  # type: ignore[misc]


def retry_rmw(
    api,
    kind: str,
    name: str,
    namespace: str,
    mutate,
    write,
    *,
    factory=None,
    attempts: int = 10,
) -> None:
    """Read-modify-write with optimistic-concurrency retry — THE pattern
    for multi-writer CRs (the deploy server, its worker processes, and
    the apply loop all race on PlatformDeployment; each must preserve
    fields the others own). `mutate(obj)` edits in place, `write(obj)`
    commits (update or update_status); `factory()` (optional) supplies
    the object when it doesn't exist yet, tolerating the create/create
    race the same way."""
    from kubeflow_tpu_torch.testing.fake_apiserver import AlreadyExists, Conflict

    for _ in range(attempts):
        try:
            obj = api.get(kind, name, namespace).thaw()
        except NotFound:
            if factory is None:
                raise
            try:
                obj = api.create(factory()).thaw()
            except AlreadyExists:
                continue  # lost a create/create race — re-read
        mutate(obj)
        try:
            write(obj)
            return
        except Conflict:
            continue
    raise Conflict(
        f"could not write {kind} {name!r} after {attempts} attempts"
    )


def _set_status(
    api: FakeApiServer, name: str, phase: str, conditions: list[dict]
) -> None:
    def mutate(dep):
        dep.status = {
            **dep.status, "phase": phase, "conditions": conditions,
        }

    retry_rmw(
        api, "PlatformDeployment", name, "", mutate, api.update_status,
        factory=lambda: new_resource("PlatformDeployment", name, ""),
    )


def apply_platform(
    spec: PlatformSpec,
    api: FakeApiServer,
    cloud: CloudProvider,
    *,
    retries: int = RETRIES,
    between_phases: Callable[[], None] | None = None,
) -> ApplyResult:
    result = ApplyResult(
        name=spec.name, succeeded=False, platform_applied=False, k8s_applied=False
    )
    _set_status(api, spec.name, "Pending", [])

    # -- Phase 1: PLATFORM (cloud infra; kfctlServer.go:219) ---------------
    try:
        # The cluster first (the reference's Deployment Manager step,
        # kfctlServer.go:268): pools attach to it.
        _retry(
            lambda: cloud.ensure_cluster(spec),
            what="ensure_cluster",
            retries=retries,
        )
        for pool in spec.node_pools:
            _retry(
                lambda pool=pool: cloud.ensure_node_pool(spec, pool),
                what=f"ensure_node_pool {pool.name}",
                retries=retries,
            )
        result.platform_applied = True
    except Exception as e:
        result.error = f"PLATFORM phase: {e}"
        _set_status(
            api,
            spec.name,
            "Failed",
            [{"type": CONDITION_DEGRADED, "message": result.error}],
        )
        return result

    if between_phases is not None:
        between_phases()

    # -- Phase 2: K8S (manifests; kfctlServer.go:285-294) ------------------
    try:
        resources = bundle_resources(spec)

        def apply_all():
            count = 0
            for res in resources:
                api.apply(res.deepcopy())
                count += 1
            return count

        result.applied_count = _retry(
            apply_all, what="k8s apply", retries=retries
        )
        # RBAC seed + platform admin — the IAM-binding step of the
        # reference's GCP phase, expressed as cluster RBAC.
        seed_cluster_roles(api)
        if spec.email:
            try:
                api.create(
                    make_cluster_role_binding(
                        f"{spec.name}-admin", "kubeflow-admin", spec.email
                    )
                )
            except AlreadyExists:
                pass  # second apply; anything else must fail the phase
        result.k8s_applied = True
    except Exception as e:
        result.error = f"K8S phase: {e}"
        _set_status(
            api,
            spec.name,
            "Failed",
            [{"type": CONDITION_DEGRADED, "message": result.error}],
        )
        return result

    result.succeeded = True
    _set_status(
        api,
        spec.name,
        "Ready",
        [{"type": CONDITION_AVAILABLE, "message": "deployed"}],
    )
    return result


def delete_platform(
    spec: PlatformSpec, api: FakeApiServer, cloud: CloudProvider
) -> None:
    """Teardown (`kfctl_delete_test.py` analog): bundle resources first,
    then the node pools, then the status object."""
    for res in bundle_resources(spec):
        try:
            api.delete(res.kind, res.metadata.name, res.metadata.namespace)
        except NotFound:
            pass
    for pool in spec.node_pools:
        cloud.delete_node_pool(spec, pool.name)
    try:
        api.delete("PlatformDeployment", spec.name, "")
    except NotFound:
        pass
