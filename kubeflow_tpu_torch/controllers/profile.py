"""Profile controller: a user's Profile becomes a tenant namespace.

Counterpart of `kubeflow_tpu/controllers/profile.py`, whole. A Profile
CR owns a Namespace and the identity scaffolding inside it:

- the Namespace, labelled for istio injection and annotated with its
  owner, and never taken over when one of that name exists with another
  owner (a `NamespaceConflict` Warning, condition Failed, a 30 s
  requeue);
- the `default-editor` / `default-viewer` ServiceAccounts;
- the `namespaceAdmin` RoleBinding for the owner;
- the `ns-owner` AuthorizationPolicy for the owner's traffic;
- `kf-resource-quota` from `resourceQuotaSpec`, passed through as
  written: a tenant's `nvidia.com/gpu` cap is what the port's quota
  (`controllers/quota.py`) meters;
- a plugin seam (`apply`/`revoke`; an unknown kind is an `UnknownPlugin`
  Warning), with the finalizer revoking on delete. The cloud IAM
  plugins, `WorkloadIdentityPlugin` and `AwsIamPlugin`, are in
  `controllers/cloud_iam.py`; the binary passes none, as JAX's passes
  none.

Deleting the Profile clears the finalizer; the store then removes it,
and the cascade removes the Namespace, whose drain removes everything
in it.
"""

from __future__ import annotations

import logging
from typing import Protocol

from kubeflow_tpu_torch.api.objects import Resource, new_resource, owner_ref
from kubeflow_tpu_torch.controllers.runtime import Controller, Key, Result
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)

KIND = "Profile"
OWNER_ANNOTATION = "owner"
FINALIZER = "profile-finalizer.kubeflow-tpu.org"
EDITOR_SA = "default-editor"
VIEWER_SA = "default-viewer"


class Plugin(Protocol):
    """Cloud-credential plumbing seam."""

    name: str

    def apply(self, api: FakeApiServer, profile: Resource) -> None: ...

    def revoke(self, api: FakeApiServer, profile: Resource) -> None: ...


class ProfileController:
    def __init__(
        self,
        api: FakeApiServer,
        plugins: dict[str, Plugin] | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        self.api = api
        self.plugins = dict(plugins or {})
        metrics = metrics or MetricsRegistry()
        self.requests = metrics.counter("profile_request_kf", "reconciles")
        self.failures = metrics.counter(
            "profile_request_kf_failure", "failed reconciles", ("severity",)
        )
        self.controller = Controller(
            api,
            KIND,
            self.reconcile,
            owns=("Namespace",),
            name="profile-controller",
            metrics=metrics,
        )

    def reconcile(self, api: FakeApiServer, key: Key) -> Result:
        obj_ns, name = key
        self.requests.inc()
        try:
            profile = api.get(KIND, name, obj_ns)
        except NotFound:
            return Result()

        if profile.metadata.deletion_timestamp is not None:
            return self._finalize(api, profile)

        if FINALIZER not in profile.metadata.finalizers:
            profile = profile.thaw()
            profile.metadata.finalizers.append(FINALIZER)
            profile = api.update(profile)

        owner = profile.spec.get("owner", {})
        owner_name = owner.get("name", "")

        # The Namespace: created owned, or checked for its owner (no
        # takeover).
        ns_name = name
        try:
            ns = api.get("Namespace", ns_name, "")
            existing_owner = ns.metadata.annotations.get(OWNER_ANNOTATION)
            if OWNER_ANNOTATION not in ns.metadata.annotations or (
                existing_owner != owner_name
            ):
                self.failures.inc(severity="takeover")
                api.record_event(
                    profile,
                    "NamespaceConflict",
                    f"namespace {ns_name} exists and is not owned by {owner_name!r}",
                    type_="Warning",
                )
                # The conflicting namespace has no ownerReference to the
                # Profile, so no watch fires when an admin removes it: a
                # periodic requeue is how this heals.
                self._set_condition(api, profile, "Failed")
                return Result(requeue_after=30.0)
        except NotFound:
            ns = new_resource(
                "Namespace",
                ns_name,
                "",
                labels={
                    "istio-injection": "enabled",
                    "app.kubernetes.io/part-of": "kubeflow-tpu",
                },
                annotations={OWNER_ANNOTATION: owner_name},
            )
            ns.metadata.owner_references = [owner_ref(profile)]
            ns = api.create(ns)

        for sa in (EDITOR_SA, VIEWER_SA):
            api.apply(new_resource("ServiceAccount", sa, ns_name))

        rb = new_resource(
            "RoleBinding",
            "namespaceAdmin",
            ns_name,
            spec={
                "roleRef": {"kind": "ClusterRole", "name": "kubeflow-admin"},
                "subjects": [owner] if owner else [],
            },
        )
        api.apply(rb)

        # The mesh policy for the owner, made with the namespace: RBAC
        # alone would let the owner act while the mesh denied their
        # traffic.
        if owner_name:
            ap = new_resource(
                "AuthorizationPolicy",
                "ns-owner",
                ns_name,
                annotations={
                    "manager": "profile-controller",
                    "user": owner_name,
                    "role": "admin",
                },
                spec={
                    "action": "ALLOW",
                    "rules": [{"from": [{"source": {"principals": [owner_name]}}]}],
                },
            )
            ap.metadata.owner_references = [owner_ref(ns, controller=False)]
            api.apply(ap)

        quota = profile.spec.get("resourceQuotaSpec")
        if quota:
            api.apply(new_resource("ResourceQuota", "kf-resource-quota", ns_name, spec=quota))

        for plugin_spec in profile.spec.get("plugins", []):
            plugin = self.plugins.get(plugin_spec.get("kind", ""))
            if plugin is None:
                self.failures.inc(severity="unknown_plugin")
                api.record_event(
                    profile,
                    "UnknownPlugin",
                    f"no plugin registered for {plugin_spec.get('kind')!r}",
                    type_="Warning",
                )
                continue
            plugin.apply(api, profile)

        return self._set_condition(api, profile, "Ready")

    def _finalize(self, api: FakeApiServer, profile: Resource) -> Result:
        for plugin_spec in profile.spec.get("plugins", []):
            plugin = self.plugins.get(plugin_spec.get("kind", ""))
            if plugin is not None:
                plugin.revoke(api, profile)
        if FINALIZER in profile.metadata.finalizers:
            profile = profile.thaw()
            profile.metadata.finalizers.remove(FINALIZER)
            api.update(profile)  # the store finalizes; the namespace cascades
        return Result()

    def _set_condition(self, api: FakeApiServer, profile: Resource, cond: str) -> Result:
        fresh = api.get(KIND, profile.metadata.name, profile.metadata.namespace)
        if fresh.status.get("condition") != cond:
            fresh = fresh.thaw()
            fresh.status["condition"] = cond
            api.update_status(fresh)
        return Result()
