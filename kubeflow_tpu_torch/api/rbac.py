"""RBAC model and SubjectAccessReview evaluation over the API server.

A copy of `kubeflow_tpu/api/rbac.py` (a module with no JAX in it), whole.
The reference's web tier authorizes every request with a K8s
SubjectAccessReview, which the real API server answers by walking
(Cluster)RoleBindings. The in-process store keeps the same objects (Role,
ClusterRole, RoleBinding, ClusterRoleBinding as plain Resources), so a
review is answered here with the standard match rules: a binding's
subjects name the user, its roleRef names a role, and a rule allows
(verb, resource) with ``*`` wildcards.

Role/ClusterRole spec: ``{"rules": [{"verbs": [...], "resources":
[...]}]}``. Binding spec: ``{"roleRef": {"kind": ..., "name": ...},
"subjects": [{"kind": "User", "name": ...}]}``. `api` is anything with
the store's get/list/create surface.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api.objects import Resource, new_resource

CLUSTER_ADMIN_ROLE = "kubeflow-admin"
EDIT_ROLE = "kubeflow-edit"
VIEW_ROLE = "kubeflow-view"

_VIEW_VERBS = ["get", "list", "watch"]
_EDIT_VERBS = _VIEW_VERBS + ["create", "update", "patch", "delete"]

# Privilege-escalation guard: a `resources: ["*"]` wildcard never matches
# the RBAC objects themselves — for ANY verb, reads included; access to
# them must be granted by NAME. Writes are the actual escalation vector
# (an edit-bound identity POSTing a ClusterRoleBinding onto
# cluster-admin); reads are excluded too because the real K8s built-in
# view/edit roles enumerate resources and omit RBAC kinds entirely, and
# policy objects shouldn't leak to every wildcard reader.
RBAC_RESOURCES = frozenset(
    {
        "roles", "rolebindings", "clusterroles", "clusterrolebindings",
        # Webhook configs are the same escalation class as RBAC objects:
        # registering one injects a mutator into every future write of
        # the kinds it names (it could rewrite a later ClusterRoleBinding
        # cluster-wide). Wildcard rules must not reach them either.
        "webhookconfigurations",
    }
)


def seed_cluster_roles(api) -> None:
    """Install the platform ClusterRoles the controllers bind against
    (the reference ships these as kustomize RBAC manifests under
    `*/config/rbac/`; profile-controller binds `kubeflow-admin` at
    `profile_controller.go:218-239`). Only admin carries the explicit
    RBAC-resource rule (see RBAC_RESOURCES)."""
    roles = [
        (CLUSTER_ADMIN_ROLE, [
            {"verbs": ["*"], "resources": ["*"]},
            {"verbs": ["*"], "resources": sorted(RBAC_RESOURCES)},
        ]),
        (EDIT_ROLE, [{"verbs": _EDIT_VERBS, "resources": ["*"]}]),
        (VIEW_ROLE, [{"verbs": _VIEW_VERBS, "resources": ["*"]}]),
    ]
    for name, rules in roles:
        try:
            api.get("ClusterRole", name, "")
        except Exception:
            api.create(
                new_resource("ClusterRole", name, "", spec={"rules": rules})
            )


def resource_for_kind(kind: str) -> str:
    """The RBAC resource string for a stored kind — lowercase plural, the
    way the reference's rules name resources (`notebooks`, `profiles`;
    e.g. `notebook-controller/config/rbac/role.yaml`). English
    pluralization: consonant+y → ies (`Study` → `studies`), vowel+y → +s
    (`Gateway` → `gateways`), trailing s → +es."""
    lower = kind.lower()
    if lower.endswith("y") and lower[-2:-1] not in "aeiou":
        return lower[:-1] + "ies"
    if lower.endswith("s"):
        return lower + "es"
    return lower + "s"


def make_cluster_role(name: str, rules: list[dict]) -> Resource:
    """A ClusterRole from raw rules (`{"verbs": [...], "resources":
    [...]}` — the shape `seed_cluster_roles` installs)."""
    return new_resource("ClusterRole", name, "", spec={"rules": rules})


def make_cluster_role_binding(name: str, role: str, user: str) -> Resource:
    return new_resource(
        "ClusterRoleBinding",
        name,
        "",
        spec={
            "roleRef": {"kind": "ClusterRole", "name": role},
            "subjects": [{"kind": "User", "name": user}],
        },
    )


def _rule_allows(rule: dict, verb: str, resource: str) -> bool:
    verbs = rule.get("verbs", [])
    resources = rule.get("resources", [])
    if "*" not in verbs and verb not in verbs:
        return False
    if resource in resources:
        return True
    # The wildcard does not reach RBAC objects (escalation guard) —
    # matched on the BASE resource so subresources (clusterroles/status)
    # don't slip through.
    base = resource.split("/", 1)[0]
    return "*" in resources and base not in RBAC_RESOURCES


def _role_allows(role: Resource | None, verb: str, resource: str) -> bool:
    if role is None:
        return False
    return any(
        _rule_allows(rule, verb, resource)
        for rule in role.spec.get("rules", [])
    )


def _binds_user(binding: Resource, user: str) -> bool:
    return any(
        s.get("kind", "User") in ("User", "ServiceAccount")
        and s.get("name") == user
        for s in binding.spec.get("subjects", [])
    )


def _resolve_role(
    api, role_ref: dict, namespace: str
) -> Resource | None:
    kind = role_ref.get("kind", "ClusterRole")
    name = role_ref.get("name", "")
    try:
        if kind == "ClusterRole":
            return api.get("ClusterRole", name, "")
        return api.get("Role", name, namespace)
    except Exception:
        return None


def subject_access_review(
    api,
    user: str,
    verb: str,
    resource: str,
    namespace: str = "",
) -> bool:
    """Answer: may `user` perform `verb` on `resource` in `namespace`?

    ClusterRoleBindings grant cluster-wide; RoleBindings grant inside their
    own namespace (and may reference a ClusterRole, which is how the
    reference's per-namespace `namespaceAdmin` binding to the
    `kubeflow-admin` ClusterRole works)."""
    for crb in api.list("ClusterRoleBinding", ""):
        if _binds_user(crb, user) and _role_allows(
            _resolve_role(api, crb.spec.get("roleRef", {}), ""),
            verb,
            resource,
        ):
            return True
    if namespace:
        for rb in api.list("RoleBinding", namespace):
            if _binds_user(rb, user) and _role_allows(
                _resolve_role(api, rb.spec.get("roleRef", {}), namespace),
                verb,
                resource,
            ):
                return True
    return False


def is_cluster_admin(api, user: str) -> bool:
    """kfam's QueryClusterAdmin check (`kfam/api_default.go:270-292`)."""
    return subject_access_review(api, user, "*", "*", "")


def namespaces_for(api, user: str) -> list[str]:
    """Namespaces where the user can list pods — the dashboard's
    namespace-selector population (`api_workgroup.ts:249-338` derives the
    same from kfam bindings)."""
    out = []
    for ns in api.list("Namespace", ""):
        name = ns.metadata.name
        if subject_access_review(api, user, "list", "pods", name):
            out.append(name)
    return out
