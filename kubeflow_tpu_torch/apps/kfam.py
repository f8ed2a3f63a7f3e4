"""Access management API ("kfam"): profiles and contributor bindings.

A copy of `kubeflow_tpu/apps/kfam.py` (a module with no JAX in it),
whole. The AuthorizationPolicy a binding writes is the mesh half of the
pair, which the apps' second gate evaluates (`web/authz.py`,
`web/mesh.py`).

Parity with `components/access-management/` (SURVEY.md §2 #10): a REST
service that owns the user→namespace mapping.

- POST/DELETE `/kfam/v1/profiles[/<name>]` create/delete Profile CRs
  (`kfam/api_default.go:123-176`, `kfam/profiles.go:38`);
- POST/DELETE/GET `/kfam/v1/bindings` manage *contributor* access: each
  binding materializes a RoleBinding + mesh-policy pair in the profile's
  namespace (`kfam/bindings.go:76-128` creates RoleBinding + Istio
  ServiceRoleBinding; our mesh analog is an AuthorizationPolicy resource);
- GET `/kfam/v1/role/clusteradmin` answers the dashboard's admin probe
  (`api_default.go:270`).

AuthZ: profile owner or cluster-admin (`api_default.go:282-292`).
"""

from __future__ import annotations

import hashlib

from kubeflow_tpu_torch.api.objects import new_resource, owner_ref
from kubeflow_tpu_torch.api.rbac import is_cluster_admin
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import (
    App,
    Forbidden,
    HeaderAuthn,
    HttpError,
    Request,
    Response,
    json_response,
    success_response,
)

ROLE_TO_CLUSTER_ROLE = {
    # kfam only supports these contributor roles (bindings.go).
    "edit": "kubeflow-edit",
    "view": "kubeflow-view",
}

# Mesh operation scope per contributor role: the RBAC ClusterRole and the
# AuthorizationPolicy must agree, so a viewer is GET-only at BOTH gates
# (the reference's ServiceRole rules carry the same methods constraint,
# `servicerole_types.go:43-75`). None = all methods.
ROLE_MESH_METHODS = {
    "edit": None,
    "view": ["GET"],
}

BINDING_MANAGER = "kfam"


def _binding_name(user: str, role: str) -> str:
    # Deterministic, DNS-safe, collision-free name for the pair
    # (bindings.go derives `user-<hash>-clusterrole-<role>`; the hash is
    # load-bearing — slugs alone collide across users like `bob@x.co` vs
    # `bob.x.co`, silently replacing one contributor with another).
    digest = hashlib.sha1(user.encode()).hexdigest()[:8]
    slug = "".join(c if c.isalnum() else "-" for c in user.lower())
    return f"user-{slug}-{digest}-clusterrole-{role}"


class KfamApp(App):
    def __init__(
        self,
        api: FakeApiServer,
        *,
        authn: HeaderAuthn | None = None,
        metrics: MetricsRegistry | None = None,
    ):
        super().__init__("kfam")
        self.api = api
        metrics = metrics or MetricsRegistry()
        # kfam/monitoring.go parity: request counters by handler/outcome.
        self.requests = metrics.counter(
            "kfam_requests", "kfam API requests", ("handler",)
        )
        self.before_request(authn or HeaderAuthn())
        self.add_route("/kfam/v1/profiles", self.create_profile, ("POST",))
        self.add_route(
            "/kfam/v1/profiles/<name>", self.delete_profile, ("DELETE",)
        )
        self.add_route("/kfam/v1/bindings", self.read_bindings, ("GET",))
        self.add_route("/kfam/v1/bindings", self.create_binding, ("POST",))
        self.add_route("/kfam/v1/bindings", self.delete_binding, ("DELETE",))
        self.add_route(
            "/kfam/v1/role/clusteradmin", self.query_cluster_admin, ("GET",)
        )

    # -- authz helper ------------------------------------------------------

    def _ensure_owner_or_admin(self, user: str, profile_name: str) -> None:
        """api_default.go:282-292: only the profile's owner or a cluster
        admin may manage it."""
        if is_cluster_admin(self.api, user):
            return
        try:
            profile = self.api.get("Profile", profile_name, "default")
        except NotFound:
            raise HttpError(404, f"profile {profile_name!r} not found")
        owner = profile.spec.get("owner", {}).get("name")
        if owner != user:
            raise Forbidden(
                f"user {user!r} is neither owner of profile "
                f"{profile_name!r} nor cluster admin"
            )

    # -- handlers ----------------------------------------------------------

    def create_profile(self, req: Request) -> Response:
        self.requests.inc(handler="create_profile")
        body = req.json()
        name = (body.get("metadata") or {}).get("name") or body.get("name")
        if not name:
            raise HttpError(400, "profile needs metadata.name")
        owner = (body.get("spec") or {}).get("owner") or {
            "kind": "User",
            "name": req.user,
        }
        # Self-service: any authenticated user may create a profile they
        # own; creating for someone else requires admin (api_default.go
        # implicitly via dashboard registration flow).
        if owner.get("name") != req.user and not is_cluster_admin(
            self.api, req.user
        ):
            raise Forbidden(
                f"user {req.user!r} cannot create a profile owned by "
                f"{owner.get('name')!r}"
            )
        # Body spec first, validated owner last — a client-sent falsy/odd
        # `owner` must not win the spread past the authz check above.
        profile = new_resource(
            "Profile",
            name,
            "default",
            spec={**(body.get("spec") or {}), "owner": owner},
        )
        self.api.create(profile)
        return success_response("profile", profile.to_dict())

    def delete_profile(self, req: Request) -> Response:
        self.requests.inc(handler="delete_profile")
        name = req.path_params["name"]
        self._ensure_owner_or_admin(req.user, name)
        self.api.delete("Profile", name, "default")
        return success_response()

    def read_bindings(self, req: Request) -> Response:
        self.requests.inc(handler="read_bindings")
        namespace = req.query.get("namespace")
        user_filter = req.query.get("user")
        # AuthZ: a cluster admin sees everything; everyone else may only
        # enumerate their own bindings or a namespace they own — never the
        # cluster-wide user→namespace access map.
        if not is_cluster_admin(self.api, req.user):
            if namespace:
                self._ensure_owner_or_admin(req.user, namespace)
            elif user_filter == req.user:
                pass  # listing your own access is always fine
            else:
                raise Forbidden(
                    "non-admins must scope the query: ?namespace=<owned "
                    "profile> or ?user=<yourself>"
                )
        bindings = []
        for rb in self.api.list("RoleBinding", namespace):
            if rb.metadata.annotations.get("manager") != BINDING_MANAGER:
                continue
            for subject in rb.spec.get("subjects", []):
                if user_filter and subject.get("name") != user_filter:
                    continue
                bindings.append(
                    {
                        "user": subject,
                        "referredNamespace": rb.metadata.namespace,
                        "roleRef": rb.spec.get("roleRef", {}),
                    }
                )
        return json_response({"bindings": bindings})

    def _parse_binding(self, req: Request) -> tuple[str, str, str]:
        body = req.json()
        user = (body.get("user") or {}).get("name")
        namespace = body.get("referredNamespace")
        role = (body.get("roleRef") or {}).get("name", "edit")
        if not user or not namespace:
            raise HttpError(400, "binding needs user.name and referredNamespace")
        if role not in ROLE_TO_CLUSTER_ROLE:
            raise HttpError(
                400,
                f"unsupported role {role!r} (must be one of "
                f"{sorted(ROLE_TO_CLUSTER_ROLE)})",
            )
        return user, namespace, role

    def create_binding(self, req: Request) -> Response:
        """bindings.go:76-128: contributor gets a RoleBinding plus a mesh
        AuthorizationPolicy admitting their identity to the namespace."""
        self.requests.inc(handler="create_binding")
        user, namespace, role = self._parse_binding(req)
        self._ensure_owner_or_admin(req.user, namespace)
        # Owner-ref the pair to the Namespace: when the profile (and its
        # owned namespace) is deleted, contributor grants cascade away
        # instead of lying in wait for a same-named future profile.
        try:
            ns_obj = self.api.get("Namespace", namespace, "")
        except NotFound:
            raise HttpError(404, f"namespace {namespace!r} not found")
        name = _binding_name(user, role)
        rb = new_resource(
            "RoleBinding",
            name,
            namespace,
            annotations={"manager": BINDING_MANAGER, "user": user, "role": role},
            spec={
                "roleRef": {
                    "kind": "ClusterRole",
                    "name": ROLE_TO_CLUSTER_ROLE[role],
                },
                "subjects": [{"kind": "User", "name": user}],
            },
        )
        rb.metadata.owner_references = [owner_ref(ns_obj, controller=False)]
        self.api.apply(rb)
        rule: dict = {"from": [{"source": {"principals": [user]}}]}
        methods = ROLE_MESH_METHODS[role]
        if methods:
            rule["to"] = [{"operation": {"methods": list(methods)}}]
        ap = new_resource(
            "AuthorizationPolicy",
            name,
            namespace,
            annotations={"manager": BINDING_MANAGER, "user": user, "role": role},
            spec={"action": "ALLOW", "rules": [rule]},
        )
        ap.metadata.owner_references = [owner_ref(ns_obj, controller=False)]
        self.api.apply(ap)
        return success_response()

    def delete_binding(self, req: Request) -> Response:
        self.requests.inc(handler="delete_binding")
        user, namespace, role = self._parse_binding(req)
        self._ensure_owner_or_admin(req.user, namespace)
        name = _binding_name(user, role)
        for kind in ("RoleBinding", "AuthorizationPolicy"):
            try:
                self.api.delete(kind, name, namespace)
            except NotFound:
                pass
        return success_response()

    def query_cluster_admin(self, req: Request) -> Response:
        self.requests.inc(handler="query_cluster_admin")
        user = req.query.get("user", req.user)
        return json_response(is_cluster_admin(self.api, user))
