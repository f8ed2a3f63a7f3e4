"""Per-request authorization by SubjectAccessReview.

A copy of `kubeflow_tpu/web/authz.py` (a module with no JAX in it): every
web-app handler asks whether (user, verb, resource, namespace) is
allowed, answered by the RBAC evaluator over the stored roles and
bindings (`api/rbac.py`), and a denial is a 403 with a readable message.

In a namespace a second gate follows: the mesh policy (`web/mesh.py`)
must admit the user's HTTP method and path into the namespace, so RBAC
without a matching AuthorizationPolicy rule fails closed in a namespace
that has policies.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api.rbac import subject_access_review
from kubeflow_tpu_torch.web.wsgi import HttpError, Request


class Forbidden(HttpError):
    def __init__(self, message: str):
        super().__init__(403, message)


# The HTTP method a mesh sidecar would see for each API verb, used when
# the caller does not hand over the live request (mesh rules match HTTP
# methods, not K8s verbs).
_VERB_METHODS = {
    "get": "GET", "list": "GET", "watch": "GET",
    "create": "POST", "update": "PUT", "patch": "PATCH",
    "delete": "DELETE",
}


def ensure_authorized(
    api,
    user: str | None,
    verb: str,
    resource: str,
    namespace: str = "",
    request: Request | None = None,
) -> None:
    """401 without a user, 403 unless RBAC allows the verb and, in a
    namespace, the mesh admits the request's method and path (or, with
    no `request`, the verb's method)."""
    if user is None:
        raise HttpError(401, "request has no authenticated user")
    if not subject_access_review(api, user, verb, resource, namespace):
        scope = f"in namespace {namespace!r}" if namespace else "cluster-wide"
        raise Forbidden(f"user {user!r} is not allowed to {verb} {resource} {scope}")
    if namespace:
        from kubeflow_tpu_torch.web.mesh import ensure_mesh_admits

        ensure_mesh_admits(
            api, user, namespace,
            method=request.method if request is not None else _VERB_METHODS.get(verb),
            path=request.path if request is not None else None,
        )
