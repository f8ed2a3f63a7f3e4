"""Per-request authorization by SubjectAccessReview.

A copy of `kubeflow_tpu/web/authz.py` (a module with no JAX in it): every
web-app handler asks whether (user, verb, resource, namespace) is
allowed, answered by the RBAC evaluator over the stored roles and
bindings (`api/rbac.py`), and a denial is a 403 with a readable message.

Not copied: the second gate, the mesh-policy admission of the user's
HTTP method into the namespace (`kubeflow_tpu/web/mesh.py`, an
evaluator of AuthorizationPolicy objects, which is not ported; ROADMAP
lists it). The port's apps authorize by RBAC alone; the Profile
controller and kfam still write the AuthorizationPolicy objects.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api.rbac import subject_access_review
from kubeflow_tpu_torch.web.wsgi import HttpError, Request


class Forbidden(HttpError):
    def __init__(self, message: str):
        super().__init__(403, message)


def ensure_authorized(
    api,
    user: str | None,
    verb: str,
    resource: str,
    namespace: str = "",
    request: Request | None = None,
) -> None:
    """401 without a user, 403 unless RBAC allows the verb. `request` is
    accepted for the JAX signature (its mesh gate reads the method)."""
    if user is None:
        raise HttpError(401, "request has no authenticated user")
    if not subject_access_review(api, user, verb, resource, namespace):
        scope = f"in namespace {namespace!r}" if namespace else "cluster-wide"
        raise Forbidden(f"user {user!r} is not allowed to {verb} {resource} {scope}")
