"""Shared handlers for the web apps — the crud_backend common routes.

A copy of `kubeflow_tpu/apps/common.py` (a module with no JAX in it), whole.

One implementation (and one response shape) for surfaces every app
serves; per-app copies drift, and the shared frontend (`static/ui.js`)
hard-codes these envelopes.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api.rbac import namespaces_for
from kubeflow_tpu_torch.web.wsgi import Request, Response, success_response


def namespaces_response(api, req: Request) -> Response:
    """GET /api/namespaces — the namespace selector's data source
    (kubeflow-common-lib NamespaceService): `{success, namespaces: [..]}`.
    Registered by every app, dashboard included, so the selector works on
    any page."""
    return success_response("namespaces", namespaces_for(api, req.user))
