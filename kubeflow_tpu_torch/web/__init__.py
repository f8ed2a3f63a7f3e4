"""Web core: the WSGI app, request/response types and server
(`web/wsgi.py`), header authentication (`web/authn.py`), RBAC
authorization of each handler (`web/authz.py`) and the control plane's
TLS certs and contexts (`web/tls.py`)."""

from kubeflow_tpu_torch.web.authn import HeaderAuthn
from kubeflow_tpu_torch.web.authz import Forbidden, ensure_authorized
from kubeflow_tpu_torch.web.wsgi import (
    App,
    HttpError,
    Request,
    Response,
    TestClient,
    json_response,
    serve,
    success_response,
)

__all__ = [
    "App",
    "Forbidden",
    "HeaderAuthn",
    "HttpError",
    "Request",
    "Response",
    "TestClient",
    "ensure_authorized",
    "json_response",
    "serve",
    "success_response",
]
