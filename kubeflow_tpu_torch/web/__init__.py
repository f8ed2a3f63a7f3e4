"""Web core: the WSGI app, request/response types and server
(`web/wsgi.py`), and the control plane's TLS certs and contexts
(`web/tls.py`)."""

from kubeflow_tpu_torch.web.wsgi import (
    App,
    HttpError,
    Request,
    Response,
    TestClient,
    json_response,
    serve,
)

__all__ = [
    "App",
    "HttpError",
    "Request",
    "Response",
    "TestClient",
    "json_response",
    "serve",
]
