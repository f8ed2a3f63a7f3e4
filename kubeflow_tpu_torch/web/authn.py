"""Header-based authentication: the web apps' trust model.

A copy of `kubeflow_tpu/web/authn.py` (a module with no JAX in it),
whole. A mesh gateway in front of the apps authenticates the user and
injects a user-id header; the apps read it and strip an optional prefix.
The knobs are the reference's: USERID_HEADER (default
``x-goog-authenticated-user-email``) and USERID_PREFIX
(``accounts.google.com:``). ``anonymous`` is the dev mode: a request
without the header is that user instead of a 401.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.web.wsgi import Request, Response, error_response

DEFAULT_HEADER = "x-goog-authenticated-user-email"
DEFAULT_PREFIX = "accounts.google.com:"

# Probe paths that answer without an identity.
SKIP_PATHS = ("/healthz", "/metrics")


class HeaderAuthn:
    """Before-request hook: resolve `request.user` or answer 401."""

    def __init__(
        self,
        header: str | None = None,
        prefix: str | None = None,
        anonymous: str | None = None,
    ):
        self.header = (
            header if header is not None else os.environ.get("USERID_HEADER", DEFAULT_HEADER)
        ).lower()
        self.prefix = (
            prefix if prefix is not None else os.environ.get("USERID_PREFIX", DEFAULT_PREFIX)
        )
        self.anonymous = anonymous

    def __call__(self, req: Request) -> Response | None:
        if req.path in SKIP_PATHS:
            return None
        raw = req.headers.get(self.header, "")
        if raw.startswith(self.prefix):
            raw = raw[len(self.prefix):]
        if not raw:
            if self.anonymous:
                req.user = self.anonymous
                return None
            return error_response(401, f"no user identity in header {self.header!r}")
        req.user = raw
        return None
