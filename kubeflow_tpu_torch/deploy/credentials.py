"""Cloud credential plumbing: TokenSource + authenticated transport.

Counterpart of `kubeflow_tpu/deploy/credentials.py`, whole, its imports
pointed at the port.

The reference's deploy service injects a refreshing OAuth TokenSource
into every cloud call (`bootstrap/cmd/bootstrap/app/tokenSource.go`,
table-tested in `tokenSource_test.go`; injection at
`kfctlServer.go:179-201`). Same split here, pure-logic and table-testable
without a cloud:

- `RefreshableTokenSource` — the `RefreshableTokenSource` analog: a
  thread-safe token slot refreshed either by HTTP push (`refresh`, with a
  project-access check before accepting the new credential, exactly the
  reference's guard) or by a pull `refresh_fn` when the cached token is
  missing/expiring (the oauth2.TokenSource auto-refresh the reference
  gets from its SDK).
- `AuthTransport` — the network edge behind `gke.Transport`: stamps
  `Authorization: Bearer`, maps HTTP status onto the `CloudError`
  hierarchy (409 → `CloudConflict` so ensure-create races resolve as
  success, 404 → `CloudNotFound`, 401/403 → `CloudAuthError`,
  429/5xx → retryable `CloudError`), and supports an api-base override so
  a fake GKE HTTP server can stand in for `container.googleapis.com` in
  end-to-end tests.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Protocol

from kubeflow_tpu_torch.deploy.gke import API_BASE, Request
from kubeflow_tpu_torch.deploy.provisioner import CloudError

# Refresh a token this many seconds before its stated expiry — in-flight
# requests must not ride a credential that dies mid-call.
EXPIRY_SKEW_SECONDS = 60.0


class CloudAuthError(CloudError):
    """401/403 from the cloud, or no valid credential to send."""


class CloudConflict(CloudError):
    """409: the resource already exists (ensure treats create-409 as
    success — the `kfctl_second_apply` idempotency contract)."""


class CloudNotFound(CloudError):
    """404: the resource does not exist."""


@dataclasses.dataclass(frozen=True)
class Token:
    """An access credential; expiry is epoch seconds (None = static)."""

    access_token: str
    expiry: float | None = None

    def valid_at(self, now: float, skew: float = EXPIRY_SKEW_SECONDS) -> bool:
        if not self.access_token:
            return False
        return self.expiry is None or now < self.expiry - skew


class TokenSource(Protocol):
    def token(self) -> Token: ...


class StaticTokenSource:
    """A fixed credential (the oauth2.StaticTokenSource analog,
    `kfctlServer.go:597-600`)."""

    def __init__(self, token: Token | str):
        self._token = Token(token) if isinstance(token, str) else token

    def token(self) -> Token:
        return self._token


def _always(project: str, token: Token) -> bool:
    return True


class RefreshableTokenSource:
    """Thread-safe refreshable token slot, scoped to one project.

    `refresh()` is the HTTP-push path (`tokenSource.go:46-73`): reject an
    empty credential, verify it still grants access to the project via
    `checker` before swapping it in — a bad push must never clobber a
    working credential. `token()` is the pull path: return the cached
    token while valid; once it enters the expiry skew, call `refresh_fn`
    for a new one, else fail with `CloudAuthError`.
    """

    def __init__(
        self,
        project: str,
        *,
        checker: Callable[[str, Token], bool] = _always,
        refresh_fn: Callable[[], Token] | None = None,
        clock: Callable[[], float] = time.time,
    ):
        if not project:
            raise ValueError("project is required")
        self.project = project
        self._checker = checker
        self._refresh_fn = refresh_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._token: Token | None = None

    def refresh(self, token: Token) -> None:
        if not token.access_token:
            raise ValueError("no access token specified")
        if not self._checker(self.project, token):
            raise CloudAuthError(
                "refused token refresh: credential does not grant "
                "sufficient access to the project"
            )
        with self._lock:
            self._token = token

    def token(self) -> Token:
        now = self._clock()
        with self._lock:
            cached = self._token
        if cached is not None and cached.valid_at(now):
            return cached
        if self._refresh_fn is not None:
            fresh = self._refresh_fn()
            if not fresh.valid_at(self._clock()):
                raise CloudAuthError(
                    "refresh_fn returned an invalid or expired token"
                )
            with self._lock:
                self._token = fresh
            return fresh
        raise CloudAuthError(
            "no valid cloud credential (token missing or expired and no "
            "refresh function configured)"
        )


class HttpSender(Protocol):
    """One HTTP exchange: returns (status, parsed-json-body)."""

    def __call__(
        self, method: str, url: str, headers: dict[str, str], body: dict | None
    ) -> tuple[int, dict]: ...


def urllib_sender(
    method: str, url: str, headers: dict[str, str], body: dict | None,
    *, timeout: float = 30.0,
) -> tuple[int, dict]:
    """The real network edge (stdlib; zero extra deps). HTTP errors are
    returned as (status, body) — classification happens in AuthTransport."""
    req = urllib.request.Request(
        url,
        method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers=headers,
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw.strip() else {}
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw) if raw.strip() else {}
        except ValueError:
            parsed = {"error": raw.decode(errors="replace")}
        return e.code, parsed
    except OSError as e:
        raise CloudError(f"cloud API unreachable: {e}") from e


def transport_from_flags(
    token_file: str | None, api_base: str | None
) -> "AuthTransport | None":
    """The CLI/worker flag surface → a transport (one place: the server
    CLI, the per-deployment worker, and anything else taking
    --gke-token-file/--gke-api-base must not drift)."""
    if not (token_file or api_base):
        return None
    token = ""
    if token_file:
        with open(token_file) as f:
            token = f.read().strip()
    return AuthTransport(StaticTokenSource(Token(token)), api_base=api_base)


class AuthTransport:
    """`gke.Transport` with credentials and error classification.

    `api_base` rewrites the canonical `container.googleapis.com` prefix
    of constructed requests, so the same payload builders drive a fake
    GKE server in tests and the real API in production."""

    def __init__(
        self,
        source: TokenSource,
        sender: HttpSender = urllib_sender,
        api_base: str | None = None,
    ):
        self.source = source
        self.sender = sender
        self.api_base = api_base.rstrip("/") if api_base else None

    def _url(self, url: str) -> str:
        if self.api_base and url.startswith(API_BASE):
            return self.api_base + url[len(API_BASE):]
        return url

    def send(self, request: Request) -> dict:
        token = self.source.token()
        headers = {
            "Authorization": f"Bearer {token.access_token}",
            "Content-Type": "application/json",
        }
        status, body = self.sender(
            request.method, self._url(request.url), headers, request.body
        )
        if 200 <= status < 300:
            return body
        message = body.get("error", body) if isinstance(body, dict) else body
        detail = f"{request.method} {request.url} -> {status}: {message}"
        if status in (401, 403):
            raise CloudAuthError(detail)
        if status == 404:
            raise CloudNotFound(detail)
        if status == 409:
            raise CloudConflict(detail)
        # 429 and 5xx are the transient class the apply loop retries;
        # remaining 4xx are spec bugs but ride the same CloudError so the
        # PLATFORM phase reports them uniformly (retries are bounded).
        raise CloudError(detail)
