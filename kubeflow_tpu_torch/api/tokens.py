"""Bearer-token identities for the apiserver facade.

A copy of `kubeflow_tpu/api/tokens.py` (a module with no JAX in it),
whole.

The reference never exposes an open apiserver: controllers authenticate
with serviceaccount tokens via client-go/kubeconfig, web backends do
per-request SubjectAccessReview (`crud_backend/authz.py:46-80`), and even
controller `/metrics` sits behind kube-rbac-proxy
(`notebook-controller/config/default/manager_auth_proxy_patch.yaml`).
This module is the token side of that trust model: a registry mapping
opaque bearer tokens onto user identities, with the kube-apiserver
`--token-auth-file` persistence format (extended with an expiry column)
so separate processes — e2e workers, out-of-process controllers, the
CLI — can be handed least-privilege credentials through a file or env
var.

Lifecycle matches the serviceaccount-token model these tokens cite:
- tokens may be TIME-BOUND (`issue(user, ttl=...)`); an expired token
  authenticates as nobody (the facade 401s it) — one leaked CI log line
  is a bounded credential, not a permanent one;
- `rotate()` mints a successor for the same identity while the old
  token keeps working until revoked/expired, so a long-lived client
  (an in-flight controller watch) swaps credentials without dropping
  its stream;
- `watch_profiles(api)` wires revocation into tenant teardown: deleting
  a Profile revokes every token of that namespace's serviceaccounts,
  the way deleting a K8s namespace invalidates its SA tokens.

Authorization stays in `api/rbac.py` (SubjectAccessReview over the
stored (Cluster)Roles/Bindings); this module only answers "who is
calling?".
"""

from __future__ import annotations

import secrets
import threading
import time


def service_account(namespace: str, name: str) -> str:
    """The K8s serviceaccount username convention
    (`system:serviceaccount:<ns>:<name>`) — what RBAC subjects name."""
    return f"system:serviceaccount:{namespace}:{name}"


class TokenRegistry:
    """token → (user identity, optional expiry) map (the
    serviceaccount-token analog)."""

    def __init__(self) -> None:
        # token → (user, expires_at | None); expires_at is epoch seconds.
        self._tokens: dict[str, tuple[str, float | None]] = {}
        self._lock = threading.Lock()
        self._autosave_path: str | None = None

    def autosave(self, path: str) -> None:
        """Persist the registry to `path` after every mutation (issue/
        rotate/revoke). Without this, a durable control plane restores
        REVOKED credentials from its token file on restart — revocation
        must be as durable as issuance."""
        self._autosave_path = path
        self.save(path)

    def _maybe_save(self) -> None:
        if self._autosave_path is not None:
            self.save(self._autosave_path)

    def issue(self, user: str, ttl: float | None = None) -> str:
        """Mint a fresh opaque token for `user` and return it; `ttl`
        seconds bounds its lifetime (None = non-expiring, for static
        bootstrap credentials only). The fixed prefix guarantees tokens
        never start with '-' (token_urlsafe can, and `--token <value>`
        through any argparse CLI would then parse the credential as an
        option flag)."""
        token = "kt-" + secrets.token_urlsafe(24)
        expires = time.time() + ttl if ttl is not None else None
        with self._lock:
            self._tokens[token] = (user, expires)
        self._maybe_save()
        return token

    def add(
        self, token: str, user: str, expires_at: float | None = None
    ) -> None:
        """Register a caller-chosen token (static-token-file entries)."""
        with self._lock:
            self._tokens[token] = (user, expires_at)
        self._maybe_save()

    def rotate(self, token: str, ttl: float | None = None) -> str | None:
        """Mint a successor token for `token`'s identity (None if the
        token is unknown/expired). The OLD token stays valid until the
        caller revokes it — the two-generation overlap that lets a
        long-lived client swap credentials without a dropped request
        (K8s bound-token rotation works the same way: re-request, swap,
        let the old one age out)."""
        user = self.authenticate(token)
        if user is None:
            return None
        return self.issue(user, ttl=ttl)

    def revoke(self, token: str) -> None:
        with self._lock:
            self._tokens.pop(token, None)
        self._maybe_save()

    def revoke_user(self, user: str) -> int:
        """Revoke every token naming `user`; returns how many."""
        with self._lock:
            doomed = [t for t, (u, _) in self._tokens.items() if u == user]
            for t in doomed:
                del self._tokens[t]
        self._maybe_save()
        return len(doomed)

    def revoke_namespace(self, namespace: str) -> int:
        """Revoke every serviceaccount token of `namespace` — tenant
        teardown (deleting a K8s namespace invalidates its SA tokens the
        same way). Returns how many were revoked."""
        prefix = f"system:serviceaccount:{namespace}:"
        with self._lock:
            doomed = [
                t
                for t, (u, _) in self._tokens.items()
                if u.startswith(prefix)
            ]
            for t in doomed:
                del self._tokens[t]
        if doomed:
            self._maybe_save()
        return len(doomed)

    def authenticate(self, token: str) -> str | None:
        """The identity behind `token`, or None for an unknown or
        EXPIRED token (expired entries are pruned on sight)."""
        with self._lock:
            entry = self._tokens.get(token)
            if entry is None:
                return None
            user, expires = entry
            if expires is not None and time.time() >= expires:
                del self._tokens[token]
                return None
            return user

    def token_for(self, user: str) -> str | None:
        """A live (non-expired) token already registered for `user`, or
        None. Boot-time convenience: a durable launcher reloading its
        token file reprints the admin credential instead of minting a
        second one."""
        now = time.time()
        with self._lock:
            for token, (u, expires) in sorted(self._tokens.items()):
                if u == user and (expires is None or now < expires):
                    return token
        return None

    def watch_profiles(self, api) -> None:
        """Wire revocation into tenant teardown: when a Profile is
        deleted (its finalizer cleared — the profile controller tears
        down the namespace), every serviceaccount token of that
        namespace dies with it."""

        def on_profile(event: str, obj) -> None:
            if event == "DELETED":
                self.revoke_namespace(obj.metadata.name)

        api.watch(on_profile, "Profile")

    # -- persistence (kube-apiserver --token-auth-file format) -------------

    def save(self, path: str) -> None:
        import os

        with self._lock:
            lines = []
            for t, (u, expires) in sorted(self._tokens.items()):
                suffix = f",{expires:.3f}" if expires is not None else ""
                lines.append(f"{t},{u}{suffix}\n")
        # Credentials: owner-only, like kube-apiserver expects of its
        # token-auth file. fchmod as well as the create mode — O_CREAT's
        # mode argument is ignored when the file already exists.
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        os.fchmod(fd, 0o600)
        with os.fdopen(fd, "w") as f:
            f.writelines(lines)

    @classmethod
    def load(cls, path: str) -> "TokenRegistry":
        reg = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                if len(parts) >= 2 and parts[0] and parts[1]:
                    expires = None
                    if len(parts) >= 3 and parts[2]:
                        try:
                            expires = float(parts[2])
                        except ValueError:
                            continue  # malformed row: skip, don't crash
                    reg.add(parts[0], parts[1], expires_at=expires)
        return reg
