"""Mesh-policy admission: the Istio AuthorizationPolicy evaluator.

A copy of `kubeflow_tpu/web/mesh.py` (a module with no JAX in it). The
Profile controller writes a namespace owner's AuthorizationPolicy and
kfam adds contributor policies; with no sidecars on one host, the web
tier evaluates the same policy objects at the request boundary, as the
second gate after RBAC (`web/authz.ensure_authorized`).

Semantics follow Istio's AuthorizationPolicy evaluation order:

1. If any DENY policy has a rule matching the request → deny.
2. If the namespace has no ALLOW policies → allow (policy-free
   namespaces stay open: hand-made test namespaces, system namespaces).
3. Otherwise allow iff some ALLOW policy rule matches.

A rule matches when its `from` matches the principal AND its `to`
matches the operation; an empty/missing clause matches anything — which
makes `rules: []` the deny-all idiom (the policy flips the namespace
into enforce mode yet admits nobody), and `rules: [{}]` allow-all.
Principals and paths support Istio's exact, `prefix*`, and `*suffix`
match forms; methods are exact HTTP verbs.
"""

from __future__ import annotations

from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import HttpError


def _match(pattern: str, value: str) -> bool:
    """Istio string match: exact, `foo*` prefix, `*foo` suffix, `*` any
    (`servicerole_types.go:33-41` documents the same three forms)."""
    if pattern == "*":
        return True
    if pattern.endswith("*"):
        return value.startswith(pattern[:-1])
    if pattern.startswith("*"):
        return value.endswith(pattern[1:])
    return pattern == value


def _from_matches(rule: dict, user: str) -> bool:
    sources = rule.get("from", [])
    if not sources:
        return True  # no source constraint = any principal
    return any(
        any(
            _match(p, user)
            for p in source.get("source", {}).get("principals", [])
        )
        for source in sources
    )


def _to_matches(
    rule: dict,
    method: str | None,
    path: str | None,
    *,
    fail_closed: bool = False,
) -> bool:
    operations = rule.get("to", [])
    if not operations:
        return True  # no operation constraint = any method/path
    for to in operations:
        op = to.get("operation", {})
        methods = op.get("methods", [])
        paths = op.get("paths", [])
        # A None method/path means the caller didn't present one (an
        # in-process check without a request). In Istio every request
        # carries both, so a constrained rule always gets something to
        # match; here a DENY rule must treat the absent value as
        # MATCHING (fail closed) — otherwise method-scoped DENY policies
        # silently fail open for exactly the callers that bypass HTTP.
        method_ok = not methods or (
            fail_closed
            if method is None
            else any(_match(m, method) for m in methods)
        )
        path_ok = not paths or (
            fail_closed
            if path is None
            else any(_match(p, path) for p in paths)
        )
        if method_ok and path_ok:
            return True
    return False


def _rule_matches(
    rule: dict,
    user: str,
    method: str | None,
    path: str | None,
    *,
    fail_closed: bool = False,
) -> bool:
    return _from_matches(rule, user) and _to_matches(
        rule, method, path, fail_closed=fail_closed
    )


def mesh_admits(
    api: FakeApiServer,
    user: str,
    namespace: str,
    *,
    method: str | None = None,
    path: str | None = None,
) -> bool:
    policies = api.list("AuthorizationPolicy", namespace)
    allows = [p for p in policies if p.spec.get("action", "ALLOW") == "ALLOW"]
    denies = [p for p in policies if p.spec.get("action") == "DENY"]
    # DENY is evaluated first and wins (Istio's order of evaluation).
    # fail_closed: an absent method/path matches constrained DENY rules.
    for policy in denies:
        if any(
            _rule_matches(rule, user, method, path, fail_closed=True)
            for rule in policy.spec.get("rules", [])
        ):
            return False
    if not allows:
        return True
    return any(
        _rule_matches(rule, user, method, path)
        for policy in allows
        for rule in policy.spec.get("rules", [])
    )


def ensure_mesh_admits(
    api: FakeApiServer,
    user: str,
    namespace: str,
    *,
    method: str | None = None,
    path: str | None = None,
) -> None:
    from kubeflow_tpu_torch.api.rbac import is_cluster_admin

    # Cluster-admins reach workloads through the platform gateway, which
    # the mesh trusts (the reference's admins bypass the mesh via
    # kubectl; the dashboard's admin probe is `api_default.go:270`).
    if is_cluster_admin(api, user):
        return
    if not mesh_admits(api, user, namespace, method=method, path=path):
        what = f" {method}" if method else ""
        raise HttpError(
            403,
            f"mesh policy denies {user!r}{what} access to namespace "
            f"{namespace!r} (no AuthorizationPolicy admits this "
            "principal for this operation — ask the profile owner for a "
            "contributor binding)",
        )
