"""RBAC resource names.

The port's own copy of `resource_for_kind` from
`kubeflow_tpu/api/rbac.py` (a module with no JAX in it), which the
quota admission (`controllers/quota.py`) needs for its object-count
caps. The rest of that module (cluster roles, bindings, the
authorizer) is not ported: the port's facade is open.
"""

from __future__ import annotations


def resource_for_kind(kind: str) -> str:
    """The RBAC resource string for a stored kind: lowercase plural, the
    way the reference's rules name resources (`notebooks`, `profiles`).
    English pluralization: consonant+y → ies (`Study` → `studies`),
    vowel+y → +s (`Gateway` → `gateways`), trailing s → +es."""
    lower = kind.lower()
    if lower.endswith("y") and lower[-2:-1] not in "aeiou":
        return lower[:-1] + "ies"
    if lower.endswith("s"):
        return lower + "es"
    return lower + "s"
