"""ResourceQuota enforcement: the quota admission controller.

Counterpart of `kubeflow_tpu/controllers/quota.py` (a module with no JAX
in it), whole, with the accelerator translation: the accelerator a pod
asks for is `nvidia.com/gpu` (`api/tpujob.ACCELERATOR_RESOURCE`), so a
tenant's cap on it is metered wherever the JAX package meters
`google.com/tpu`. The in-process store has no built-in quota admission;
`register(api)` installs it at the boundary K8s does: admission.

Scope (the corev1 ResourceQuotaSpec a Profile carries):

- **Compute, requests vs limits**: `requests.cpu` / `limits.cpu` (same
  for `memory` and `nvidia.com/gpu`) meter exactly that figure per
  container; bare `cpu` / `memory` / `nvidia.com/gpu` are the corev1
  shorthands for the requests form. Absent requests inherit the
  container's limits, and absent limits fall back to requests
  (`api/objects.container_resource_total`). A pod naming NEITHER figure
  for an explicitly prefixed metered resource is rejected, as K8s does
  ("must specify requests.cpu"); bare-key caps tolerate it.
- **Object counts**: `pods` (non-terminal), `persistentvolumeclaims`,
  and the generic `count/<resource>` form (lowercase plural, e.g.
  `count/tpujobs`).
- **Storage**: `requests.storage` sums live PVCs'
  spec.resources.requests.storage.
- **status.used** is published on the quota object after every change,
  as the K8s quota controller does, debounced on a thread of its own.

Semantics: on create of a metered kind, current namespace usage plus the
new object's ask must fit under every named cap, else `QuotaExceeded`
(an `Invalid`, 422 through the facade); an update re-admits without the
object's own usage; a namespace without a ResourceQuota is unmetered.
All arithmetic is in integer milli-units. The TpuJob operator turns a
quota rejection into a `QuotaExceeded` Pending episode instead of a
crash-looping partial gang.
"""

from __future__ import annotations

import logging

from kubeflow_tpu_torch.api.objects import (
    Resource,
    container_resource_total,
    parse_quantity,
)
from kubeflow_tpu_torch.api.rbac import resource_for_kind
from kubeflow_tpu_torch.api.tpujob import ACCELERATOR_RESOURCE
from kubeflow_tpu_torch.testing.fake_apiserver import (
    FakeApiServer,
    Invalid,
    NotFound,
)

log = logging.getLogger(__name__)

QUOTA_NAME = "kf-resource-quota"

# Compute resources meterable per pod (bare key = corev1 shorthand for
# the requests form).
COMPUTE = ("cpu", "memory", ACCELERATOR_RESOURCE)


class QuotaExceeded(Invalid):
    """Rejected by quota admission — an Invalid subclass so in-process
    callers and the HTTP facade surface it as the 422 class every other
    admission rejection uses."""


def _milli(value) -> int:
    """Quantity → integer milli-units. All quota arithmetic happens in
    millis (K8s does the same): binary floats would spuriously reject
    exact fits (0.1+0.1+0.1 > 0.3 in float64)."""
    return round(parse_quantity(value) * 1000)


def _classify(key: str):
    """One hard-cap key → ("pod"|"pvc"|"count", detail).

    pod  → (resource, source, strict): compute metering over containers;
           strict = explicitly-prefixed key → every container must name
           the figure (K8s "must specify requests.cpu").
    pvc  → ("count" | "storage")
    count→ resource string (lowercase plural) counted over live objects.
    Unknown keys return None — stored but unenforced, like K8s with a
    quota for a resource class the cluster doesn't run."""
    if key == "pods":
        return ("count", "pods")
    if key == "persistentvolumeclaims":
        return ("count", "persistentvolumeclaims")
    if key.startswith("count/"):
        return ("count", key[len("count/"):])
    if key == "requests.storage":
        return ("pvc", "storage")
    if key in COMPUTE:
        return ("pod", (key, "requests", False))
    for prefix, source in (("requests.", "requests"), ("limits.", "limits")):
        if key.startswith(prefix) and key[len(prefix):] in COMPUTE:
            return ("pod", (key[len(prefix):], source, True))
    return None


def _pod_compute_ask(pod: Resource, resource: str, source: str,
                     strict: bool) -> int:
    """A pod's milli-ask for one compute cap."""
    if strict:
        for c in pod.spec.get("containers", []):
            res = c.get("resources", {})
            if (
                res.get("requests", {}).get(resource) is None
                and res.get("limits", {}).get(resource) is None
            ):
                raise Invalid(
                    f"container {c.get('name')!r} must specify "
                    f"{source}.{resource}: the namespace quota meters it "
                    f"(K8s quota admission semantics)"
                )
    return round(container_resource_total(pod, resource, source=source) * 1000)


def _pvc_storage_milli(pvc: Resource) -> int:
    ask = (
        pvc.spec.get("resources", {}).get("requests", {}).get("storage", 0)
    )
    return round(parse_quantity(ask) * 1000)


def _live(obj: Resource) -> bool:
    return obj.status.get("phase") not in ("Succeeded", "Failed")


def _hard_keys(hard: dict, kind: str) -> list[tuple[str, tuple]]:
    """The cap keys that meter objects of `kind`, classified. Count
    classifications are re-bound to the ADMISSION OBJECT'S kind — the
    one string guaranteed to round-trip (resource_for_kind is lossy for
    CamelCase kinds, so deriving the kind back from the resource string
    is not generally possible)."""
    resource = resource_for_kind(kind)
    out = []
    for key in hard:
        cls = _classify(key)
        if cls is None:
            continue
        family, detail = cls
        if family == "pod" and kind == "Pod":
            out.append((key, cls))
        elif family == "pvc" and kind == "PersistentVolumeClaim":
            out.append((key, cls))
        elif family == "count" and detail == resource:
            out.append((key, ("count", kind)))
    return out


def _object_ask(obj: Resource, cls) -> int:
    family, detail = cls
    if family == "count":
        return 1000  # one object, in millis
    if family == "pvc":
        return _pvc_storage_milli(obj)
    resource, source, strict = detail
    return _pod_compute_ask(obj, resource, source, strict)


def _usage_milli(
    api: FakeApiServer,
    namespace: str,
    keys: list[tuple[str, tuple]],
    exclude_kind: str,
    exclude_name: str | None,
) -> dict[str, int]:
    """Live usage per cap key — one list() per involved kind, not per
    key (each list() deepcopies every object under the store lock)."""
    used = {key: 0 for key, _ in keys}
    by_kind: dict[str, list[tuple[str, tuple]]] = {}
    for key, cls in keys:
        family, detail = cls
        if family == "pod":
            kind = "Pod"
        elif family == "pvc":
            kind = "PersistentVolumeClaim"
        else:
            kind = detail  # bound to a stored kind by the caller
        by_kind.setdefault(kind, []).append((key, cls))
    for kind, kind_keys in by_kind.items():
        for obj in api.list(kind, namespace):
            if kind == exclude_kind and obj.metadata.name == exclude_name:
                continue
            if kind == "Pod" and not _live(obj):
                continue
            for key, cls in kind_keys:
                try:
                    family, detail = cls
                    if family == "pod":
                        resource, source, _strict = detail
                        # Usage never re-applies strictness: a
                        # pre-existing unmarked pod contributes 0, it
                        # doesn't wedge every later admission.
                        used[key] += _pod_compute_ask(
                            obj, resource, source, False
                        )
                    else:
                        used[key] += _object_ask(obj, cls)
                except ValueError as e:
                    raise ValueError(
                        f"existing {kind} {obj.metadata.name!r} has an "
                        f"unusable {key!r} figure: {e}"
                    ) from e
    return used


def _kinds_for_resource(api, resource: str) -> list[str]:
    """Stored kinds whose RBAC resource string is `resource` — the
    count/<resource> inverse, derived from the kinds LIVE in the store
    (resource_for_kind is lossy for CamelCase, so no static inverse
    exists). A resource with zero live objects maps to no kind, which
    is exactly usage 0."""
    kinds_fn = getattr(api, "kinds", None)
    kinds = kinds_fn() if kinds_fn is not None else ("Pod",)
    return [k for k in kinds if resource_for_kind(k) == resource]


def check_object(api: FakeApiServer, obj: Resource) -> Resource:
    """Admission hook: reject the object if it busts any hard cap."""
    namespace = obj.metadata.namespace
    if obj.kind == "Pod" and not _live(obj):
        # Terminal pods contribute zero usage, so they consume zero
        # quota — K8s excludes them from every pod scope. Without this,
        # an UPDATE to a finished pod (label edit, status touch) would
        # be charged as if it were a new live pod while usage correctly
        # excludes it: a phantom 422 in a full namespace.
        return obj
    try:
        rq = api.get("ResourceQuota", QUOTA_NAME, namespace)
    except NotFound:
        return obj  # unmetered namespace
    # Any OTHER read failure propagates: silently skipping the check
    # would turn the caps decorative again — fail closed, not open.
    hard = rq.spec.get("hard", {})
    keys = _hard_keys(hard, obj.kind)
    if not keys:
        return obj
    try:
        asks = {key: _object_ask(obj, cls) for key, cls in keys}
    except ValueError as e:
        # Garbage/negative figures in a metered namespace are a client
        # error (422), not an internal one: a negative "request" would
        # SUBTRACT from usage — a quota bypass.
        raise Invalid(f"{obj.kind} {obj.metadata.name!r}: {e}") from e
    active = [(k, cls) for k, cls in keys if asks[k] > 0]
    if not active:
        return obj
    try:
        used = _usage_milli(
            api, namespace, active,
            exclude_kind=obj.kind, exclude_name=obj.metadata.name,
        )
        caps = {key: _milli(hard[key]) for key, _ in active}
    except ValueError as e:
        # A malformed CAP (the profile's resourceQuotaSpec passes
        # through verbatim) or a garbage stored figure: still a 422
        # with the culprit named — never a raw 500 crash-loop.
        raise Invalid(f"quota evaluation in {namespace!r}: {e}") from e
    for key, _cls in active:
        if used[key] + asks[key] > caps[key]:
            raise QuotaExceeded(
                f"{obj.kind} {obj.metadata.name!r} exceeds ResourceQuota "
                f"{key!r} in namespace {namespace!r}: "
                f"used {used[key] / 1000:g} + requested "
                f"{asks[key] / 1000:g} > hard cap {hard[key]}"
            )
    return obj


def compute_used(api: FakeApiServer, namespace: str, hard: dict) -> dict:
    """The status.used the K8s quota controller publishes: live usage
    for every enforceable cap key, in base units (counts as ints, milli
    figures rendered exactly)."""
    keys = []
    count_parts: dict[str, list[str]] = {}
    for key in hard:
        cls = _classify(key)
        if cls is None:
            continue
        family, detail = cls
        if family == "count":
            # One count cap may need sums over several live kinds that
            # pluralize to the same resource (normally exactly one).
            bound = _kinds_for_resource(api, detail)
            count_parts[key] = [f"{key}\u0000{k}" for k in bound]
            for k in bound:
                keys.append((f"{key}\u0000{k}", ("count", k)))
        else:
            keys.append((key, cls))
    used_milli = _usage_milli(api, namespace, keys, "", None)
    for key, parts in count_parts.items():
        used_milli[key] = sum(used_milli.pop(p) for p in parts)
    out = {}
    for key in list(used_milli):
        millis = used_milli[key]
        out[key] = (
            millis // 1000 if millis % 1000 == 0 else f"{millis}m"
        )
    return out


def publish_used(api: FakeApiServer, namespace: str) -> None:
    """Recompute and publish status.used on the namespace's quota (no-op
    without one, or when unchanged — the handler runs on every pod/PVC
    event and must not self-amplify)."""
    try:
        rq = api.get("ResourceQuota", QUOTA_NAME, namespace)
    except NotFound:
        return
    try:
        used = compute_used(api, namespace, rq.spec.get("hard", {}))
    except ValueError:
        log.debug("unpublishable quota usage in %r", namespace,
                  exc_info=True)
        return
    if rq.status.get("used") == used and "hard" in rq.status:
        return
    rq = rq.thaw()
    rq.status["hard"] = dict(rq.spec.get("hard", {}))
    rq.status["used"] = used
    try:
        api.update_status(rq)
    except Exception:
        log.debug("quota status publish lost a race", exc_info=True)


def register(api: FakeApiServer) -> None:
    """Install quota admission on the store (idempotent hooks are the
    admission contract; the check hooks only read) and the status.used
    publisher (watch-driven, like the K8s quota controller)."""
    import threading
    import weakref

    # kind=None: count/<resource> caps can meter ANY stored kind (K8s
    # object-count quotas do); the per-create cost in an unmetered
    # namespace is one dict lookup (NotFound on the quota get).
    api.register_admission(lambda o: check_object(api, o))

    # status.used publishing is DEBOUNCED onto its own thread: the watch
    # handler only marks the namespace dirty. Publishing inline on the
    # store's dispatcher thread would run a full O(objects) recompute
    # per event — a 64-pod gang create would pay O(N^2) quota
    # bookkeeping while every other controller's events queue behind it
    # (the K8s quota controller is likewise an async, coalescing
    # worker). The dirty-set dedupe also absorbs the publisher's own
    # ResourceQuota MODIFIED echo: the follow-up recompute no-ops.
    dirty: set[str] = set()
    cv = threading.Condition()
    # The thread must not keep the store alive: it holds only a weakref
    # and exits once every outside reference drops or the store is
    # closed (tests build many stores; an immortal closure would pin
    # each one plus its thread).
    api_ref = weakref.ref(api)

    def _republish(event: str, obj: Resource) -> None:
        # Any metered kind can move usage (count/<resource> caps cover
        # arbitrary kinds), so listen to everything and let publish_used
        # no-op fast for unmetered namespaces. Events are excluded: they
        # are never meterable (record_event names collide) and are the
        # one high-volume kind.
        if obj.kind != "Event" and obj.metadata.namespace:
            with cv:
                dirty.add(obj.metadata.namespace)
                cv.notify()

    def _publisher() -> None:
        while True:
            with cv:
                if not dirty:
                    cv.wait(1.0)  # bounded: liveness check below
                batch = sorted(dirty)
                dirty.clear()
            target = api_ref()
            if target is None or target.closed:
                return  # store released or closed; the thread dies with it
            for ns in batch:
                try:
                    publish_used(target, ns)
                except Exception:
                    log.debug("quota status publish failed for %r", ns,
                              exc_info=True)
            del target

    threading.Thread(
        target=_publisher, name="quota-status-publisher", daemon=True
    ).start()
    api.watch(_republish)
