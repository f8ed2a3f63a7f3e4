"""kubectl-style CLI for the platform API ("kftpu").

A copy of `kubeflow_tpu/cli.py` (a module with no JAX in it): the
kubectl surface against the platform's own apiserver facade
(`testing/apiserver_http.ApiServerApp`):

    python -m kubeflow_tpu_torch.cli get notebooks -n team
    python -m kubeflow_tpu_torch.cli get tpujobs train -n ml -o yaml
    python -m kubeflow_tpu_torch.cli get tpujobs -n ml -w
    python -m kubeflow_tpu_torch.cli apply -f job.yaml
    python -m kubeflow_tpu_torch.cli describe tpujob train -n ml
    python -m kubeflow_tpu_torch.cli logs train -n ml --job
    python -m kubeflow_tpu_torch.cli delete notebook nb1 -n team
    python -m kubeflow_tpu_torch.cli top
    python -m kubeflow_tpu_torch.cli traces

`get --api-version V` and `describe --api-version V` read at any served
version of a multi-version kind (the facade's ``?version=``, the store's
conversion, `api/versioning.py`); `apply` takes a manifest at any served
version, which the store keeps at the hub version. Departures: `get -w`
follows the facade's streaming watch (JAX's long-polls): the table, then
one row per event; a bookmark past the journal's horizon relists;
`describe` takes `--api-version` too. `top` counts the GPUs pods ask for
(``nvidia.com/gpu``) against each Node's ``chips``, and its duty column
reads the Node's ``tpuDutyCycle`` (the JAX wire names).

Server discovery: --server or KFTPU_SERVER (default
http://127.0.0.1:8084). Kinds accept kubectl-ish aliases
(notebooks/notebook/nb → Notebook, tpujobs/tj → TpuJob, ...); unknown
kinds pass through verbatim so new CRDs need no CLI release.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import yaml

from kubeflow_tpu_torch.api.objects import Resource, container_limits_total
from kubeflow_tpu_torch.api.tpujob import ACCELERATOR_RESOURCE
from kubeflow_tpu_torch.testing.apiserver_http import (
    HttpApiClient,
    endpoints_from_env,
)
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    ApiError,
    Conflict,
)

# Matches `python -m kubeflow_tpu_torch.apps` default (--port-base 8080, facade
# at base+4). Override with --server / KFTPU_SERVER.
# The default launcher boot serves the facade HTTPS-only (secure by
# default); an insecure (--insecure-apiserver) boot needs an explicit
# --server http://... .
DEFAULT_SERVER = "https://127.0.0.1:8084"

ALIASES = {
    "notebook": "Notebook", "notebooks": "Notebook", "nb": "Notebook",
    "tpujob": "TpuJob", "tpujobs": "TpuJob", "tj": "TpuJob",
    "profile": "Profile", "profiles": "Profile",
    "tensorboard": "Tensorboard", "tensorboards": "Tensorboard",
    "tb": "Tensorboard",
    "study": "Study", "studies": "Study",
    "workflow": "Workflow", "workflows": "Workflow", "wf": "Workflow",
    "cronworkflow": "CronWorkflow", "cronworkflows": "CronWorkflow",
    "cwf": "CronWorkflow",
    "pod": "Pod", "pods": "Pod",
    "node": "Node", "nodes": "Node",
    "pvc": "PersistentVolumeClaim", "pvcs": "PersistentVolumeClaim",
    "snapshot": "VolumeSnapshot", "snapshots": "VolumeSnapshot",
    "poddefault": "PodDefault", "poddefaults": "PodDefault",
    "webhookconfiguration": "WebhookConfiguration",
    "webhookconfigurations": "WebhookConfiguration",
    "webhook": "WebhookConfiguration", "webhooks": "WebhookConfiguration",
    "event": "Event", "events": "Event",
    "service": "Service", "services": "Service", "svc": "Service",
    "deployment": "Deployment", "deployments": "Deployment",
    "statefulset": "StatefulSet", "statefulsets": "StatefulSet",
    "sts": "StatefulSet",
    "configmap": "ConfigMap", "configmaps": "ConfigMap", "cm": "ConfigMap",
    "secret": "Secret", "secrets": "Secret",
    "namespace": "Namespace", "namespaces": "Namespace", "ns": "Namespace",
    "serviceaccount": "ServiceAccount", "serviceaccounts": "ServiceAccount",
    "sa": "ServiceAccount",
    "resourcequota": "ResourceQuota", "resourcequotas": "ResourceQuota",
    "quota": "ResourceQuota",
    "lease": "Lease", "leases": "Lease",
    "virtualservice": "VirtualService", "virtualservices": "VirtualService",
    "vs": "VirtualService",
    "role": "Role", "roles": "Role",
    "rolebinding": "RoleBinding", "rolebindings": "RoleBinding",
    "clusterrole": "ClusterRole", "clusterroles": "ClusterRole",
    "clusterrolebinding": "ClusterRoleBinding",
    "clusterrolebindings": "ClusterRoleBinding",
}


def resolve_kind(
    raw: str,
    client: HttpApiClient | None = None,
    *,
    warn_empty: bool = True,
) -> str:
    """kubectl-style kind resolution: aliases/plurals first, then a
    generic lowercase-plural fallback (`somethings` → `Something`) so a
    kind missing from the table still lists as SOME cased guess instead
    of silently querying an empty lowercase kind — a `get configmaps`
    watching the nonexistent kind "configmaps" looks exactly like a
    quiet cluster.

    The fallback singularizer understands `-es` sibilant plurals
    (`statuses` → `Status`, `classes` → `Class`, `boxes` → `Box`) — the
    naive strip-one-s produced `Statuse`/`Classe`, kinds that cannot
    exist. English makes some plurals genuinely ambiguous (`caches` is
    cache+s, `churches` is church+es), so derivation returns ranked
    CANDIDATES and a `client` disambiguates: the first candidate with
    live objects wins. When no candidate has any, the best guess is
    used and (unless warn_empty=False — watch mode, where an empty kind
    is routinely what the operator is waiting on) a warning says which
    question was actually asked."""
    lower = raw.lower()
    if lower in ALIASES:
        return ALIASES[lower]
    if raw != lower or not raw:
        return raw  # already cased (a Kind name) or empty
    candidates = _singular_candidates(lower)
    kind = candidates[0]
    if client is not None:
        try:
            live = [k for k in candidates if client.list(k)]
        except Exception:
            live = [kind]  # can't tell; don't add noise to a real error
        if live:
            kind = live[0]
        elif warn_empty:
            print(
                f"warning: no live {kind!r} objects (kind derived from "
                f"{raw!r} — if that guess is wrong, use the exact "
                f"CamelCase kind)",
                file=sys.stderr,
            )
    return kind


def _singular_candidates(lower: str) -> list[str]:
    """Lowercase plural → CamelCase-ish singular kind guesses, best
    first. Suffix policy: -ies is unambiguous; for -es after a sibilant
    the es-strip leads where a silent-e stem is implausible
    (`statuses`, `classes`, `boxes`, `dishes`) and trails where it is
    the likelier reading (`caches`, `sizes` — stems ending -che/-ze);
    the runner-up stays a candidate so a live-object probe can overrule
    the heuristic either way."""
    if lower.endswith("ies"):
        return [lower[:-3].capitalize() + "y"]
    strip_s = lower[:-1].capitalize() if lower.endswith("s") else None
    strip_es = lower[:-2].capitalize() if lower.endswith("es") else None
    if strip_es and strip_s:
        for suffix in ("sses", "uses", "xes", "shes"):
            if lower.endswith(suffix):
                return [strip_es, strip_s]
        if lower.endswith(("ches", "zes", "ses")):
            return [strip_s, strip_es]
    if strip_s:
        return [strip_s]
    return [lower.capitalize()]


def _emit(obj, fmt: str) -> None:
    if fmt == "json":
        print(json.dumps(obj, indent=2, default=str))
    else:
        print(yaml.safe_dump(obj, sort_keys=False), end="")


def _print_table(headers, rows) -> None:
    widths = [
        max([len(h)] + [len(str(row[i])) for row in rows])
        for i, h in enumerate(headers)
    ]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print(fmt.format(*headers))
    for row in rows:
        print(fmt.format(*row))


def _phase(res: Resource) -> str:
    status = res.status or {}
    for key in ("phase", "containerState", "state"):
        if status.get(key):
            return str(status[key])
    if status.get("readyReplicas"):
        return "Ready"
    return ""


def cmd_get(client: HttpApiClient, args) -> int:
    # Listing is the command where a wrongly-derived kind is silent (an
    # empty table): pass the client so ambiguous derivations resolve
    # against live objects and empty guesses warn. Watch mode skips the
    # warning — an empty kind is routinely what `-w` is waiting on.
    # By-name commands (describe/delete) fail loudly with NotFound.
    kind = resolve_kind(args.kind, client, warn_empty=not args.watch)
    if args.watch:
        return _watch_kind(client, kind, args)
    if args.name:
        res = _get_scoped(client, kind, args.name, args.namespace, version=args.api_version)
        _emit(res.to_dict(), args.output or "yaml")
        return 0
    # Lists default to ALL namespaces (the table shows the namespace
    # column anyway, and cluster-scoped kinds live in ""); -n narrows.
    items = client.list(kind, namespace=args.namespace, version=args.api_version)
    if args.output in ("yaml", "json"):
        _emit([r.to_dict() for r in items], args.output)
        return 0
    _print_table(
        ("NAMESPACE", "NAME", "STATUS"),
        [(r.metadata.namespace, r.metadata.name, _phase(r)) for r in items],
    )
    return 0


def _watch_kind(client: HttpApiClient, kind: str, args) -> int:
    """`kubectl get -w` analog over the facade's watch stream: print the
    current table, then one row per event. With a NAME, the table and
    the stream are filtered to that object (kubectl's single-object
    watch). 410 Gone past the journal horizon recovers the informer way:
    re-list, reprint, resume from the list's resourceVersion."""
    import urllib.parse as _up

    params: dict[str, str] = {}
    if args.name:
        # Watching one object: scope the namespace the way a named get
        # does (default namespace unless -n).
        params["namespace"] = (
            args.namespace if args.namespace is not None else "default"
        ) or "_"
    elif args.namespace is not None:
        params["namespace"] = args.namespace or "_"

    def wanted(res: Resource) -> bool:
        return not args.name or res.metadata.name == args.name

    fmt = "{:<10}  {:<12}  {:<24}  {}"

    def relist() -> int:
        query = f"?{_up.urlencode(params)}" if params else ""
        data = client._call("GET", f"/apis/{kind}{query}")
        for item in data["items"]:
            res = Resource.from_dict(item)
            if wanted(res):
                print(fmt.format("-", res.metadata.namespace,
                                 res.metadata.name, _phase(res)),
                      flush=True)
        return data.get("resourceVersion", 0)

    print(fmt.format("EVENT", "NAMESPACE", "NAME", "STATUS"))
    rv = relist()
    from kubeflow_tpu_torch.testing.fake_apiserver import Gone

    try:
        while True:
            try:
                rv = _stream_rows(client, kind, params, rv, wanted, fmt)
            except Gone:
                rv = relist()  # horizon passed us: fresh table, new bookmark
    except KeyboardInterrupt:
        return 0


def _stream_rows(client: HttpApiClient, kind: str, params: dict, rv: int, wanted,
                 fmt: str) -> int:
    """Follow one streaming watch response from `rv`, printing a row per
    wanted event; returns the rv to resume from when the server ends the
    stream. Raises Gone on a 410 line."""
    import urllib.parse as _up

    from kubeflow_tpu_torch.testing.fake_apiserver import Gone

    query = _up.urlencode(dict(params, watch="true", stream="true", resourceVersion=rv))
    conn, resp = client._request_raw("GET", f"/apis/{kind}?{query}")
    try:
        if resp.status >= 400:
            client._raise_for_status(resp.status, resp.read().decode(errors="replace"))
        # The server bookmarks every few seconds: a silent peer past this
        # read timeout is a dead one.
        if conn.sock is not None:
            conn.sock.settimeout(30.0)
        while True:
            line = resp.readline()
            if not line:
                return rv
            event = json.loads(line)
            if event["type"] == "BOOKMARK":
                rv = event["resourceVersion"]
            elif event["type"] == "ERROR":
                if event.get("status") == 410:
                    raise Gone(event.get("message", "watch horizon"))
                raise ApiError(f"watch stream error {event.get('status')}: "
                               f"{event.get('message', '')}")
            else:
                rv = event["rv"]
                res = Resource.from_dict(event["object"])
                if wanted(res):
                    print(fmt.format(event["type"], res.metadata.namespace,
                                     res.metadata.name, _phase(res)), flush=True)
    finally:
        conn.close()


def _get_scoped(client: HttpApiClient, kind, name, namespace, version=None):
    """Fetch honoring scope: an explicit -n (including -n '') is taken
    verbatim; with no -n, try the default namespace then fall back to
    cluster scope, so `describe node tpu-node-0` works without the user
    spelling the empty namespace (kubectl ignores -n for cluster-scoped
    kinds; we have no client-side kind registry to know scope upfront)."""
    from kubeflow_tpu_torch.testing.fake_apiserver import Forbidden, NotFound

    if namespace is not None:
        return client.get(kind, name, namespace, version=version)
    try:
        return client.get(kind, name, "default", version=version)
    except NotFound:
        return client.get(kind, name, "", version=version)
    except Forbidden as denied:
        # A namespace-scoped token 403s the default-ns probe; the target
        # may still be a cluster-scoped object this identity CAN read
        # (`describe node x` with a node-reader token). Try cluster scope
        # before surfacing the denial.
        try:
            return client.get(kind, name, "", version=version)
        except (NotFound, Forbidden):
            raise denied from None


def cmd_describe(client: HttpApiClient, args) -> int:
    """kubectl-describe analog: the object, its conditions, and its
    mirrored Event timeline in one view (controllers emit Events the way
    `notebook_controller.go:87-103` mirrors them; the store keeps them as
    Event objects with spec.involvedObject back-references)."""
    # client passed so ambiguous plural derivations (`caches` vs
    # `churches`) resolve against live objects; no emptiness warning —
    # a wrong by-name kind already fails loudly with NotFound.
    kind = resolve_kind(args.kind, client, warn_empty=False)
    res = _get_scoped(client, kind, args.name, args.namespace, version=args.api_version)
    ns = res.metadata.namespace
    meta = res.metadata

    def emit_block(title: str, payload: dict) -> None:
        if not payload:
            return
        print(f"{title}:")
        text = yaml.safe_dump(payload, sort_keys=False, default_flow_style=False)
        for line in text.rstrip("\n").split("\n"):
            print(f"  {line}")

    print(f"Name:         {meta.name}")
    print(f"Namespace:    {meta.namespace}")
    print(f"Kind:         {res.kind}")
    print(f"API Version:  {res.api_version}")
    if meta.labels:
        print("Labels:       " + ",".join(
            f"{k}={v}" for k, v in sorted(meta.labels.items())
        ))
    if meta.creation_timestamp is not None:
        import datetime

        created = datetime.datetime.fromtimestamp(
            meta.creation_timestamp, datetime.timezone.utc
        )
        print(f"Created:      {created.strftime('%Y-%m-%dT%H:%M:%SZ')}")
    emit_block("Spec", res.spec or {})
    status = dict(res.status or {})
    conditions = status.pop("conditions", None)
    emit_block("Status", status)
    if conditions:
        print("Conditions:")
        widths = (24, 8)
        print(f"  {'Type':<{widths[0]}}{'Status':<{widths[1]}}Reason")
        for c in conditions:
            print(
                f"  {str(c.get('type', '')):<{widths[0]}}"
                f"{str(c.get('status', 'True')):<{widths[1]}}"
                f"{c.get('reason', '')}"
            )

    events = [
        e for e in client.list("Event", namespace=ns)
        if e.spec.get("involvedObject", {}).get("name") == meta.name
        and e.spec.get("involvedObject", {}).get("kind") == res.kind
        and (
            not e.spec["involvedObject"].get("uid")
            or not meta.uid
            or e.spec["involvedObject"]["uid"] == meta.uid
        )
    ]
    events.sort(key=lambda e: e.metadata.creation_timestamp or 0)
    print("Events:")
    if not events:
        print("  <none>")
        return 0
    rows = [
        (
            e.spec.get("type", "Normal"),
            e.spec.get("reason", ""),
            e.spec.get("message", ""),
        )
        for e in events
    ]
    w0 = max(len("Type"), max(len(r[0]) for r in rows))
    w1 = max(len("Reason"), max(len(r[1]) for r in rows))
    print(f"  {'Type':<{w0}}  {'Reason':<{w1}}  Message")
    for t, r, m in rows:
        print(f"  {t:<{w0}}  {r:<{w1}}  {m}")
    return 0


def cmd_top(client: HttpApiClient, args) -> int:
    """kubectl-top analog for the TPU fleet: per-node chip capacity,
    chips reserved by live pods, and the duty/utilization series the
    node health stack publishes — 'is the fleet busy' in one table."""
    nodes = client.list("Node", namespace="")
    reserved: dict[str, int] = {}
    for pod in client.list("Pod"):
        node = pod.spec.get("nodeName")
        if not node or pod.status.get("phase") in ("Succeeded", "Failed"):
            continue
        reserved[node] = reserved.get(node, 0) + container_limits_total(pod, ACCELERATOR_RESOURCE)
    rows = []
    for n in sorted(nodes, key=lambda n: n.metadata.name):
        chips = int(n.spec.get("chips", 0))
        used = reserved.get(n.metadata.name, 0)
        duty = n.status.get("tpuDutyCycle")
        cpu = n.status.get("cpuUtilization")
        rows.append((
            n.metadata.name,
            n.spec.get("pool", ""),
            f"{used}/{chips}",
            f"{duty * 100:.0f}%" if duty is not None else "-",
            f"{cpu * 100:.0f}%" if cpu is not None else "-",
            "Ready" if n.status.get("ready") else "NotReady",
        ))
    _print_table(
        ("NAME", "POOL", "CHIPS(USED/CAP)", "TPU-DUTY", "CPU", "STATUS"),
        rows,
    )
    total = sum(int(n.spec.get("chips", 0)) for n in nodes)
    node_names = {n.metadata.name for n in nodes}
    used_total = sum(
        used for node, used in reserved.items() if node in node_names
    )
    orphaned = sum(
        used for node, used in reserved.items() if node not in node_names
    )
    line = (f"# {used_total}/{total} chips reserved across "
            f"{len(nodes)} node(s)")
    if orphaned:
        # Pods bound to since-deleted nodes: not in any table row, so
        # they must not silently inflate (or contradict) the totals.
        line += f"; {orphaned} chip(s) on vanished node(s)"
    print(line)
    return 0


def cmd_apply(client: HttpApiClient, args) -> int:
    text = (
        sys.stdin.read() if args.filename == "-"
        else open(args.filename).read()
    )
    rc = 0
    for doc in yaml.safe_load_all(text):
        if not doc:
            continue
        res = Resource.from_dict(doc)
        try:
            try:
                client.create(res)
                action = "created"
            # Only "it exists already" falls through to update; anything
            # else (e.g. 422 validation) is the create's real error and
            # must surface as such, not as the fallback get's NotFound.
            except (AlreadyExists, Conflict):
                current = client.get(
                    res.kind, res.metadata.name, res.metadata.namespace
                )
                res.metadata.resource_version = (
                    current.metadata.resource_version
                )
                res.metadata.uid = current.metadata.uid
                client.update(res)
                action = "configured"
        except ApiError as e:
            print(f"error: {res.kind}/{res.metadata.name}: {e}",
                  file=sys.stderr)
            rc = 1
            continue
        print(f"{res.kind.lower()}/{res.metadata.name} {action}")
    return rc


def cmd_delete(client: HttpApiClient, args) -> int:
    kind = resolve_kind(args.kind, client, warn_empty=False)
    client.delete(kind, args.name, args.namespace)
    print(f"{kind.lower()}/{args.name} deleted")
    return 0


def cmd_logs(client: HttpApiClient, args) -> int:
    """kubectl-logs analog: the pod's captured stdout via the facade's
    kubelet-log-endpoint route. `--job` prints every worker of a TpuJob
    gang (rank-ordered), the multi-worker case kubectl has no one-shot
    answer for."""
    from kubeflow_tpu_torch.testing.fake_apiserver import NotFound

    names = [args.name]
    if args.job:
        pods = client.list(
            "Pod", args.namespace,
            label_selector={"kubeflow-tpu.org/job": args.name},
        )
        pods.sort(
            key=lambda p: int(
                p.metadata.labels.get("kubeflow-tpu.org/worker-index", "0")
            )
        )
        names = [p.metadata.name for p in pods]
        if not names:
            print(f"error: no pods for job {args.name!r}", file=sys.stderr)
            return 1
    rc = 0
    for name in names:
        if len(names) > 1:
            print(f"==> {name} <==")
        try:
            sys.stdout.write(
                client.pod_log(name, args.namespace or "default")
            )
        except NotFound as e:
            print(f"error: {name}: {e}", file=sys.stderr)
            rc = 1
    return rc


def cmd_traces(client: HttpApiClient, args) -> int:
    data = client._call("GET", "/debug/traces")
    for span in data.get("spans", []):
        dur = span.get("durationMs")
        dur_s = f"{dur:8.2f}ms" if isinstance(dur, (int, float)) else "    ?   "
        attrs = " ".join(
            f"{k}={v}" for k, v in (span.get("attributes") or {}).items()
        )
        err = f"  ERROR {span['error']}" if span.get("error") else ""
        print(f"{span['traceId']}  {dur_s}  {span['name']:<10} {attrs}{err}")
    if data.get("dropped"):
        print(f"# {data['dropped']} spans dropped (collector overflow)",
              file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="kftpu")
    parser.add_argument(
        "--server",
        default=os.environ.get("KFTPU_SERVER", DEFAULT_SERVER),
        help="apiserver facade URL, or a comma-separated endpoint "
        "list for an active-passive HA pair (env KFTPU_SERVER)",
    )
    parser.add_argument(
        "--token",
        default=None,
        help="bearer token for a secure facade (env KFTPU_TOKEN; the "
        "platform launcher prints/saves an admin token at boot)",
    )
    parser.add_argument(
        "--ca",
        default=None,
        help="platform CA certificate to pin for an https:// server "
        "(env KFTPU_CA; the launcher prints the path at boot). Tokens "
        "are refused over plaintext http unless KFTPU_ALLOW_PLAINTEXT=1",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    get = sub.add_parser("get", help="list a kind or fetch one object")
    get.add_argument("kind")
    get.add_argument("name", nargs="?")
    get.add_argument("-n", "--namespace", default=None,
                     help="narrow lists / locate a named object "
                     "(default: all namespaces for lists, 'default' "
                     "for a named get)")
    get.add_argument("-o", "--output", choices=("yaml", "json"))
    get.add_argument("--api-version", dest="api_version",
                     help="read at a served CRD version (e.g. v1alpha1)")
    get.add_argument("-w", "--watch", action="store_true",
                     help="print the table, then stream change events "
                     "(kubectl get -w analog; Ctrl-C to stop)")
    get.set_defaults(fn=cmd_get)

    describe = sub.add_parser(
        "describe",
        help="object + conditions + events timeline (kubectl describe)",
    )
    describe.add_argument("kind")
    describe.add_argument("name")
    describe.add_argument("-n", "--namespace", default=None)
    describe.add_argument("--api-version", dest="api_version",
                          help="read at a served CRD version (e.g. v1alpha1)")
    describe.set_defaults(fn=cmd_describe)

    top = sub.add_parser(
        "top", help="fleet chip usage by node (kubectl top analog)"
    )
    top.set_defaults(fn=cmd_top)

    apply_p = sub.add_parser("apply", help="create-or-update from YAML")
    apply_p.add_argument("-f", "--filename", required=True,
                         help="YAML file ('-' = stdin; multi-doc ok)")
    apply_p.set_defaults(fn=cmd_apply)

    delete = sub.add_parser("delete", help="delete one object")
    delete.add_argument("kind")
    delete.add_argument("name")
    delete.add_argument("-n", "--namespace", default="default")
    delete.set_defaults(fn=cmd_delete)

    logs = sub.add_parser("logs", help="print a pod's captured stdout")
    logs.add_argument("name", help="pod name (or job name with --job)")
    logs.add_argument("-n", "--namespace", default="default")
    logs.add_argument(
        "--job", action="store_true",
        help="treat NAME as a TpuJob and print every worker's log in "
        "rank order",
    )
    logs.set_defaults(fn=cmd_logs)

    traces = sub.add_parser("traces", help="drain control-plane trace spans")
    traces.set_defaults(fn=cmd_traces)

    args = parser.parse_args(argv)
    try:
        client = HttpApiClient(
            endpoints_from_env(args.server), token=args.token, ca=args.ca
        )
    except ValueError as e:  # e.g. token-over-plaintext refusal
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        return args.fn(client, args)
    except PermissionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except ApiError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0  # downstream pager/head closed the pipe; not an error
    except OSError as e:
        print(f"error: cannot reach {args.server}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
