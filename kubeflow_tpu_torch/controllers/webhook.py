"""The standalone admission-webhook server — PodDefault's own process.

A copy of `kubeflow_tpu/controllers/webhook.py` (a module with no JAX in
it), whole; its binary is ``python -m
kubeflow_tpu_torch.controllers.webhook``.

Parity with the reference's admission webhook, which is NOT a library
inside the apiserver but a separate TLS server the apiserver calls out
to (`admission-webhook/main.go:443` raw TLS listener, `:447` mutatePods,
`:597` main), registered via a webhook configuration with timeout and
failure-policy semantics. This module is that boundary for our control
plane:

- `MutatingWebhookApp` serves the callout protocol the store speaks
  (`fake_apiserver._webhook_admit`): POST /mutate with
  ``{"object": {...}, "operation": "CREATE"|"UPDATE"}`` returns
  ``{"allowed": true, "object": mutated}`` or
  ``{"allowed": false, "message": ...}``;
- `main()` runs the PodDefault mutator in its OWN process: it reads
  PodDefault CRs through the authenticated facade (HttpApiClient with a
  least-privilege token), serves /mutate over its own TLS cert, and —
  with ``--register`` — creates the WebhookConfiguration pointing at
  itself, so `python -m kubeflow_tpu_torch.controllers.webhook` is the whole
  deployment.

With this, admission is no longer the one extension point that had to
link into the apiserver process: a third-party mutator is a server plus
one CR.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Callable

from kubeflow_tpu_torch.api.objects import Resource, new_resource
from kubeflow_tpu_torch.controllers import poddefault
from kubeflow_tpu_torch.testing.fake_apiserver import Invalid
from kubeflow_tpu_torch.web.wsgi import App, Request, Response, json_response

log = logging.getLogger(__name__)

# mutate(obj, operation) -> mutated obj; raise Invalid to DENY.
Mutator = Callable[[Resource, str], Resource]


class MutatingWebhookApp(App):
    """Serves the store's admission-callout protocol over one route."""

    def __init__(self, mutate: Mutator, name: str = "admission-webhook"):
        super().__init__(name)
        self._mutate = mutate
        self.add_route("/mutate", self.mutate_route, ("POST",))

    def mutate_route(self, req: Request) -> Response:
        body = req.json()
        obj = Resource.from_dict(body["object"])
        operation = body.get("operation", "CREATE")
        try:
            mutated = self._mutate(obj, operation)
        except Invalid as e:
            # An explicit denial — distinct from a 5xx, which the caller
            # treats as webhook FAILURE under its failurePolicy.
            return json_response({"allowed": False, "message": str(e)})
        return json_response({"allowed": True, "object": mutated.to_dict()})


def make_webhook_config(
    name: str,
    url: str,
    ca_bundle: str,
    kinds: tuple[str, ...] = ("Pod",),
    *,
    failure_policy: str = "Fail",
    timeout_seconds: float = 5.0,
    namespaces: tuple[str, ...] = (),
    match_labels: dict[str, str] | None = None,
) -> Resource:
    """The WebhookConfiguration CR the store's admission phase consumes
    (the MutatingWebhookConfiguration analog; cluster-scoped).
    `ca_bundle` should be the PEM data itself (like the K8s caBundle
    field, which embeds base64 PEM in the config object) so a config
    created by a remote client is self-contained; a local file path is
    accepted as a legacy convenience and inlined here when readable.
    `namespaces` scopes callouts to those namespaces (the
    namespaceSelector analog; empty = all); `match_labels` is the
    objectSelector — only matching objects are sent."""
    from kubeflow_tpu_torch.web.tls import is_pem_data

    if not is_pem_data(ca_bundle):
        try:
            with open(ca_bundle, "r", encoding="utf-8") as f:
                ca_bundle = f.read()
        except OSError as e:
            raise ValueError(
                f"ca_bundle is neither PEM data nor a readable file: "
                f"{ca_bundle!r} ({e})"
            ) from e
    spec = {
        "url": url,
        "caBundle": ca_bundle,
        "kinds": list(kinds),
        "failurePolicy": failure_policy,
        "timeoutSeconds": timeout_seconds,
    }
    if namespaces:
        spec["namespaces"] = list(namespaces)
    if match_labels:
        spec["selector"] = {"matchLabels": dict(match_labels)}
    return new_resource("WebhookConfiguration", name, "", spec=spec)


def main(argv: list[str] | None = None) -> int:
    """The PodDefault webhook binary (`main.go:597` analog)."""
    from kubeflow_tpu_torch.testing.apiserver_http import (
        HttpApiClient,
        endpoints_from_env,
    )
    from kubeflow_tpu_torch.web import tls as tlsmod
    from kubeflow_tpu_torch.web.wsgi import serve

    parser = argparse.ArgumentParser(prog="kubeflow-tpu-webhook")
    parser.add_argument(
        "--apiserver", required=True,
        help="facade URL — or comma-separated HA endpoint list — for "
        "reading PodDefault CRs (token via KFTPU_TOKEN, CA via "
        "KFTPU_CA — the launcher env contract)",
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument(
        "--tls-dir", required=True,
        help="directory for this webhook's OWN serving cert (minted on "
        "first boot; its ca.crt is the caBundle the apiserver pins)",
    )
    parser.add_argument(
        "--register", action="store_true",
        help="create/refresh the WebhookConfiguration pointing at this "
        "server (needs create+update on webhookconfigurations)",
    )
    parser.add_argument("--name", default="poddefault-webhook")
    parser.add_argument(
        "--failure-policy", choices=("Fail", "Ignore"), default="Fail"
    )
    parser.add_argument(
        "--leader-elect", action="store_true",
        help="run as one of N replicas with exactly one active: block "
        "in standby until the webhook Lease is acquired, then serve and "
        "register; exit on leadership loss so the supervisor restarts "
        "fresh (the -enable-leader-election flag every reference "
        "controller ships, notebook-controller/main.go:51-62)",
    )
    parser.add_argument(
        "--identity", default=None,
        help="leader-election identity (default: <name>-<pid>)",
    )
    args = parser.parse_args(argv)

    client = HttpApiClient(endpoints_from_env(args.apiserver))

    def mutate(obj: Resource, operation: str) -> Resource:
        # Same semantics as the in-process hook, but the PodDefault
        # reads cross the process boundary through the secure facade.
        return poddefault.mutate_pod(client, obj)

    paths = tlsmod.ensure_tls_dir(
        args.tls_dir, hosts=("localhost", args.host)
        if args.host not in ("localhost", "127.0.0.1")
        else ("localhost", "127.0.0.1"),
    )
    from kubeflow_tpu_torch.utils import signals as sigutil

    shutdown = sigutil.install_shutdown_handlers()

    elector = None
    if args.leader_elect:
        from kubeflow_tpu_torch.controllers.leader import LeaderElector

        elector = LeaderElector(
            client,
            f"{args.name}-webhook-leader",
            args.identity or f"{args.name}-{os.getpid()}",
        )
        print(f"standby {elector.identity}", flush=True)
        if not elector.acquire(shutdown):
            return 0  # shut down while in standby
        # Registration (the write that aims admission traffic at this
        # replica) is fenced to this term: a deposed replica racing the
        # successor's re-registration gets a Conflict, not the traffic.
        client.set_lease_guard(elector.guard)

    server, _ = serve(
        MutatingWebhookApp(mutate), host=args.host, port=args.port,
        tls=paths,
    )
    url = f"https://{args.host}:{server.server_port}/mutate"
    if args.register:
        client.apply(
            make_webhook_config(
                args.name, url, paths.ca_cert,
                failure_policy=args.failure_policy,
            )
        )
    print(f"webhook ready {server.server_port}", flush=True)
    if elector is not None:
        elector.hold(shutdown)  # returns on shutdown OR leadership loss
        lost = not shutdown.is_set()
        server.shutdown()
        if lost:
            print("deposed", flush=True)
            return 2  # die; the supervisor restarts a fresh standby
        elector.release()
        return 0
    sigutil.wait_for_shutdown(shutdown)
    server.shutdown()
    return 0


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO if os.environ.get("KFTPU_DEBUG") else logging.WARNING
    )
    sys.exit(main())
