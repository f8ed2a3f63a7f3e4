"""Deploy CLI — the kfctl binary analog.

Counterpart of `kubeflow_tpu/deploy/__main__.py`, whole, its imports
pointed at the port. It imports no torch.

    python -m kubeflow_tpu_torch.deploy apply  -f platform.yaml [--dry-run]
    python -m kubeflow_tpu_torch.deploy delete -f platform.yaml
    python -m kubeflow_tpu_torch.deploy generate > platform.yaml   # default spec
    python -m kubeflow_tpu_torch.deploy serve  --port 8085         # deploy service

Mode dispatch mirrors `bootstrap/cmd/bootstrap/app/server.go:293-344`
(router | kfctl | gc); apply/delete are the kfctl-CLI-style one-shots.
Local mode runs against an in-process API server + FakeCloud and prints
what was applied — the real-cluster provider slots in behind
`CloudProvider`.
"""

from __future__ import annotations

import argparse
import sys
from kubeflow_tpu_torch.deploy.apply import apply_platform, delete_platform
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec, default_spec
from kubeflow_tpu_torch.deploy.provisioner import FakeCloud
from kubeflow_tpu_torch.deploy.server import DeployServer
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.utils import signals
from kubeflow_tpu_torch.web.wsgi import serve


def main() -> int:
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-deploy")
    sub = parser.add_subparsers(dest="mode", required=True)
    def gke_flags(p):
        # The TokenSource slot (kfctlServer.go:179-201): a bearer token
        # read from a file + an optional API-base override (fake GKE
        # server in tests; the real container API by default).
        p.add_argument("--gke-token-file", default=None,
                       help="file holding the GCP bearer token for "
                       "provider=gke specs")
        p.add_argument("--gke-api-base", default=None,
                       help="override the container API base URL "
                       "(testing against a fake GKE server)")

    for mode in ("apply", "delete"):
        p = sub.add_parser(mode)
        p.add_argument("-f", "--file", required=True)
        gke_flags(p)
        if mode == "apply":
            p.add_argument(
                "--dry-run",
                action="store_true",
                help="print the GKE API payloads the PLATFORM phase would "
                "send (cluster + GPU node pools) and the K8S resource "
                "count, without applying anything",
            )
    sub.add_parser("generate")
    p = sub.add_parser("serve")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8085)
    p.add_argument(
        "--worker-mode", choices=("thread", "process"), default="process",
        help="per-deployment worker isolation: 'process' spawns one "
        "worker process per deployment (the router.go:275 "
        "kfctl-pod-per-deployment analog; crash containment + respawn "
        "recovery), 'thread' runs applies in-process",
    )
    gke_flags(p)
    args = parser.parse_args()

    if args.mode == "generate":
        print(default_spec().to_yaml(), end="")
        return 0

    api = FakeApiServer()
    cloud = FakeCloud(api)

    def gke_transport():
        from kubeflow_tpu_torch.deploy.credentials import transport_from_flags

        return transport_from_flags(args.gke_token_file, args.gke_api_base)

    if args.mode == "serve":
        worker_args = []
        if args.gke_token_file:
            worker_args += ["--gke-token-file", args.gke_token_file]
        if args.gke_api_base:
            worker_args += ["--gke-api-base", args.gke_api_base]
        deploy_server = DeployServer(
            api, cloud, gke_transport=gke_transport(),
            worker_mode=args.worker_mode,
            worker_args=tuple(worker_args),
        )
        # Graceful stop on SIGTERM/SIGINT (see utils/signals.py for the
        # event-based + installed-early + poll-not-park rationale).
        stop_requested = signals.install_shutdown_handlers()
        server, _ = serve(deploy_server, host=args.host, port=args.port)
        print(f"deploy-server: http://{args.host}:{server.server_port}")
        signals.wait_for_shutdown(stop_requested)
        # Workers first: orphaned per-deployment processes would poll
        # the dead facade forever.
        deploy_server.shutdown_workers()
        server.shutdown()
        return 0

    with open(args.file) as f:
        spec = PlatformSpec.from_yaml(f.read())
    if args.mode == "apply" and args.dry_run:
        from kubeflow_tpu_torch.deploy.bundles import bundle_resources
        from kubeflow_tpu_torch.deploy.gke import dry_run_requests

        for request in dry_run_requests(spec):
            print(request.to_json())
        print(
            f"# K8S phase would apply {len(bundle_resources(spec))} "
            f"resources from bundles: {', '.join(spec.applications)}"
        )
        return 0
    if spec.provider == "gke":
        from kubeflow_tpu_torch.deploy.gke import GkeCloud, RecordingTransport

        cloud = GkeCloud(gke_transport() or RecordingTransport())
    if args.mode == "apply":
        result = apply_platform(spec, api, cloud)
        nodes = api.list("Node", "")
        deployments = api.list("Deployment", "kubeflow")
        print(
            f"{spec.name}: succeeded={result.succeeded} "
            f"resources={result.applied_count} nodes={len(nodes)} "
            f"deployments={len(deployments)}"
        )
        return 0 if result.succeeded else 1
    delete_platform(spec, api, cloud)
    print(f"{spec.name}: deleted")
    return 0


if __name__ == "__main__":
    sys.exit(main())
