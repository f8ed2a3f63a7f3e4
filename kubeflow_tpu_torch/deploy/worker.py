"""Per-deployment deploy worker — the kfctl-pod analog, as a process.

Counterpart of `kubeflow_tpu/deploy/worker.py`, whole, its imports
pointed at the port. It imports no torch. One departure: the kill
drill's ``KFTPU_WORKER_APPLY_DELAY`` holds the worker between the
PLATFORM and K8S phases (the pool's Nodes written, no bundle object
yet), where JAX's worker sleeps before the apply begins, so a SIGKILL
in the window lands in the middle of an apply.

The reference's router spawns one kfctl StatefulSet PER DEPLOYMENT
(`bootstrap/cmd/bootstrap/app/router.go:275`) so a crash or leak in one
deployment's apply can never take down the service or its neighbors;
each kfctl serializes its own deployment's applies
(`kfctlServer.go:311-330`). This module is that pod's main loop:

    python -m kubeflow_tpu_torch.deploy.worker --apiserver URL --name NAME

All state lives in the `PlatformDeployment` CR (spec.platformSpec is the
desired platform, metadata.generation the desired version,
status.observedGeneration the applied version), so a SIGKILLed worker
recovers by reading the CR and re-applying — `apply_platform` is
idempotent end to end. The credential arrives as KFTPU_TOKEN (the pod
serviceaccount-token analog); provider selection mirrors the server's
(fake materializes Nodes through the facade, gke sends real container-v1
payloads through an AuthTransport).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

from kubeflow_tpu_torch.deploy.apply import apply_platform, retry_rmw
from kubeflow_tpu_torch.deploy.kfdef import PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import FakeCloud
from kubeflow_tpu_torch.testing.apiserver_http import (
    HttpApiClient,
    endpoints_from_env,
)
from kubeflow_tpu_torch.testing.fake_apiserver import NotFound

log = logging.getLogger(__name__)

KIND = "PlatformDeployment"


def cloud_for(spec: PlatformSpec, args) -> object:
    if spec.provider == "gke":
        from kubeflow_tpu_torch.deploy.credentials import transport_from_flags
        from kubeflow_tpu_torch.deploy.gke import GkeCloud, RecordingTransport

        transport = transport_from_flags(
            args.gke_token_file, args.gke_api_base
        )
        return GkeCloud(transport or RecordingTransport())
    return FakeCloud  # instantiated with the client below


def reconcile_once(client: HttpApiClient, name: str, args) -> bool:
    """Apply the CR's desired generation if unobserved; True if work was
    done. Crash-safe: observedGeneration is stamped only after a
    completed apply, so a killed worker redoes the generation."""
    try:
        dep = client.get(KIND, name, "")
    except NotFound:
        return False
    spec_dict = dep.spec.get("platformSpec")
    generation = dep.metadata.generation
    if not spec_dict or dep.status.get("observedGeneration") == generation:
        return False
    spec = PlatformSpec.from_dict(spec_dict)
    cloud = cloud_for(spec, args)
    if cloud is FakeCloud:
        cloud = FakeCloud(client)
    # Test seam: lets e2e tests widen the kill window of a SIGKILL-
    # mid-apply drill without slowing real applies.
    delay = float(os.environ.get("KFTPU_WORKER_APPLY_DELAY", "0") or 0)
    result = apply_platform(
        spec, client, cloud,
        between_phases=(lambda: time.sleep(delay)) if delay else None)

    def stamp(fresh):
        fresh.status["observedGeneration"] = generation

    # Losing the stamp would re-run the (completed) apply on every poll
    # forever; retry_rmw raises after exhaustion so the main loop logs
    # and retries the whole reconcile instead of silently spinning.
    retry_rmw(client, KIND, name, "", stamp, client.update_status)
    log.info("%s: applied generation %s (succeeded=%s)",
             name, generation, result.succeeded)
    return True


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-deploy-worker")
    parser.add_argument(
        "--apiserver", required=True,
        help="facade URL, or comma-separated HA endpoint list",
    )
    parser.add_argument("--name", required=True)
    parser.add_argument("--poll", type=float, default=0.2,
                        help="seconds between CR checks")
    parser.add_argument("--once", action="store_true",
                        help="reconcile once and exit (tests)")
    parser.add_argument("--gke-token-file", default=None)
    parser.add_argument("--gke-api-base", default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    client = HttpApiClient(endpoints_from_env(args.apiserver))
    print("worker ready", flush=True)
    while True:
        try:
            reconcile_once(client, args.name, args)
        except Exception:
            # One bad apply must not kill the worker loop — the CR still
            # carries the desired state; the next pass retries.
            log.exception("%s: reconcile failed", args.name)
        if args.once:
            return 0
        time.sleep(args.poll)


if __name__ == "__main__":
    sys.exit(main())
