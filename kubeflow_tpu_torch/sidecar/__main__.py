"""Sidecar CLI, the counterpart of `python -m kubeflow_tpu.sidecar`:

    python -m kubeflow_tpu_torch.sidecar \
        --workdir /kubeflow-tpu/data --job myjob --namespace team \
        [--apiserver http://host:port] [--coordinator host:port] \
        [--results /out --artifacts /store]

Main-container entrypoints block on the SIGCONT file in --workdir before
they start, and exit when SIGTERM appears. The sidecar exits 0 when the
job ended Succeeded, else 1.

`--apiserver` takes one http:// endpoint: the port's client refuses an
endpoint list (active-passive failover and TLS are not ported), and so
does this flag, with an error.
"""

from __future__ import annotations

import argparse
import logging
import sys

from kubeflow_tpu_torch.sidecar.controller import (
    SidecarController,
    default_device_probe,
    local_dir_uploader,
)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-sidecar")
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--job", required=True)
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--coordinator", default=None,
                        help="the gang's torch.distributed rendezvous host:port")
    parser.add_argument(
        "--apiserver",
        default=None,
        help="API server base URL (one http:// endpoint) to watch the TpuJob "
        "phase (e.g. http://apiserver:8001)",
    )
    parser.add_argument("--results", default=None)
    parser.add_argument("--artifacts", default=None)
    parser.add_argument("--poll-seconds", type=float, default=10.0)
    parser.add_argument("--timeout-seconds", type=float, default=600.0)
    parser.add_argument(
        "--skip-device-probe",
        action="store_true",
        help="don't wait for a CUDA device (CPU smoke tests)",
    )
    args = parser.parse_args(argv)
    if args.apiserver and "," in args.apiserver:
        parser.error(
            f"--apiserver takes one endpoint, got {args.apiserver!r}: endpoint "
            "lists (active-passive failover) are not ported"
        )
    logging.basicConfig(level=logging.INFO)

    api = None
    if args.apiserver:
        from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient

        api = HttpApiClient(args.apiserver.strip())

    controller = SidecarController(
        workdir=args.workdir,
        job_name=args.job,
        namespace=args.namespace,
        api=api,
        coordinator=args.coordinator,
        device_probe=(lambda: True) if args.skip_device_probe else default_device_probe,
        upload=local_dir_uploader(args.artifacts) if args.artifacts else None,
        poll_seconds=args.poll_seconds,
        timeout_seconds=args.timeout_seconds,
    )
    try:
        phase = controller.run(results_dir=args.results)
    finally:
        if api is not None:
            api.close()
    print(f"sidecar: job {args.job} terminal phase: {phase}", flush=True)
    return 0 if phase == "Succeeded" else 1


if __name__ == "__main__":
    sys.exit(main())
