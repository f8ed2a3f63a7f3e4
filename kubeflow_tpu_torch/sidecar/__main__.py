"""Sidecar CLI, the counterpart of `python -m kubeflow_tpu.sidecar`:

    python -m kubeflow_tpu_torch.sidecar \
        --workdir /kubeflow-tpu/data --job myjob --namespace team \
        [--apiserver https://a:port,https://b:port --ca ca.crt] \
        [--coordinator host:port] [--results /out --artifacts /store]

Main-container entrypoints block on the SIGCONT file in --workdir before
they start, and exit when SIGTERM appears. The sidecar exits 0 when the
job ended Succeeded, else 1.

`--apiserver` takes one URL or an endpoint list (an active-passive
facade pair), http:// or https://; an https endpoint needs the platform
CA, `--ca` (default ``KFTPU_CA``), or the CLI exits 2 before it touches
the work directory.
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
        help="API server URL, or a comma-separated endpoint list, to watch the "
        "TpuJob phase (e.g. https://apiserver-a:8001,https://apiserver-b:8001)",
    )
    parser.add_argument("--ca", default=None,
                        help="the platform CA that https endpoints are verified against "
                        "(default: KFTPU_CA)")
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
    api = None
    if args.apiserver:
        from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env

        try:
            api = HttpApiClient(endpoints_from_env(args.apiserver), ca=args.ca)
        except ValueError as e:
            parser.error(str(e))
    logging.basicConfig(level=logging.INFO)

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
