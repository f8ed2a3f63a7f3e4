"""The controller-manager binary: the port's controllers in one process
against the apiserver facade.

Counterpart of `kubeflow_tpu/controllers/__main__.py`:

    python -m kubeflow_tpu_torch.controllers \
        --apiserver http://<facade> [--controllers tpujob,study,serving]

builds each named controller on one `HttpApiClient` (its streaming
watch feeds every controller's queue), starts them, prints ``manager
ready <names>`` and reconciles until SIGTERM or SIGINT, then stops the
controllers and exits 0.

`CONTROLLERS` holds the ported controllers. A controller the JAX binary
runs and the port has not ported yet is refused as "not yet ported";
any other name as unknown. Not ported yet: ``--leader-elect`` (the Lease
and write fencing, `controllers/leader.py`), TLS and tokens, endpoint
failover and the client's fault-tolerance flags (ROADMAP).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from kubeflow_tpu_torch.controllers.runtime import ControllerManager
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.controllers.study import StudyController
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController

CONTROLLERS = {
    "tpujob": TpuJobController,
    "study": StudyController,
    "serving": ServingDeploymentController,
}
# The JAX binary's other controllers, not ported yet.
NOT_YET_PORTED = ("profile", "notebook", "tensorboard", "nodehealth", "workflow",
                  "cronworkflow")


def main(argv: list[str] | None = None) -> int:
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient
    from kubeflow_tpu_torch.utils import signals as sigutil

    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-controllers")
    parser.add_argument("--apiserver", required=True,
                        help="the facade's URL (one http:// endpoint)")
    parser.add_argument("--controllers", default=",".join(CONTROLLERS),
                        help="comma-separated subset to run (default: all ported)")
    args = parser.parse_args(argv)

    names = [n.strip() for n in args.controllers.split(",") if n.strip()]
    unported = [n for n in names if n in NOT_YET_PORTED]
    if unported:
        parser.error(f"controllers {unported} are not yet ported to the PyTorch "
                     f"package; ported: {sorted(CONTROLLERS)}")
    unknown = [n for n in names if n not in CONTROLLERS]
    if unknown:
        parser.error(f"unknown controllers {unknown}; valid: {sorted(CONTROLLERS)}")

    client = HttpApiClient(args.apiserver)
    shutdown = sigutil.install_shutdown_handlers()
    manager = ControllerManager()
    for name in names:
        manager.add(CONTROLLERS[name](client).controller)
    manager.start()
    print(f"manager ready {','.join(names)}", flush=True)
    sigutil.wait_for_shutdown(shutdown)
    manager.stop()
    client.close()
    return 0


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO if os.environ.get("KFTPU_DEBUG") else logging.WARNING
    )
    sys.exit(main())
