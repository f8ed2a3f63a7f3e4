"""The controller-manager binary: the port's controllers in one process
against the apiserver facade.

Counterpart of `kubeflow_tpu/controllers/__main__.py`:

    python -m kubeflow_tpu_torch.controllers \
        --apiserver https://<facade-a>,https://<facade-b> --ca <ca.crt> \
        [--controllers profile,notebook,tensorboard,tpujob,nodehealth,study,...] \
        [--leader-elect [--lease-name N] [--identity I]] \
        [--write-retries N] [--breaker-cooldown S] [--stream-reprobe S] \
        [--stream-failure-threshold N] [--stream-degraded S]

builds each named controller on one `HttpApiClient` (its watch feeds
every controller's queue), starts them, prints ``manager ready
<names>`` and then ``plane {json}`` (`runtime.plane_report`: each controller's
work-queue backend, ``native`` for the compiled queue, and the TpuJob
operator's ``tpujob_gang_placements_total`` by scheduler backend), and
reconciles until SIGTERM or SIGINT, then stops the controllers, prints
``plane {json}`` again and ``client {json}`` (its failovers, the connections
it dialed, its write retries and its watch's counters,
`HttpApiClient.watch_stats`: streams opened and failed, long-poll
rounds, degraded episodes and seconds, streams opened after one) and
exits 0. SIGUSR1 dumps every thread's stack and prints the ``plane``
and ``client`` lines without stopping anything (`JobPlane.stall_report` sends it). The
client flags are JAX's: bounded write retries, the
per-endpoint breakers' cooldown and the re-probe of a rejected stream.
Two more, which JAX's binary lacks (it leaves them at the client's
defaults), set the stream breaker: the failed streams in a row before
the watch degrades to long-poll, and for how long. They exist for the
chaos scenario (`testing/chaos_job.py`), where the binary is a process
of its own, so the in-process constructor arguments JAX's chaos soak
passes cannot reach its client. There one failed stream must degrade
the watch: at the soak's threshold of 2, the seed-0 schedule's stream
faults never fail two of the binary's streams in a row, and its watch
never degrades. `--apiserver` is one URL or an
endpoint list (an active-passive facade pair, `testing/failover.py`):
the client fails over between them.
An https endpoint needs the platform CA, `--ca` (default ``KFTPU_CA``).

With ``--leader-elect``, N replicas run with one active (the Lease and
write fencing, `controllers/leader.py`): a replica prints ``standby
<identity>`` and reconciles nothing, and builds no controller, until it
holds the Lease; then it arms the client's lease guard with its term,
prints ``leading <identity> gen <transitions>`` and starts the
controllers. On SIGTERM it stops them, releases the Lease and exits 0;
on losing the Lease it prints ``deposed <identity>`` and exits 2, since a
deposed manager's in-flight state belongs to a dead term and its
supervisor starts a fresh standby.

`CONTROLLERS` holds every controller the JAX binary runs, in its
order, and `--controllers` defaults to all of them: the tenant
controllers, Profile (a user's namespace, its RBAC and quota, with a
finalizer), Notebook (a StatefulSet, Service and VirtualService, with
the culler off) and Tensorboard (a Deployment, Service and
VirtualService), the TpuJob operator, the node-health watchdog (pods on
a lost Node fail with reason NodeLost, so their gang restarts), the
Study controller, the pipeline controllers, Workflow (a DAG of step
pods and TpuJob slice steps) and CronWorkflow (Workflows spawned on a
schedule, on the wall clock), and the ServingDeployment controller. An
unknown name is refused. Against a secure facade the client's bearer
token comes from ``KFTPU_TOKEN``, as in JAX.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import logging
import os
import signal
import sys

from kubeflow_tpu_torch.controllers.cronworkflow import CronWorkflowController
from kubeflow_tpu_torch.controllers.nodehealth import NodeHealthController
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.controllers.profile import ProfileController
from kubeflow_tpu_torch.controllers.runtime import ControllerManager, plane_report
from kubeflow_tpu_torch.controllers.serving import ServingDeploymentController
from kubeflow_tpu_torch.controllers.study import StudyController
from kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
from kubeflow_tpu_torch.controllers.workflow import WorkflowController

CONTROLLERS = {
    "profile": ProfileController,
    "notebook": NotebookController,
    "tensorboard": TensorboardController,
    "tpujob": TpuJobController,
    "nodehealth": NodeHealthController,
    "study": StudyController,
    "workflow": WorkflowController,
    "cronworkflow": CronWorkflowController,
    "serving": ServingDeploymentController,
}


# What prints the client's counters, once main() has built the client.
_reporters: list = []



def main(argv: list[str] | None = None) -> int:
    from kubeflow_tpu_torch.controllers.leader import LeaderElector
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.utils import signals as sigutil

    parser = argparse.ArgumentParser(prog="kubeflow-tpu-torch-controllers")
    parser.add_argument("--apiserver", required=True,
                        help="the facade's URL, or a comma-separated endpoint list "
                        "(http:// or https://)")
    parser.add_argument("--ca", default=None,
                        help="the platform CA that https endpoints are verified against "
                        "(default: KFTPU_CA)")
    parser.add_argument("--controllers", default=",".join(CONTROLLERS),
                        help="comma-separated subset to run (default: all)")
    parser.add_argument(
        "--leader-elect", action="store_true",
        help="N replicas, one active: stand by until the Lease is held, arm "
        "write fencing, exit 2 on losing it")
    parser.add_argument("--lease-name", default="controller-manager")
    parser.add_argument("--identity", default=None,
                        help="leader-election identity (default: controllers-<pid>)")
    parser.add_argument("--lease-duration", type=float, default=15.0)
    parser.add_argument("--renew-deadline", type=float, default=10.0)
    parser.add_argument("--retry-period", type=float, default=2.0)
    # The client's fault tolerance: bounded write retries (guarded by
    # resourceVersion preconditions, never double-applying), the
    # per-endpoint breakers, and the watch's degraded mode.
    parser.add_argument("--write-retries", type=int, default=3,
                        help="extra attempts for a transient write failure")
    parser.add_argument("--breaker-cooldown", type=float, default=2.0,
                        help="seconds a tripped per-endpoint circuit sheds load before "
                        "probing the endpoint again")
    parser.add_argument("--stream-reprobe", type=float, default=60.0,
                        help="seconds between re-probes of the streaming watch after the "
                        "server rejects it (the long-poll fallback is never sticky)")
    # The stream breaker, for the chaos scenario (see above).
    parser.add_argument("--stream-failure-threshold", type=int, default=3,
                        help="failed streams in a row that degrade the watch to long-poll")
    parser.add_argument("--stream-degraded", type=float, default=5.0,
                        help="seconds the degraded watch long-polls before it probes the "
                        "stream again")
    args = parser.parse_args(argv)

    names = [n.strip() for n in args.controllers.split(",") if n.strip()]
    unknown = [n for n in names if n not in CONTROLLERS]
    if unknown:
        parser.error(f"unknown controllers {unknown}; valid: {sorted(CONTROLLERS)}")

    try:
        client = HttpApiClient(
            endpoints_from_env(args.apiserver), ca=args.ca, watch_poll_timeout=2.0,
            watch_retry=0.1, write_retries=args.write_retries,
            breaker_cooldown=args.breaker_cooldown,
            stream_reprobe_seconds=args.stream_reprobe,
            stream_failure_threshold=args.stream_failure_threshold,
            stream_degraded_seconds=args.stream_degraded)
    except ValueError as e:
        parser.error(str(e))
    shutdown = sigutil.install_shutdown_handlers()

    def report_client() -> None:
        print("client " + json.dumps({"failovers": client.failovers,
                                      "handshakes": client.handshakes,
                                      "retries": client.retries_total,
                                      "watch": client.watch_stats()}), flush=True)

    built: list = []

    def report_plane() -> None:
        print("plane " + json.dumps(plane_report(built)), flush=True)

    _reporters.extend([report_plane, report_client])

    def start_manager() -> ControllerManager:
        # Built only once this replica is active: construction registers
        # the watches and lists, and a standby reconciles nothing.
        manager = ControllerManager()
        for name in names:
            built.append(CONTROLLERS[name](client))
            manager.add(built[-1].controller)
        manager.start()
        print(f"manager ready {','.join(names)}", flush=True)
        report_plane()
        return manager

    if not args.leader_elect:
        manager = start_manager()
        sigutil.wait_for_shutdown(shutdown)
        manager.stop()
        report_plane()
        report_client()
        client.close()
        return 0

    elector = LeaderElector(
        client, args.lease_name, args.identity or f"controllers-{os.getpid()}",
        lease_duration=args.lease_duration, renew_deadline=args.renew_deadline,
        retry_period=args.retry_period)
    print(f"standby {elector.identity}", flush=True)
    manager = None

    def on_lead(el) -> None:
        nonlocal manager
        client.set_lease_guard(el.guard)
        print(f"leading {el.identity} gen {el.transitions}", flush=True)
        manager = start_manager()

    lost = elector.run(shutdown, on_lead)
    if manager is not None:
        manager.stop()
    report_plane()
    report_client()
    if lost:
        print(f"deposed {elector.identity}", flush=True)
        return 2
    client.close()
    return 0


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO if os.environ.get("KFTPU_DEBUG") else logging.WARNING
    )
    # SIGUSR1 dumps every thread's stack, then the client's counters: a
    # stalled plane's report asks for both. Installed here, not in main(),
    # so that a test calling main() keeps its own handlers.
    signal.signal(signal.SIGUSR1, lambda signum, frame: [r() for r in _reporters])
    faulthandler.register(signal.SIGUSR1, chain=True)
    sys.exit(main())
