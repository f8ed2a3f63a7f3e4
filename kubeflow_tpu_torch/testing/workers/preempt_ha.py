"""A leader-elected TpuJob-operator replica that can stall mid-preemption.

Counterpart of the JAX package's `tests/e2e/preempt_ha_worker.py`: run N
copies against one apiserver facade and exactly one runs the real
`TpuJobController` (placement, priority preemption, the whole
reconcile); the others stand by in the Lease's acquire loop. On
acquiring, the worker arms its client's lease guard, so every write of
its term is fenced at the store.

``KFTPU_PREEMPT_STALL`` (seconds) widens the window preemption has
between its evictions and the preemptor's placement (the controller's
`preempt_stall` seam, after the evictions have committed); the worker
prints ``evicted <identity>`` on entering it, so a driver knows when to
kill or stop it there. The stall lives in this worker, never in the
binary.

    python -m kubeflow_tpu_torch.testing.workers.preempt_ha

Env: ``KFTPU_APISERVER`` (the facade's URL or endpoint list), ``KFTPU_IDENTITY``,
``KFTPU_LEASE_NAME`` (default ``tpujob-controller``),
``KFTPU_LEASE_DURATION`` (3), ``KFTPU_RENEW_DEADLINE`` (2),
``KFTPU_PREEMPT_STALL`` (0). It prints ``standby <identity>``, then
``leading <identity> gen <transitions>`` once it holds the Lease, then
the binary's ``plane {json}`` line (its work-queue backend and its gang
placements by scheduler backend, `controllers.runtime.plane_report`),
again just before each ``evicted`` line (the leader may be killed in the
stall) and at exit; it exits 0 on SIGTERM and, printing ``deposed
<identity>``, 2 on losing the Lease.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time


def main() -> int:
    from kubeflow_tpu_torch.controllers.leader import LeaderElector
    from kubeflow_tpu_torch.controllers.runtime import plane_report
    from kubeflow_tpu_torch.controllers.tpujob import TpuJobController
    from kubeflow_tpu_torch.testing.apiserver_http import HttpApiClient, endpoints_from_env
    from kubeflow_tpu_torch.testing.fake_apiserver import Conflict

    identity = os.environ["KFTPU_IDENTITY"]
    stall = float(os.environ.get("KFTPU_PREEMPT_STALL", "0"))

    built: list = []

    def report_plane() -> None:
        print("plane " + json.dumps(plane_report(built)), flush=True)

    def preempt_stall() -> None:
        # The victims are evicted and committed; the preemptor is not
        # placed yet. Announce the window, then hold it open.
        report_plane()
        print(f"evicted {identity}", flush=True)
        if stall:
            time.sleep(stall)

    client = HttpApiClient(endpoints_from_env(os.environ["KFTPU_APISERVER"]))
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    elector = LeaderElector(
        client, os.environ.get("KFTPU_LEASE_NAME", "tpujob-controller"), identity,
        lease_duration=float(os.environ.get("KFTPU_LEASE_DURATION", "3")),
        renew_deadline=float(os.environ.get("KFTPU_RENEW_DEADLINE", "2")),
        retry_period=0.25)
    print(f"standby {identity}", flush=True)

    def start_leading(el) -> None:
        # Fencing armed before the first reconcile: every write of this
        # term carries (lease, holder, generation).
        client.set_lease_guard(el.guard)
        print(f"leading {identity} gen {el.transitions}", flush=True)
        ctl = TpuJobController(client, preempt_stall=preempt_stall)
        built.append(ctl)
        report_plane()
        threading.Thread(target=ctl.controller.run, args=(stop,), daemon=True).start()

    try:
        lost = elector.run(stop, start_leading)
    except Conflict:
        lost = True
    report_plane()
    if lost:
        # A deposed leader's in-flight preemption belongs to a dead term.
        print(f"deposed {identity}", flush=True)
        return 2
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
