"""Availability prober — the metric-collector analog.

A copy of `kubeflow_tpu/apps/probe.py` (a module with no JAX in it).
Parity with `metric-collector/service-readiness/kubeflow-readiness.py:21-38`
(SURVEY.md §2 #25): periodically GET the deployed platform's endpoint and
export a Prometheus gauge `kubeflow_availability` (1 healthy / 0 not),
plus a probe-latency gauge and failure counter. The reference
authenticated through IAP; here auth is a pluggable header supplier (the
mesh's trusted-header model, `authn.py`)."""

from __future__ import annotations

import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from kubeflow_tpu_torch.utils.metrics import MetricsRegistry
from kubeflow_tpu_torch.web import App, Request, Response

log = logging.getLogger(__name__)


def http_probe(url: str, headers: dict[str, str] | None = None,
               timeout: float = 10.0) -> bool:
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return 200 <= resp.status < 400
    except (urllib.error.URLError, OSError, TimeoutError):
        return False


class AvailabilityProber:
    """Polls a target and keeps gauges current; serves /metrics."""

    def __init__(
        self,
        url: str,
        *,
        interval_seconds: float = 30.0,
        probe: Callable[[str], bool] | None = None,
        # Identity headers for the probe (the reference IAP-authed its
        # GET; on the mesh this is the trusted user-id header). Ignored
        # when a custom `probe` is supplied.
        headers: dict[str, str] | None = None,
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.url = url
        self.interval_seconds = interval_seconds
        self._probe = probe or (
            lambda target: http_probe(target, headers=headers)
        )
        self._clock = clock
        self.metrics = metrics or MetricsRegistry()
        self.availability = self.metrics.gauge(
            "kubeflow_availability",
            "1 if the platform endpoint is up (kubeflow-readiness.py:21)",
            ("url",),
        )
        self.latency = self.metrics.gauge(
            "kubeflow_probe_latency_seconds", "last probe duration", ("url",)
        )
        self.failures = self.metrics.counter(
            "kubeflow_probe_failures_total", "failed probes", ("url",)
        )
        self._stop = threading.Event()

    def probe_once(self) -> bool:
        t0 = self._clock()
        ok = False
        try:
            ok = self._probe(self.url)
        except Exception as e:  # a prober must never die
            log.warning("probe raised: %s", e)
        self.latency.set(self._clock() - t0, url=self.url)
        self.availability.set(1.0 if ok else 0.0, url=self.url)
        if not ok:
            self.failures.inc(url=self.url)
        return ok

    def run(self) -> None:
        while not self._stop.is_set():
            self.probe_once()
            self._stop.wait(self.interval_seconds)

    def start(self) -> threading.Thread:
        thread = threading.Thread(target=self.run, name="prober", daemon=True)
        thread.start()
        return thread

    def stop(self) -> None:
        self._stop.set()


class ProberApp(App):
    def __init__(self, prober: AvailabilityProber):
        super().__init__("metrics-collector")
        self.prober = prober
        self.add_route("/metrics", self.metrics_text)

    def metrics_text(self, req: Request) -> Response:
        return Response(
            body=self.prober.metrics.expose_text().encode(),
            content_type="text/plain; version=0.0.4",
        )


def main() -> None:  # python -m kubeflow_tpu_torch.apps.probe
    import argparse

    from kubeflow_tpu_torch.web.wsgi import serve

    parser = argparse.ArgumentParser(prog="kubeflow-tpu-prober")
    parser.add_argument("--url", required=True, help="endpoint to probe")
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--header", action="append", default=[], metavar="NAME=VALUE",
        help="identity header to send with each probe (repeatable)",
    )
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    headers = dict(h.split("=", 1) for h in args.header if "=" in h)
    prober = AvailabilityProber(
        args.url, interval_seconds=args.interval, headers=headers or None
    )
    from kubeflow_tpu_torch.utils import threads

    thread = prober.start()
    serve(ProberApp(prober), port=args.port)
    # Bounded foreground park (^C stops the prober; no untimed join).
    if threads.run_until_interrupt(thread):
        prober.stop()
        threads.join_thread(
            thread, timeout=args.interval + 10.0, what="prober thread"
        )


if __name__ == "__main__":
    main()
