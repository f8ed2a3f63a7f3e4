"""Cloud Monitoring metrics provider — the Stackdriver analog.

A copy of `kubeflow_tpu/apps/cloud_metrics.py` (a module with no JAX in
it); its transport seam is the port's cut-down `deploy/gke.py`. The
reference dashboard's metrics are pluggable
(`metrics_service.ts:21`, factory `metrics_service_factory.ts`) with a
Stackdriver implementation querying node/pod CPU + memory time series
(`stackdriver_metrics_service.ts:15-24`). This is the TPU-era
equivalent behind the same `MetricsService` protocol: it constructs
real Cloud Monitoring v3 `timeSeries.list` requests — TPU duty cycle is
a first-class series, because idle chips are the platform's dominant
cost — and hands them to the deploy tier's `Transport` seam
(`deploy/gke.py`): `RecordingTransport` for tests and dry runs,
which sends nothing over the network, or a token-bearing HTTP client. `LocalMetricsService`
(apps/dashboard.py) remains the platform-in-a-box implementation.
"""

from __future__ import annotations

import datetime
import time
from typing import Callable

from kubeflow_tpu_torch.deploy.gke import Request, Transport
from kubeflow_tpu_torch.web.wsgi import HttpError

API_BASE = "https://monitoring.googleapis.com/v3"

# Dashboard series → GKE system-metric types. CPU/memory mirror the
# reference's node utilization charts; tpuduty is the accelerator duty
# cycle the GKE metrics agent exports for TPU node pools.
METRIC_TYPES = {
    "nodecpu": "kubernetes.io/node/cpu/allocatable_utilization",
    "nodemem": "kubernetes.io/node/memory/allocatable_utilization",
    "tpuduty": "kubernetes.io/node/accelerator/duty_cycle",
}


def _rfc3339(epoch: float) -> str:
    return (
        datetime.datetime.fromtimestamp(epoch, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%SZ")
    )


def _epoch(rfc3339: str) -> float:
    return datetime.datetime.fromisoformat(
        rfc3339.replace("Z", "+00:00")
    ).timestamp()


class CloudMonitoringMetricsService:
    """MetricsService over the Cloud Monitoring API.

    Request *construction* is a pure function of (metric, window) —
    golden-tested without a cloud, exactly like the GKE node-pool
    payloads (`gcpUtils_test.go` pattern)."""

    def __init__(
        self,
        transport: Transport,
        project: str,
        cluster: str | None = None,
        now: Callable[[], float] = time.time,
    ):
        self.transport = transport
        self.project = project
        self.cluster = cluster
        self._now = now

    def request_for(self, metric: str, minutes: int) -> Request:
        metric_type = METRIC_TYPES.get(metric)
        if metric_type is None:
            raise HttpError(400, f"unknown metric {metric!r}")
        end = self._now()
        filt = f'metric.type = "{metric_type}"'
        if self.cluster:
            filt += (
                f' AND resource.labels.cluster_name = "{self.cluster}"'
            )
        return Request(
            "GET",
            f"{API_BASE}/projects/{self.project}/timeSeries",
            {
                "filter": filt,
                "interval.startTime": _rfc3339(end - minutes * 60),
                "interval.endTime": _rfc3339(end),
                "aggregation.alignmentPeriod": "60s",
                "aggregation.perSeriesAligner": "ALIGN_MEAN",
            },
        )

    def query(self, metric: str, minutes: int) -> list[dict]:
        response = self.transport.send(self.request_for(metric, minutes))
        points = []
        for series in response.get("timeSeries", []):
            node = (
                series.get("resource", {})
                .get("labels", {})
                .get("node_name", "")
            )
            for point in series.get("points", []):
                value = point.get("value", {})
                points.append(
                    {
                        "node": node,
                        "timestamp": _epoch(
                            point.get("interval", {}).get(
                                "endTime", _rfc3339(self._now())
                            )
                        ),
                        "value": value.get(
                            "doubleValue", value.get("int64Value")
                        ),
                    }
                )
        points.sort(key=lambda p: (p["node"], p["timestamp"]))
        return points
