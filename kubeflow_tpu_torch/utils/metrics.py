"""Prometheus-style metrics, dependency-free.

The reference instruments everything with Prometheus (SURVEY.md §5:
notebook collector `pkg/metrics/metrics.go:22-99`, profile counters +
heartbeat `monitoring.go:27-59`, kfam request metrics). This module gives
controllers and servers the same conventions — counters/gauges with label
sets and text exposition — without depending on prometheus_client.
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping


def _fmt_labels(labels: Mapping[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _key(self, labels: Mapping[str, str]) -> tuple:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(labels)}"
            )
        return tuple(labels[k] for k in self.label_names)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self, kind: str) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {kind}",
        ]
        with self._lock:
            if not self._values and not self.label_names:
                lines.append(f"{self.name} 0")
            for key, val in sorted(self._values.items()):
                labels = dict(zip(self.label_names, key))
                lines.append(f"{self.name}{_fmt_labels(labels)} {val:g}")
        return "\n".join(lines)


class Counter(_Metric):
    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def expose_text(self) -> str:
        return self.expose("counter")


class Gauge(_Metric):
    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def expose_text(self) -> str:
        return self.expose("gauge")


class MetricsRegistry:
    """Named collection of metrics with a /metrics text endpoint body."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Counter:
        return self._register(name, Counter(name, help_, labels))

    def gauge(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Gauge:
        return self._register(name, Gauge(name, help_, labels))

    def _register(self, name: str, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not type(metric) or (
                    existing.label_names != metric.label_names
                ):
                    raise ValueError(f"metric {name} re-registered differently")
                return existing
            self._metrics[name] = metric
            return metric

    def expose_text(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.expose_text() for m in metrics) + "\n"
