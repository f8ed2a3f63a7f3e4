"""The cloud API transport seam, cut down from `kubeflow_tpu/deploy/gke.py`.

A cloud call is built as a `Request` (fully constructed, not sent) and
handed to a `Transport`; tests and dry runs use `RecordingTransport`,
which records every request and answers from a canned map, so request
construction is tested without a cloud and nothing goes over the
network. A real deployment plugs in a token-bearing HTTP client. Only
this seam is copied: the port builds no GKE cluster or node-pool
payloads.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Protocol


@dataclasses.dataclass(frozen=True)
class Request:
    """One cloud API call, fully constructed but not sent."""

    method: str
    url: str
    body: dict | None = None

    def to_json(self) -> str:
        return json.dumps(
            {"method": self.method, "url": self.url, "body": self.body},
            indent=2,
        )


class Transport(Protocol):
    """The network edge: send one constructed request, return the parsed
    response body."""

    def send(self, request: Request) -> dict: ...


class RecordingTransport:
    """Dry-run / test transport: records every request; responses come
    from a canned map (url-suffix matched) or default to {}."""

    def __init__(self, responses: dict[str, dict] | None = None):
        self.requests: list[Request] = []
        self.responses = dict(responses or {})

    def send(self, request: Request) -> dict:
        self.requests.append(request)
        for suffix, response in self.responses.items():
            if request.url.endswith(suffix):
                return response
        return {}
