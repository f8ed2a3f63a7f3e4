"""E2E harness utilities — the `testing/` toolbox analog.

Counterpart of `kubeflow_tpu/testing/e2e_util.py`, whole, its imports
pointed at the port: the readiness checks read `deploy/bundles.py`'s
`CORE_DEPLOYMENTS`, and `DeployProber`'s gauges live on
`utils/metrics.py`. `NotebookLoadTest` spawns the port's CPU notebook
image (`kubeflow-tpu/torch-notebook:latest-cpu`) where JAX's spawns its
JAX one. It imports no torch.

Parity map (SURVEY.md §2 #26, §4):
- `run_with_retry`      → `testing/run_with_retry.py` flake harness
- `wait_for` /
  `wait_for_deployments`→ `testing/wait_for_deployment.py`,
                          `wait_for_kubeflow.py`
- `kf_is_ready`         → `testing/kfctl/kf_is_ready_test.py:101-115`
                          (the core deployment-set assertion)
- `junit_xml`           → the junit-to-GCS Gubernator contract every
                          Argo step honored (`testing/README.md:22-35`)
- `NotebookLoadTest`    → `notebook-controller/loadtest/start_notebooks.py`
- `DeployProber`        → `testing/test_deploy_app.py:38-53` continuous
                          click-to-deploy prober with Prometheus gauges
"""

from __future__ import annotations

import dataclasses
import logging
import time
import xml.sax.saxutils as saxutils
from typing import Callable, Iterable

from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.deploy.bundles import CORE_DEPLOYMENTS
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, NotFound
from kubeflow_tpu_torch.utils.metrics import MetricsRegistry

log = logging.getLogger(__name__)


def run_with_retry(
    fn: Callable[[], object],
    *,
    retries: int = 3,
    delay_seconds: float = 1.0,
    backoff: float = 2.0,
    exceptions: tuple[type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
):
    """Run `fn`, retrying listed exceptions up to `retries` extra times
    with exponential backoff. The last failure propagates."""
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions:
            attempt += 1
            if attempt > retries:
                raise
            wait = delay_seconds * backoff ** (attempt - 1)
            log.warning("attempt %d failed; retrying in %.1fs", attempt, wait)
            sleep(wait)


def wait_for(
    predicate: Callable[[], bool],
    *,
    timeout_seconds: float = 300.0,
    poll_seconds: float = 1.0,
    desc: str = "condition",
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
) -> None:
    """Poll until `predicate()` is truthy; TimeoutError otherwise."""
    deadline = clock() + timeout_seconds
    while not predicate():
        if clock() >= deadline:
            raise TimeoutError(f"timed out waiting for {desc}")
        sleep(poll_seconds)


def missing_deployments(
    api: FakeApiServer,
    names: Iterable[str] = CORE_DEPLOYMENTS,
    namespace: str = "kubeflow",
) -> list[str]:
    present = {d.metadata.name for d in api.list("Deployment", namespace)}
    return [n for n in names if n not in present]


def wait_for_deployments(
    api: FakeApiServer,
    names: Iterable[str],
    namespace: str = "kubeflow",
    **wait_kwargs,
) -> None:
    names = list(names)
    wait_for(
        lambda: not missing_deployments(api, names, namespace),
        desc=f"deployments {names}",
        **wait_kwargs,
    )


def kf_is_ready(api: FakeApiServer) -> list[str]:
    """The `kf_is_ready_test` assertion: returns what's missing from the
    core component set (empty = ready)."""
    problems = [
        f"deployment/{n}" for n in missing_deployments(api)
    ]
    crds = {c.metadata.name for c in api.list("CustomResourceDefinition", "")}
    for plural in (
        "tpujobs", "studies", "workflows", "notebooks", "profiles",
        "tensorboards", "poddefaults",
    ):
        if f"{plural}.kubeflow-tpu.org" not in crds:
            problems.append(f"crd/{plural}")
    return problems


# -- junit ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TestResult:
    name: str
    seconds: float = 0.0
    failure: str | None = None


def junit_xml(suite: str, results: Iterable[TestResult]) -> str:
    results = list(results)
    failures = sum(1 for r in results if r.failure is not None)
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        f'<testsuite name={saxutils.quoteattr(suite)} '
        f'tests="{len(results)}" failures="{failures}">',
    ]
    for r in results:
        open_tag = (
            f"  <testcase name={saxutils.quoteattr(r.name)} "
            f'time="{r.seconds:.3f}"'
        )
        if r.failure is None:
            lines.append(open_tag + " />")
        else:
            lines.append(open_tag + ">")
            lines.append(
                f"    <failure>{saxutils.escape(r.failure)}</failure>"
            )
            lines.append("  </testcase>")
    lines.append("</testsuite>")
    return "\n".join(lines) + "\n"


# -- load tests -------------------------------------------------------------


class NotebookLoadTest:
    """Spawn N Notebook CRs and wait for their StatefulSets — the
    controller load test (`loadtest/start_notebooks.py:1-30`)."""

    def __init__(self, api: FakeApiServer, namespace: str = "loadtest"):
        self.api = api
        self.namespace = namespace

    def spawn(self, count: int, *, image: str = "kubeflow-tpu/torch-notebook:latest-cpu"):
        for i in range(count):
            self.api.create(
                new_resource(
                    "Notebook",
                    f"load-{i}",
                    self.namespace,
                    spec={
                        "template": {
                            "spec": {
                                "containers": [
                                    {"name": "notebook", "image": image}
                                ]
                            }
                        }
                    },
                )
            )

    def ready_count(self) -> int:
        names = {
            n.metadata.name for n in self.api.list("Notebook", self.namespace)
        }
        return sum(
            1
            for s in self.api.list("StatefulSet", self.namespace)
            if s.metadata.name in names
        )

    def cleanup(self) -> None:
        for n in self.api.list("Notebook", self.namespace):
            try:
                self.api.delete("Notebook", n.metadata.name, self.namespace)
            except NotFound:
                pass


class DeployProber:
    """Continuous deploy prober (`test_deploy_app.py`): drive the deploy
    service end-to-end and export `deployment_service_status` (1 ok) +
    latency + failure counters."""

    def __init__(
        self,
        client,  # TestClient or HTTP client with post/get -> Response
        *,
        metrics: MetricsRegistry | None = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        timeout_seconds: float = 120.0,
    ):
        self.client = client
        self.metrics = metrics or MetricsRegistry()
        self.status_gauge = self.metrics.gauge(
            "deployment_service_status", "1 if the last probe deployed OK"
        )
        self.latency = self.metrics.gauge(
            "deployment_latency_seconds", "last end-to-end deploy time"
        )
        self.failures = self.metrics.counter(
            "deployment_probe_failures_total", "failed deploy probes"
        )
        self.clock = clock
        self.sleep = sleep
        self.timeout_seconds = timeout_seconds

    def probe_once(self, spec_dict: dict) -> bool:
        """spec_dict: a PlatformSpec dict (`kfctl` request body)."""
        t0 = self.clock()
        ok = False
        try:
            name = spec_dict["metadata"]["name"]
            resp = self.client.post("/kfctl/apps/v1/create", spec_dict)
            if resp.status in (200, 201, 202):
                deadline = self.clock() + self.timeout_seconds
                while self.clock() < deadline:
                    status = self.client.get(f"/kfctl/apps/v1/status/{name}")
                    phase = (
                        status.json().get("status", {}).get("phase")
                        if status.status == 200
                        else None
                    )
                    if phase == "Ready":
                        ok = True
                        break
                    if phase == "Failed":
                        break
                    self.sleep(1.0)
        except Exception as e:  # the prober itself must not die
            log.warning("deploy probe error: %s", e)
        self.latency.set(self.clock() - t0)
        self.status_gauge.set(1.0 if ok else 0.0)
        if not ok:
            self.failures.inc()
        return ok
