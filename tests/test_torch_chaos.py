"""The port's control-plane fault injector (`testing/chaos.py`: `Fault`,
`FaultSchedule`, `ChaosProxy`) and the client hardening it exercises
(`testing/apiserver_http.py`: write retries, breakers, the stream
breaker and the long-poll fallback) against the JAX package's.

- JAX's own tests/test_chaos.py runs against the port, every case, its
  imports pointed at the port: the seeded schedule, the proxy's eight
  fault classes against the port's facade and client, the rejection
  classifier, the breakers, idempotent events, `retry_on_conflict`, the
  server's framing and the replica-kill plan.
- The port's `FaultSchedule` draws JAX's plan, entry for entry, for
  several seeds, plan sizes and class sets; and consumed by one scripted
  request sequence through both schedules it gives the same faults and
  the same coverage.
"""

import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.testing import chaos as j_chaos
from kubeflow_tpu_torch.testing import chaos

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_chaos")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_chaos_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 24


def _plan(schedule) -> list[tuple]:
    return [(f.cls, f.param, f.gap) for f in schedule.plan]


@pytest.mark.parametrize("seed", [0, 1, 7, 1234, 20260804])
@pytest.mark.parametrize("per_class", [0, 1, 2, 6])
def test_plan_equals_jax_for_the_same_seed(seed, per_class):
    assert chaos.FAULT_CLASSES == j_chaos.FAULT_CLASSES
    assert chaos.HA_FAULT_CLASSES == j_chaos.HA_FAULT_CLASSES
    for classes in (chaos.FAULT_CLASSES, chaos.HA_FAULT_CLASSES, (chaos.APISERVER_KILL,)):
        for max_gap in (1, 3, 5):
            t = chaos.FaultSchedule(seed, faults_per_class=per_class, max_gap=max_gap,
                                    classes=classes)
            j = j_chaos.FaultSchedule(seed, faults_per_class=per_class, max_gap=max_gap,
                                      classes=classes)
            assert _plan(t) == _plan(j), (seed, per_class, max_gap, classes)


REQUESTS = [
    ("POST", "/apis/Pod", ""),
    ("PUT", "/apis/Pod/default/p", ""),
    ("DELETE", "/apis/Pod/default/p", ""),
    ("GET", "/apis/_", "watch=true&stream=true&resourceVersion=0"),
    ("GET", "/apis/_", "watch=true&resourceVersion=0"),
    ("GET", "/apis/Pod", ""),
    ("GET", "/apis/Pod/default/p", ""),
]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_scripted_consumption_equals_jax(seed):
    """One seeded request sequence, with seeded requeues (a fault that
    could not land) and effects, through both schedules: the same fault
    for every request, the same coverage, pending count and exhaustion."""
    rng = random.Random(seed)
    t = chaos.FaultSchedule(seed, faults_per_class=2, classes=chaos.HA_FAULT_CLASSES)
    j = j_chaos.FaultSchedule(seed, faults_per_class=2, classes=j_chaos.HA_FAULT_CLASSES)
    for _ in range(600):
        method, path, query = rng.choice(REQUESTS)
        ft, fj = t.next_fault(method, path, query), j.next_fault(method, path, query)
        assert (ft is None) == (fj is None)
        if ft is not None:
            assert (ft.cls, ft.param, ft.gap) == (fj.cls, fj.param, fj.gap)
            if rng.random() < 0.2:
                t.requeue(ft)
                j.requeue(fj)
            else:
                t.mark_injected(ft)
                j.mark_injected(fj)
        assert t.coverage() == j.coverage()
        assert (t.remaining, t.exhausted) == (j.remaining, j.exhausted)
    assert t.exhausted and all(n == 2 for n in t.coverage().values()), t


def test_from_plan_and_empty_schedule_equal_jax():
    plan = [chaos.Fault("truncate_stream", 64.0, 0), chaos.Fault("error_5xx", 2.0, 1)]
    t = chaos.FaultSchedule.from_plan(plan)
    j = j_chaos.FaultSchedule.from_plan([j_chaos.Fault(f.cls, f.param, f.gap) for f in plan])
    assert _plan(t) == _plan(j)
    assert repr(t) == repr(j)
    assert chaos.FaultSchedule(5, faults_per_class=0).plan == ()


def test_synth_response_bytes_equal_jax():
    for status, reason, payload in ((503, "Service Unavailable", {"log": "chaos: outage"}),
                                    (410, "Gone", {"log": "relist"})):
        assert chaos._synth_response(status, reason, payload) == \
            j_chaos._synth_response(status, reason, payload)


@pytest.mark.parametrize("cls", sorted(j_chaos.HA_FAULT_CLASSES))
def test_eligibility_equals_jax(cls):
    for method in ("GET", "POST", "PUT", "DELETE", "PATCH"):
        for query in ("", "watch=true", "watch=1&stream=1", "watch=true&stream=true",
                      "labelSelector=a=b"):
            assert chaos._eligible(cls, method, "/apis/Pod", query) == \
                j_chaos._eligible(cls, method, "/apis/Pod", query), (method, query)


IMPORT_OF_JAX = re.compile(
    r"^\s*(?:import\s+(?:jax|kubeflow_tpu)\b(?!_torch)|from\s+(?:jax|kubeflow_tpu)\b(?!_torch))",
    re.MULTILINE)


def test_no_port_source_imports_jax_or_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (a grep of every source file, lazy imports included)."""
    files = sorted((REPO / "kubeflow_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 100
    offenders = {str(f.relative_to(REPO)): IMPORT_OF_JAX.findall(f.read_text())
                 for f in files}
    assert {f: hits for f, hits in offenders.items() if hits} == {}
    assert IMPORT_OF_JAX.findall("import jax\nfrom kubeflow_tpu.api import x\n"
                                 "from kubeflow_tpu_torch.api import y\n") == \
        ["import jax", "from kubeflow_tpu"]


def test_this_slices_modules_load_no_jax():
    """The fault injector, the chaos job, conversion, the mesh gate,
    OpenAPI, the small apps and the cloud seam import neither JAX nor the
    JAX package, nor torch (a fresh interpreter)."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import kubeflow_tpu_torch.testing.chaos, kubeflow_tpu_torch.testing.chaos_job, "
            "kubeflow_tpu_torch.api.versioning, kubeflow_tpu_torch.web.mesh, "
            "kubeflow_tpu_torch.web.openapi, kubeflow_tpu_torch.apps.probe, "
            "kubeflow_tpu_torch.apps.echo, kubeflow_tpu_torch.apps.cloud_metrics, "
            "kubeflow_tpu_torch.deploy.gke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'kubeflow_tpu', "
            "'torch'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
