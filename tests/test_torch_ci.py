"""The port's CI DAG builders and CI tools against the JAX package's:
`testing/workflows.py`, `testing/junit_merge.py`,
`testing/shard_runner.py` and `ci/` (`application_util.py`, the CLI).

The three workflow builders give JAX's specs once its module names and
test paths are mapped to the port's (`workflows.TARGETS`); the junit
merge gives JAX's counts and XML on the same shard files; the shard
runner names junit files and runs pytest as JAX's does; the checked-in
golden manifests under ``kubeflow_tpu_torch/manifests/`` have no drift,
and the image retag equals JAX's. Last, JAX's e2e
(tests/e2e/test_workflow_e2e.py::test_sharded_ci_fanout_with_junit_collection)
on the port: the sharded CI Workflow through the port's
`WorkflowController` and `LocalPodRunner`, two small port test files as
shards.
"""

import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import yaml

from kubeflow_tpu.ci import application_util as j_app
from kubeflow_tpu.deploy.bundles import bundle_resources as j_bundle_resources
from kubeflow_tpu.deploy.kfdef import default_spec as j_default_spec
from kubeflow_tpu.testing import junit_merge as j_junit_merge
from kubeflow_tpu.testing import shard_runner as j_shard_runner
from kubeflow_tpu.testing import workflows as j_workflows
from kubeflow_tpu_torch.api.workflow import KIND
from kubeflow_tpu_torch.ci import application_util as app
from kubeflow_tpu_torch.controllers.workflow import WorkflowController
from kubeflow_tpu_torch.deploy.bundles import BUNDLES, bundle_resources
from kubeflow_tpu_torch.deploy.kfdef import default_spec
from kubeflow_tpu_torch.runtime.local import LocalPodRunner
from kubeflow_tpu_torch.testing import junit_merge, shard_runner, workflows
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]


def _mapped(jax_wf) -> dict:
    """JAX's Workflow dict with its module names, lint package and test
    paths mapped to the port's."""
    d = jax_wf.to_dict()
    text = yaml.safe_dump(d, sort_keys=True)
    for jax_target, port_target in workflows.TARGETS.items():
        if jax_target != port_target:
            text = text.replace(jax_target, port_target)
    text = re.sub(r"\bkubeflow_tpu\b(?!_torch)", "kubeflow_tpu_torch", text)
    return yaml.safe_load(text)


@pytest.mark.parametrize("build, kwargs", [
    ("unit_tests_workflow", {}),
    ("unit_tests_workflow", {"name": "ut", "namespace": "ci", "artifacts_dir": "/a"}),
    ("sharded_unit_tests_workflow", {"shards": ("tests/a.py", "tests/b.py::t"),
                                     "artifacts_dir": "/art"}),
    ("sharded_unit_tests_workflow", {"shards": ("x",), "artifacts_dir": "/art",
                                     "collect_required": False}),
    ("platform_e2e_workflow", {}),
    ("platform_e2e_workflow", {"artifacts_dir": "/art", "deploy_args": ("-f", "p.yaml")}),
])
def test_workflows_equal_jax_specs_once_names_are_mapped(build, kwargs):
    want = _mapped(getattr(j_workflows, build)(**kwargs))
    got = getattr(workflows, build)(**kwargs).to_dict()
    assert got == want
    assert "kubeflow_tpu." not in yaml.safe_dump(got)


def test_the_mapping_names_each_port_counterpart():
    for jax_target, port_target in workflows.TARGETS.items():
        assert (REPO / port_target).exists(), port_target
        if jax_target != port_target:
            assert Path(port_target).name == "test_torch_" + Path(jax_target).name[5:]
    lint = workflows.unit_tests_workflow().spec["steps"][1]
    assert lint["args"] == ["kubeflow_tpu_torch"]


def test_sharded_workflow_passes_pytest_args_to_every_shard():
    wf = workflows.sharded_unit_tests_workflow(("a", "b"), artifacts_dir="/art",
                                               pytest_args="-q --noconftest")
    shard = wf.spec["steps"][0]
    assert shard["args"] == ["${item}", "--junit-dir", "/art", "--pytest-args",
                             "-q --noconftest"]
    with pytest.raises(ValueError, match="artifacts_dir"):
        workflows.sharded_unit_tests_workflow(("a",))


# -- junit merge and the shard runner -------------------------------------------

SHARDS = {
    "junit_tests_a.py.xml": '<?xml version="1.0"?><testsuites><testsuite name="pytest" '
                            'tests="3" failures="0" errors="0" skipped="1"><testcase '
                            'name="t1"/></testsuite></testsuites>',
    "junit_tests_b.py.xml": '<testsuite name="pytest" tests="2" failures="1" errors="0">'
                            '<testcase name="t2"><failure message="x"/></testcase></testsuite>',
    "junit_tests_c.py.xml": '<testsuites><testsuite tests="4" errors="1"/><testsuite '
                            'tests="1"/></testsuites>',
    "junit_merged.xml": "<testsuites tests='99'/>",  # a previous merge: skipped
    "other.xml": "<testsuite tests='7'/>",
}


def test_junit_merge_gives_jax_counts_and_xml(tmp_path):
    for name, mod in (("jax", j_junit_merge), ("port", junit_merge)):
        d = tmp_path / name
        d.mkdir()
        for fname, text in SHARDS.items():
            (d / fname).write_text(text)
        assert mod.merge(d) == (10, 1, 1)
        assert mod.main([str(d), "-o", str(d / "out.xml")]) == 1
    for fname in ("junit_merged.xml", "out.xml"):
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "jax" / fname).read_bytes()
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "junit_x.xml").write_text('<testsuite tests="2" failures="0" errors="0"/>')
    assert junit_merge.main([str(clean)]) == 0


TARGETS = ["tests/test_torch_cuda_kernels.py::test_flash_fwd_matches_plain_version",
           "tests/test_x.py::test_y[a-b/c d]", "tests/", "a b/c:d*e?f", "x.py::T::t[1]",
           "ünïcode"]


def test_shard_runner_names_and_runs_as_jax_does(monkeypatch, tmp_path):
    assert [shard_runner.safe_name(t) for t in TARGETS] == \
        [j_shard_runner.safe_name(t) for t in TARGETS]
    calls = []
    for mod in (j_shard_runner, shard_runner):
        monkeypatch.setattr(mod.subprocess, "call", lambda cmd: calls.append(cmd) or 0)
        assert mod.main([TARGETS[0], "--junit-dir", str(tmp_path),
                         "--pytest-args", "-q --noconftest"]) == 0
        assert mod.main([TARGETS[1]]) == 0
    assert calls[2:] == calls[:2]
    assert calls[0][-1] == (f"--junitxml={tmp_path}/junit_tests_test_torch_cuda_kernels.py__"
                            "test_flash_fwd_matches_plain_version.xml")
    assert calls[0][3:6] == [TARGETS[0], "-q", "--noconftest"]


# -- the golden manifests and the image retag ---------------------------------


def test_checked_in_manifests_have_no_drift():
    assert app.MANIFEST_DIR == REPO / "kubeflow_tpu_torch" / "manifests"
    assert app.manifest_drift() == []
    assert sorted(p.stem for p in app.MANIFEST_DIR.glob("*.yaml")) == sorted(BUNDLES)


def test_regenerate_into_tmp_and_drift_is_seen(tmp_path):
    written = app.regenerate_manifests(tmp_path)
    assert {p.stem for p in written} == set(BUNDLES)
    for p in written:
        assert p.read_text() == (app.MANIFEST_DIR / p.name).read_text()
    (tmp_path / "gone-bundle.yaml").write_text("x: 1\n")
    (tmp_path / "gateway.yaml").write_text("x: 2\n")
    assert app.manifest_drift(tmp_path) == ["gateway", "gone-bundle"]
    app.regenerate_manifests(tmp_path)
    assert app.manifest_drift(tmp_path) == [] and not (tmp_path / "gone-bundle.yaml").exists()


def _images(resources) -> list[str]:
    return [c["image"] for r in resources
            for c in r.spec.get("template", {}).get("spec", {}).get("containers", [])
            + r.spec.get("containers", [])]


def test_set_bundle_images_retags_as_jax_does():
    names = ["centraldashboard", "tpujob-operator", "jupyter-web-app"]
    port = bundle_resources(default_spec(), names)
    jax = j_bundle_resources(j_default_spec(), names)
    before = _images(port)
    assert before == _images(jax) and before
    image_map = {"kubeflow-tpu/centraldashboard": "gcr.io/x/dash:v9",
                 before[-1]: "registry:5000/pinned@sha256:" + "0" * 64}
    app.set_bundle_images(port, image_map)
    j_app.set_bundle_images(jax, image_map)
    assert _images(port) == _images(jax)
    assert "gcr.io/x/dash:v9" in _images(port) and _images(port) != before


def test_ci_cli_check_render_and_no_lint():
    run = [sys.executable, "-m", "kubeflow_tpu_torch.ci"]
    check = subprocess.run(run + ["check"], cwd=REPO, capture_output=True, text=True,
                           timeout=120)
    assert check.returncode == 0 and "manifests clean" in check.stdout
    render = subprocess.run(run + ["render", "gateway"], cwd=REPO, capture_output=True,
                            text=True, timeout=120)
    assert render.returncode == 0 and render.stdout == app.render_bundle_yaml("gateway")
    lint = subprocess.run(run + ["lint"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert lint.returncode == 2 and "invalid choice" in lint.stderr


# -- JAX's sharded CI e2e, on the port ------------------------------------------


def _drive(api, ctl, runner, name, deadline_s=120):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        ctl.controller.run_until_idle()
        runner.step()
        phase = api.get(KIND, name, "ci").status.get("phase")
        if phase in ("Succeeded", "Failed"):
            return phase
        time.sleep(0.1)
    raise TimeoutError("workflow did not finish")


def test_sharded_ci_fanout_with_junit_collection(tmp_path):
    """The CI DSL fans pytest shards out via withItems, each shard
    writes junit into the shared artifacts directory and the join step
    merges them; real subprocesses throughout."""
    artifacts = tmp_path / "artifacts"
    artifacts.mkdir()
    api = FakeApiServer()
    ctl = WorkflowController(api)
    runner = LocalPodRunner(api, cwd=str(REPO), extra_env={"OMP_NUM_THREADS": "1"})
    wf = workflows.sharded_unit_tests_workflow(
        ("tests/test_torch_router.py", "tests/test_torch_data.py"),
        namespace="ci", artifacts_dir=str(artifacts),
        pytest_args="-q --noconftest -p no:cacheprovider")
    api.create(wf)
    try:
        phase = _drive(api, ctl, runner, "unit-tests-sharded", deadline_s=120)
    finally:
        runner.shutdown()
        api.close()
    assert phase == "Succeeded"
    shard_files = sorted(p.name for p in artifacts.glob("junit_tests*"))
    assert shard_files == ["junit_tests_test_torch_data.py.xml",
                           "junit_tests_test_torch_router.py.xml"]
    merged = (artifacts / "junit_merged.xml").read_text()
    assert "testsuite" in merged
    assert junit_merge.merge(artifacts, tmp_path / "again.xml")[0] >= 20
    status = api.get(KIND, "unit-tests-sharded", "ci").status
    assert status["steps"]["shard-0"]["state"] == "Succeeded"
    assert status["steps"]["shard-1"]["state"] == "Succeeded"
    assert status["steps"]["collect-junit"]["state"] == "Succeeded"
