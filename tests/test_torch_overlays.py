"""The port's overlay engine (`deploy/overlays.py`) against the JAX
package's.

- JAX's own tests/test_overlays.py runs against the port, every case,
  its imports pointed at the port, the CI tool two cases render the
  shipped overlays through among them (`ci/application_util.py`, since
  PR 22); `test_render_equals_jax_ci_tool` holds the port's tool against
  JAX's.
- `strategic_merge`, `split_image`, `ImageRule.rewrite`,
  `apply_overlay` and `apply_overlays` give JAX's answers on JAX's
  cases and on the shipped overlays over every bundle.
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.ci import application_util as j_app_util
from kubeflow_tpu.deploy import bundles as jbundles
from kubeflow_tpu.deploy import kfdef as jkfdef
from kubeflow_tpu.deploy import overlays as jov
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.ci import application_util as app_util
from kubeflow_tpu_torch.deploy import bundles as pbundles
from kubeflow_tpu_torch.deploy import kfdef as pkfdef
from kubeflow_tpu_torch.deploy import overlays as pov

REPO = Path(__file__).resolve().parents[1]
SHIPPED = [REPO / "manifests" / "overlays" / "dev.yaml",
           REPO / "manifests" / "overlays" / "prod.yaml"]


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port."""
    path = REPO / "tests" / f"{stem}.py"
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_overlays")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_overlays_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 19


@pytest.mark.parametrize("overlay", SHIPPED, ids=lambda p: p.stem)
@pytest.mark.parametrize("app", list(jbundles.BUNDLES))
def test_render_equals_jax_ci_tool(overlay, app):
    want = j_app_util.render_overlaid_yaml(app, [str(overlay)])
    # Volatile ids: the uids the bundles stamp differ between runs.
    strip = lambda text: re.sub(r"uid: \S+", "uid: -", text)  # noqa: E731
    assert strip(app_util.render_overlaid_yaml(app, [str(overlay)])) == strip(want)


MERGES = [
    ({"a": {"x": 1, "y": 2}, "b": 3}, {"a": {"y": 9, "z": 8}}),
    ({"a": 1, "b": 2}, {"a": None}),
    ([{"name": "c1", "image": "a"}, {"name": "c2", "image": "b"}],
     [{"name": "c2", "image": "B"}, {"name": "c3", "image": "c"}]),
    ({"l": [1, 2]}, {"l": [3]}),
    ({"l": [{"name": "a"}, 1]}, {"l": [{"name": "a", "v": 2}]}),
    ({"a": [1]}, {"a": {"b": 2}}),
    ({"spec": {"template": {"spec": {"containers": [{"name": "w", "env": [{"name": "A"}]}]}}}},
     {"spec": {"template": {"spec": {"containers": [
         {"name": "w", "env": [{"name": "B", "value": "1"}]}, {"name": "s"}]}}}}),
    (None, {"a": 1}),
    ([], [{"name": "x"}]),
]


@pytest.mark.parametrize("base,patch", MERGES)
def test_strategic_merge_equals_jax(base, patch):
    assert pov.strategic_merge(base, patch) == jov.strategic_merge(base, patch)


@pytest.mark.parametrize("ref", ["repo/app:v1", "localhost:5000/app:v1", "localhost:5000/app",
                                 "repo/app@sha256:abc", "app", "a/b/c:t"])
@pytest.mark.parametrize("rule", [("repo/app", None, "v2"), ("localhost:5000/app", None, "v3"),
                                  ("repo/app", "mirror/app", None), ("app", "x/app", "7")])
def test_image_rules_equal_jax(ref, rule):
    name, new_name, new_tag = rule
    assert pov.split_image(ref) == jov.split_image(ref)
    assert (pov.ImageRule(name, new_name, new_tag).rewrite(ref)
            == jov.ImageRule(name, new_name, new_tag).rewrite(ref))


OVERLAY_DICTS = [
    {"namePrefix": "dev-", "namespace": "kubeflow-dev", "commonLabels": {"env": "dev"}},
    {"images": [{"name": "kubeflow-tpu/centraldashboard", "newTag": 2},
                {"name": "kubeflow-tpu/model-server", "newName": "mirror/ms"}]},
    {"patches": [{"target": {"kind": "Deployment", "name": "*web*"},
                  "patch": {"spec": {"replicas": 3}}},
                 {"target": {"kind": "VirtualService"},
                  "patch": {"spec": {"hosts": ["kf.example.com"]}}},
                 {"patch": {"metadata": {"annotations": {"a": "b"}}}}]},
    {"namePrefix": "p-", "patches": [{"target": {"name": "profiles-kfam"},
                                      "patch": {"spec": {"ports": None}}}]},
]


def _norm(resources) -> list:
    out = []
    for r in resources:
        d = r.to_dict()
        d["metadata"].pop("uid", None)
        out.append(d)
    return out


@pytest.mark.parametrize("chain", [[0], [1], [2], [3], [0, 1, 2], [3, 0], list(range(4))],
                         ids=lambda c: "-".join(map(str, c)))
def test_apply_overlays_equals_jax_on_every_bundle(chain):
    dicts = [OVERLAY_DICTS[i] for i in chain]
    got = pov.apply_overlays(pbundles.bundle_resources(pkfdef.default_spec()),
                             [pov.Overlay.from_dict(d) for d in dicts])
    want = jov.apply_overlays(jbundles.bundle_resources(jkfdef.default_spec()),
                              [jov.Overlay.from_dict(d) for d in dicts])
    assert _norm(got) == _norm(want)


def test_apply_overlay_equals_jax_on_hand_built_resources():
    def build(make):
        return [
            make("Deployment", "web", "kubeflow", spec={"replicas": 1, "template": {
                "spec": {"containers": [{"name": "web", "image": "repo/app:v1"}]}}}),
            make("Service", "dash", "kubeflow", spec={"ports": []}),
            make("VirtualService", "dash", "kubeflow", spec={
                "gateways": ["kubeflow/kubeflow-gateway"],
                "http": [{"route": [{"destination": {"host": "dash.kubeflow.svc.cluster.local"}}]}]}),
            make("Gateway", "kubeflow-gateway", "kubeflow", spec={}),
            make("Namespace", "kubeflow", ""),
            make("ClusterRole", "admin", ""),
        ]

    for d in OVERLAY_DICTS + [{"namespace": "other", "images": [
            {"name": "repo/app", "newTag": "v9"}]}]:
        got = pov.apply_overlay(build(new_resource), pov.Overlay.from_dict(d))
        want = jov.apply_overlay(build(j_new_resource), jov.Overlay.from_dict(d))
        assert _norm(got) == _norm(want), d


@pytest.mark.parametrize("bad", [{"commonLabel": {}}, {"images": [{"name": "a", "tag": "v"}]},
                                 {"patches": [{"target": {"labelSelector": "x"}, "patch": {}}]},
                                 {"patches": [{"merge": {}}]}])
def test_refusals_equal_jax(bad):
    with pytest.raises(ValueError) as got:
        pov.Overlay.from_dict(bad)
    with pytest.raises(ValueError) as want:
        jov.Overlay.from_dict(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.stem)
def test_shipped_overlays_load_as_jax(path):
    got, want = pov.Overlay.load(path), jov.Overlay.load(path)
    assert (got.name, got.name_prefix, got.namespace, got.common_labels) == (
        want.name, want.name_prefix, want.namespace, want.common_labels)
    assert [vars(i) for i in got.images] == [vars(i) for i in want.images]
    assert [vars(p) for p in got.patches] == [vars(p) for p in want.patches]
