"""The port's Jupyter spawner and Tensorboards apps (`apps/jupyter.py`
with `apps/config/spawner_ui_config.yaml`, `apps/tensorboards.py`), the
single-page frontends they mount (`apps/static/`, `web/wsgi.py`'s
static mounts) and the static config server (`apps/staticserver.py`)
against the JAX package's.

- JAX's own tests run against the port, their imports pointed at the
  port and `google.com/tpu` read as `nvidia.com/gpu`:
  - tests/test_jupyter_app.py, every case. One assertion departs: JAX
    puts a spawn's `tpuTopology` into a TPU topology nodeSelector; the
    port accepts the field and drops it (one card has no topology), so
    on the port that line asserts the Notebook has no nodeSelector;
  - tests/test_frontends.py, every case, reading the port's copies of
    the pages; its route-drift checks read the apps' route tables
    through the port's `web/openapi.py`;
  - of tests/test_small_components.py the two static config server
    cases (its prober and echo cases run in test_torch_small_apps.py).
- One script of form posts, stop and start patches, deletes, snapshot
  and restore, PodDefault and storage-class reads, Tensorboard creates
  and deletes, with refusals, by an editor and a stranger, goes through
  both packages' apps with the Notebook and Tensorboard controllers:
  the same statuses and bodies and the same objects after every
  request, but for the accelerator (a count of `nvidia.com/gpu`) and
  the topology nodeSelector the port does not write.
"""

import re
from pathlib import Path

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.api.rbac import seed_cluster_roles as j_seed_cluster_roles
from kubeflow_tpu.apps.jupyter import JupyterApp as JJupyterApp
from kubeflow_tpu.apps.tensorboards import TensorboardsApp as JTensorboardsApp
from kubeflow_tpu.controllers.notebook import NotebookController as JNotebookController
from kubeflow_tpu.controllers.tensorboard import TensorboardController as JTensorboardController
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import seed_cluster_roles
from kubeflow_tpu_torch.apps.jupyter import JupyterApp
from kubeflow_tpu_torch.apps.tensorboards import TensorboardsApp
from kubeflow_tpu_torch.controllers.notebook import DEFAULT_IMAGE, NotebookController
from kubeflow_tpu_torch.controllers.tensorboard import TensorboardController
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import TestClient

REPO = Path(__file__).resolve().parents[1]
HDR = "x-goog-authenticated-user-email"
VOLATILE = {"uid", "creationTimestamp", "resourceVersion", "timestamp", "created", "age",
            "deletionTimestamp", "lastTransitionTime"}
TOPOLOGY_LINE = '''    assert nb.spec["nodeSelector"]["cloud.google.com/tpu-topology"] == "2x2"
'''


def _jax_tests_on_the_port(stem: str, patches=(), only=None) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port and
    the TPU resource read as the GPU: its test functions (those in
    `only`, if given) and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if (k.startswith("test_") and (only is None or k in only))
            or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = {
    **_jax_tests_on_the_port("test_jupyter_app", patches=[(
        TOPOLOGY_LINE, '''    assert "nodeSelector" not in nb.spec  # the port drops a topology
''')]),
    **_jax_tests_on_the_port("test_frontends", patches=[
        ('pathlib.Path("kubeflow_tpu/apps/static")',
         'pathlib.Path(__file__).resolve().parents[1] / "kubeflow_tpu_torch/apps/static"')]),
    **_jax_tests_on_the_port("test_small_components", patches=[
        ("from kubeflow_tpu.apps.echo import EchoApp\n", ""),
        ("from kubeflow_tpu.apps.probe import AvailabilityProber, ProberApp\n", "")], only={
        "test_static_serves_files_with_content_type", "test_static_blocks_path_traversal"}),
}
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 13 + 8 + 2


def norm(obj):
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


JAX_IMAGES = {"kubeflow-tpu/jax-notebook:latest": DEFAULT_IMAGE,  # the controller's
               "kubeflow-tpu/jax-notebook:0.6-tpu": DEFAULT_IMAGE}  # the form's


def as_port(obj):
    """A JAX-side value as the port writes it: the accelerator resource
    renamed, the topology nodeSelector dropped, the default notebook
    images (the controller's and the form's) the port's."""
    if isinstance(obj, dict):
        return {("nvidia.com/gpu" if k == "google.com/tpu" else k): as_port(v)
                for k, v in obj.items()
                if not (k == "nodeSelector" and v == {"cloud.google.com/tpu-topology": "2x2"})}
    if isinstance(obj, (list, tuple)):
        return type(obj)(as_port(v) for v in obj)
    if isinstance(obj, str):
        return JAX_IMAGES.get(obj, obj)
    return obj


def snapshot(api) -> list:
    return sorted(
        (kind, o.metadata.namespace, "" if kind == "Event" else o.metadata.name,
         norm(o.spec), norm(o.status), o.metadata.labels,
         {k: v for k, v in o.metadata.annotations.items() if k != "kubeflow-resource-stopped"},
         "kubeflow-resource-stopped" in o.metadata.annotations)
        for kind in api.kinds() for o in api.list(kind))


SCRIPT = [
    ("alice", "jupyter", "GET", "/api/namespaces", None),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks",
     {"name": "nb1", "image": "kubeflow-tpu/img:1", "cpu": "2", "memory": "4Gi", "tpu": "1",
      "tpuTopology": "2x2", "configurations": ["facade-env"],
      "dataVolumes": [{"type": "New", "name": "scratch", "size": "5Gi",
                       "mountPath": "/scratch"}]}),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks",
     {"name": "nb2", "customImage": "my/own:1", "shm": False, "workspaceVolume": None}),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks", {"name": "bad", "tpu": "x"}),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks", {"cpu": "1"}),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks",
     {"name": "nb3", "dataVolumes": [{"type": "Existing", "name": ""}]}),
    ("mallory", "jupyter", "POST", "/api/namespaces/team/notebooks", {"name": "nope"}),
    ("alice", "jupyter", "GET", "/api/namespaces/team/notebooks", None),
    ("alice", "jupyter", "PATCH", "/api/namespaces/team/notebooks/nb1", {"stopped": True}),
    ("alice", "jupyter", "GET", "/api/namespaces/team/notebooks", None),
    ("alice", "jupyter", "PATCH", "/api/namespaces/team/notebooks/nb1", {}),
    ("alice", "jupyter", "PATCH", "/api/namespaces/team/notebooks/nb1", {"stopped": False}),
    ("alice", "jupyter", "GET", "/api/namespaces/team/pvcs", None),
    ("alice", "jupyter", "GET", "/api/namespaces/team/poddefaults", None),
    ("alice", "jupyter", "GET", "/api/storageclasses", None),
    ("alice", "jupyter", "POST", "/api/namespaces/team/snapshots",
     {"pvc": "nb1-workspace", "name": "snap"}),
    ("alice", "jupyter", "POST", "/api/namespaces/team/snapshots", {"pvc": "none"}),
    ("alice", "jupyter", "GET", "/api/namespaces/team/snapshots", None),
    ("alice", "jupyter", "POST", "/api/namespaces/team/notebooks",
     {"name": "nb4", "workspaceVolume": {"type": "Snapshot", "name": "{name}-ws",
                                         "snapshot": "snap"}}),
    ("alice", "jupyter", "DELETE", "/api/namespaces/team/snapshots/snap", None),
    ("alice", "jupyter", "DELETE", "/api/namespaces/team/notebooks/nb2", None),
    ("alice", "tensorboards", "POST", "/api/namespaces/team/tensorboards",
     {"name": "tb", "logspath": "pvc://nb1-workspace/traces"}),
    ("alice", "tensorboards", "POST", "/api/namespaces/team/tensorboards", {"name": "tb2"}),
    ("alice", "tensorboards", "GET", "/api/namespaces/team/tensorboards", None),
    ("alice", "tensorboards", "GET", "/api/namespaces/team/pvcs", None),
    ("mallory", "tensorboards", "GET", "/api/namespaces/team/tensorboards", None),
    ("alice", "tensorboards", "DELETE", "/api/namespaces/team/tensorboards/tb", None),
    ("alice", "jupyter", "GET", "/api/config", None),
    (None, "jupyter", "GET", "/api/config", None),
]


def _run(store_cls, new, seed_roles, nb_ctl_cls, tb_ctl_cls, jupyter_cls, tb_cls,
         client_cls) -> list:
    api = store_cls()
    seed_roles(api)
    api.create(new("Namespace", "team", ""))
    api.create(new("RoleBinding", "edit-alice", "team", spec={
        "roleRef": {"kind": "ClusterRole", "name": "kubeflow-edit"},
        "subjects": [{"kind": "User", "name": "alice"}]}))
    api.create(new("PodDefault", "facade-env", "team", spec={
        "selector": {"matchLabels": {"facade-env": "true"}}, "desc": "the facade's env"}))
    api.create(new("StorageClass", "standard", ""))
    nb_ctl, tb_ctl = nb_ctl_cls(api), tb_ctl_cls(api)
    apps = {"jupyter": jupyter_cls(api), "tensorboards": tb_cls(api)}
    out = []
    for user, app, method, path, body in SCRIPT:
        headers = {HDR: f"accounts.google.com:{user}"} if user else {}
        resp = client_cls(apps[app], headers=headers).request(method, path, body=body)
        nb_ctl.controller.run_until_idle()
        tb_ctl.controller.run_until_idle()
        out.append((method, path, resp.status, norm(resp.json()), snapshot(api)))
    api.close()
    return out


def test_spawner_script_matches_jax():
    port = _run(FakeApiServer, new_resource, seed_cluster_roles, NotebookController,
                TensorboardController, JupyterApp, TensorboardsApp, TestClient)
    jax = _run(JFakeApiServer, j_new_resource, j_seed_cluster_roles, JNotebookController,
               JTensorboardController, JJupyterApp, JTensorboardsApp, JTestClient)
    for step, (got, want) in enumerate(zip(port, jax)):
        if SCRIPT[step][-2] == "/api/config":
            continue  # the form's images and accelerator are the port's (below)
        assert got == as_port(want), f"step {step}: {SCRIPT[step][:4]}"
    nb1 = next(o for o in port[1][4] if o[:3] == ("Notebook", "team", "nb1"))
    assert nb1[3]["resources"]["limits"] == {"nvidia.com/gpu": 1}
    assert "nodeSelector" not in nb1[3]
    config = port[-2][3]["config"]
    assert config["tpu"]["resource"] == "nvidia.com/gpu"
    assert config["image"]["value"] == DEFAULT_IMAGE
    assert [s for _, _, s, _, _ in port] == [200, 200, 200, 400, 400, 400, 403, 200, 200,
                                             200, 400, 200, 200, 200, 403, 200, 404, 200,
                                             200, 200, 200, 200, 400, 200, 200, 403, 200,
                                             200, 401]
