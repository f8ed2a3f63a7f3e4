"""The port's multi-version conversion (`api/versioning.py`, the store's
hub normalization and `convert_to`, the facade's ``?version=``, the
CLI's ``--api-version``) against the JAX package's.

- JAX's own tests/test_versioning.py runs against the port, every case,
  its imports pointed at the port and `google.com/tpu` read as
  `nvidia.com/gpu` (the port's v1alpha1 `tpuChips` is the GPU limit).
- Seeded Notebooks at each served version go through both registries to
  every served version: the same apiVersion, spec, stash annotation,
  metadata and status, field by field, the accelerator renamed; and a
  round trip through every version returns the object.
- A Notebook written at v1alpha1 through the store, the facade and
  ``kftpu apply`` is stored at v1 and reads back equal at every served
  version, through the store, the facade and ``kftpu get``; its WAL holds
  the hub form only, and a fresh store over the state directory reads
  back the same objects.
"""

import copy
import io
import json
import random
import re
import sys
from pathlib import Path

import pytest
import yaml

from kubeflow_tpu.api import versioning as j_versioning
from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu_torch import cli
from kubeflow_tpu_torch.api import versioning
from kubeflow_tpu_torch.api.objects import GROUP, Resource, new_resource
from kubeflow_tpu_torch.controllers.notebook import NotebookController
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer, Invalid
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]
VERSIONS = ("v1alpha1", "v1beta1", "v1")


def _jax_tests_on_the_port(stem: str) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port and
    the TPU resource read as the GPU: its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    src = src.replace('"google.com/tpu"', '"nvidia.com/gpu"')
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_versioning")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_versioning_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 13


def _as_port(value):
    """A JAX-side value with the accelerator as the port names it."""
    if isinstance(value, dict):
        return {("nvidia.com/gpu" if k == "google.com/tpu" else k): _as_port(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_as_port(v) for v in value]
    if isinstance(value, str) and "google.com/tpu" in value:
        return value.replace("google.com/tpu", "nvidia.com/gpu")
    return value


def _spec(rng, version: str, accelerator: str) -> dict:
    """A seeded Notebook spec at `version`, naming `accelerator`."""
    env = [{"name": f"E{i}", "value": str(rng.randint(0, 9))} for i in range(rng.randint(0, 3))]
    if rng.random() < 0.5:
        env.append({"name": "S", "valueFrom": {"secretKeyRef": {"name": "s"}}})
    if version == "v1alpha1":
        spec = {"containerImage": f"img:{rng.randint(0, 9)}"}
        if rng.random() < 0.7:
            spec["cpu"] = rng.choice(["500m", "1", "2"])
        if rng.random() < 0.5:
            spec["memory"] = rng.choice(["1Gi", "4Gi"])
        if rng.random() < 0.6:
            spec["tpuChips"] = rng.choice([1, 2, 4, 8])
        if env and rng.random() < 0.8:
            spec["env"] = {e["name"]: e["value"] for e in env if "value" in e}
        return spec
    spec = {"image": f"img:{rng.randint(0, 9)}"}
    if env:
        spec["env"] = env
    resources = {}
    if rng.random() < 0.7:
        resources["requests"] = {"cpu": rng.choice(["500m", "2"]),
                                 **({"memory": "4Gi"} if rng.random() < 0.5 else {})}
    if rng.random() < 0.7:
        resources["limits"] = {accelerator: rng.choice([1, 4]),
                               **({"memory": "8Gi"} if rng.random() < 0.5 else {})}
    if resources:
        spec["resources"] = resources
    if rng.random() < 0.5:
        spec["volumes"] = [{"name": "ws", "persistentVolumeClaim": {"claimName": "ws"}}]
        spec["volumeMounts"] = [{"name": "ws", "mountPath": "/home/jovyan"}]
    if version == "v1":
        if rng.random() < 0.5:
            spec["tolerations"] = [{"key": "gpu", "operator": "Exists"}]
        if rng.random() < 0.5:
            spec["nodeSelector"] = {"pool": rng.choice(["a", "b"])}
        if rng.random() < 0.5:
            spec["podLabels"] = {"team": "ml"}
    return spec


def _pair(seed: int, version: str):
    """The same seeded Notebook for both packages (status and labels
    included), the accelerator named each package's way."""
    rng = random.Random(f"{seed}-{version}")
    state = rng.getstate()
    t_spec = _spec(rng, version, "nvidia.com/gpu")
    rng.setstate(state)
    j_spec = _spec(rng, version, "google.com/tpu")
    status = {"readyReplicas": rng.randint(0, 1)}
    objs = []
    for new, spec in ((new_resource, t_spec), (j_new_resource, j_spec)):
        res = new("Notebook", f"nb{seed}", "team", spec=copy.deepcopy(spec),
                  labels={"app": f"nb{seed}"})
        res.api_version = f"{GROUP}/{version}"
        res.status = dict(status)
        objs.append(res)
    return objs


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("source", VERSIONS)
def test_conversions_equal_jax_field_by_field(seed, source):
    port, jax = _pair(seed, source)
    for target in VERSIONS:
        got = versioning.registry.convert(port, target).to_dict()
        want = _as_port(j_versioning.registry.convert(jax, target).to_dict())
        for field in ("apiVersion", "kind", "spec", "status"):
            assert got[field] == want[field], (seed, source, target, field)
        assert got["metadata"]["annotations"] == want["metadata"]["annotations"]
        assert got["metadata"]["labels"] == want["metadata"]["labels"]


@pytest.mark.parametrize("seed", range(10))
def test_round_trip_through_every_version_is_lossless(seed):
    hub, _ = _pair(seed, "v1")
    obj = hub
    for target in ("v1alpha1", "v1beta1", "v1alpha1", "v1"):
        obj = versioning.registry.convert(obj, target)
    assert obj.spec == hub.spec
    assert versioning.STASH_ANNOTATION not in obj.metadata.annotations


MANIFEST = {"apiVersion": f"{GROUP}/v1alpha1", "kind": "Notebook",
            "metadata": {"name": "nb", "namespace": "team", "labels": {"app": "nb"}},
            "spec": {"containerImage": "img:7", "cpu": "1", "memory": "2Gi", "tpuChips": 1,
                     "env": {"A": "1", "B": "2"}}}


def _read_back(read) -> dict:
    """Each served version's spec and apiVersion, read through `read`."""
    return {v: (r.api_version, r.spec) for v in VERSIONS for r in [read(v)]}


def test_store_facade_and_cli_write_at_v1alpha1_read_back_everywhere(tmp_path):
    state = tmp_path / "store"
    api = FakeApiServer(persist_dir=str(state))
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_port}"
    client = HttpApiClient(url)
    try:
        # Three writers at v1alpha1: the store, the facade, the CLI.
        for name, write in (
                ("by-store", lambda res: api.create(res)),
                ("by-facade", lambda res: client.create(res))):
            doc = copy.deepcopy(MANIFEST)
            doc["metadata"]["name"] = name
            write(Resource.from_dict(doc))
        doc = copy.deepcopy(MANIFEST)
        doc["metadata"]["name"] = "by-cli"
        out, old = io.StringIO(), sys.stdout
        sys.stdout, sys.stdin = out, io.StringIO(yaml.safe_dump(doc))
        try:
            assert cli.main(["--server", url, "apply", "-f", "-"]) == 0
        finally:
            sys.stdout, sys.stdin = old, sys.__stdin__
        assert "notebook/by-cli created" in out.getvalue()

        for name in ("by-store", "by-facade", "by-cli"):
            stored = api.get("Notebook", name, "team")
            assert stored.api_version == f"{GROUP}/v1"
            assert stored.spec["resources"]["limits"] == {"nvidia.com/gpu": 1}
            via_store = _read_back(lambda v: api.convert_to(stored, v))
            via_facade = _read_back(lambda v: client.get("Notebook", name, "team", version=v))
            assert via_facade == via_store
            assert via_store["v1alpha1"] == (f"{GROUP}/v1alpha1", MANIFEST["spec"])
            for v in VERSIONS:
                out = io.StringIO()
                sys.stdout = out
                try:
                    assert cli.main(["--server", url, "get", "notebook", name, "-n", "team",
                                     "--api-version", v, "-o", "json"]) == 0
                finally:
                    sys.stdout = old
                got = json.loads(out.getvalue())
                assert (got["apiVersion"], got["spec"]) == via_store[v], (name, v)
        # An apply of the same manifest again is a no-op at the hub.
        rv = api.get("Notebook", "by-facade", "team").metadata.resource_version
        doc = copy.deepcopy(MANIFEST)
        doc["metadata"]["name"] = "by-facade"
        client.apply(Resource.from_dict(doc))
        assert api.get("Notebook", "by-facade", "team").metadata.resource_version == rv
        before = {o.metadata.name: o.to_dict() for o in api.list("Notebook", "team")}
    finally:
        client.close()
        server.shutdown()
        server.server_close()
        api.close()
    # The WAL and snapshot hold the hub form only; a fresh store reads back
    # the same objects.
    on_disk = "".join(p.read_text() for p in state.iterdir() if p.is_file())
    assert "v1alpha1" not in on_disk and "containerImage" not in on_disk
    fresh = FakeApiServer(persist_dir=str(state))
    try:
        after = {o.metadata.name: o.to_dict() for o in fresh.list("Notebook", "team")}
        assert after == before
    finally:
        fresh.close()


def test_spoke_update_and_apply_go_through_the_hub():
    """An update at v1alpha1 lands at v1 and drives the Notebook
    controller's StatefulSet; an update at an unserved version is
    Invalid and changes nothing."""
    api = FakeApiServer()
    ctl = NotebookController(api)
    doc = copy.deepcopy(MANIFEST)
    api.create(Resource.from_dict(doc))
    ctl.controller.run_until_idle()
    down = api.convert_to(api.get("Notebook", "nb", "team"), "v1alpha1")
    down.spec["containerImage"] = "img:8"
    api.update(down)
    ctl.controller.run_until_idle()
    sts = api.get("StatefulSet", "nb", "team")
    assert sts.spec["template"]["spec"]["containers"][0]["image"] == "img:8"
    bad = api.get("Notebook", "nb", "team").thaw()
    bad.api_version = f"{GROUP}/v9"
    with pytest.raises(Invalid):
        api.update(bad)
    assert api.get("Notebook", "nb", "team").spec["image"] == "img:8"
