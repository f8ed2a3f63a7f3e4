"""The port's deploy tool (`deploy/{kfdef,provisioner,bundles,apply,
server}.py`) against the JAX package's.

- JAX's own tests/test_deploy.py runs against the port, every case, its
  imports pointed at the port. One case names a TPU pool and its
  capacity, and takes the GPU names from the table in
  `kubeflow_tpu_torch/deploy/kfdef.py` (`EDITS` below):
  `test_tpu_node_pool_provisioning` provisions an `h100` pool of 4x8
  GPUs (four hosts of 8) where JAX's is a `v5e` pool of 4x4 chips (four
  hosts of 4), and sums `nvidia.com/gpu` where JAX's sums
  `google.com/tpu`.
- Parity: `bundle_resources` equals JAX's, as dicts, for the default
  spec and for specs with overlays; the two-phase apply leaves the same
  objects and the same PlatformDeployment status in both stores; and
  `FakeCloud`'s Nodes equal JAX's once the GPU table is applied to
  JAX's (the accelerator label, the capacity's name, and the GPUs a host
  where a pool spans hosts).
- The GPU table itself: `num_chips`/`num_hosts`, the labels and capacity
  of each Node, the default spec's pool and the YAML round trip.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu.deploy import apply as japply
from kubeflow_tpu.deploy import bundles as jbundles
from kubeflow_tpu.deploy import kfdef as jkfdef
from kubeflow_tpu.deploy import provisioner as jprov
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.deploy import apply as papply
from kubeflow_tpu_torch.deploy import bundles as pbundles
from kubeflow_tpu_torch.deploy import kfdef as pkfdef
from kubeflow_tpu_torch.deploy import provisioner as pprov
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]

# JAX's text -> the port's, each an exact string of tests/test_deploy.py.
EDITS = [
    ("from kubeflow_tpu.deploy.provisioner import TOPOLOGY_LABEL, TPU_RESOURCE",
     "from kubeflow_tpu.deploy.provisioner import TOPOLOGY_LABEL, GPU_RESOURCE"),
    ('node_pools=[NodePool(name="pool-a", accelerator="v5e", topology="4x4")],',
     'node_pools=[NodePool(name="pool-a", accelerator="h100", topology="4x8")],'),
    ("assert len(nodes) == 4  # 16 chips / 4 per host",
     "assert len(nodes) == 4  # 32 GPUs / 8 per host"),
    ('total = sum(n.spec["capacity"][TPU_RESOURCE] for n in nodes)',
     'total = sum(n.spec["capacity"][GPU_RESOURCE] for n in nodes)'),
    ('assert total == topology_chips("4x4") == 16',
     'assert total == topology_chips("4x8") == 32'),
    ('assert all(n.metadata.labels[TOPOLOGY_LABEL] == "4x4" for n in nodes)',
     'assert all(n.metadata.labels[TOPOLOGY_LABEL] == "4x8" for n in nodes)'),
]


def _jax_tests_on_the_port(stem: str, edits=()) -> dict:
    """JAX's tests/<stem>.py with `edits` made and `kubeflow_tpu.`
    pointed at the port: its test functions and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu_torch.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_deploy", EDITS)
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_deploy_test_is_collected():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) == 13


VOLATILE = {"uid", "creationTimestamp", "resourceVersion", "deletionTimestamp",
            "lastTransitionTime", "timestamp"}


def norm(obj):
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


OVERLAYS = [
    [{"namePrefix": "dev-", "namespace": "kubeflow-dev", "commonLabels": {"env": "dev"}}],
    [{"images": [{"name": "kubeflow-tpu/jupyter-web-app", "newTag": "v2.0.0"}],
      "patches": [{"target": {"kind": "Deployment", "name": "jupyter-*"},
                   "patch": {"spec": {"replicas": 2}}}]},
     {"namePrefix": "p-"}],
]


@pytest.mark.parametrize("overlays", [None, *OVERLAYS], ids=["default", "dev", "chain"])
def test_bundle_resources_equal_jax(overlays):
    port, jax_ = pkfdef.default_spec("kf"), jkfdef.default_spec("kf")
    if overlays:
        port.overlays = jax_.overlays = overlays
    got = [norm(r.to_dict()) for r in pbundles.bundle_resources(port)]
    want = [norm(r.to_dict()) for r in jbundles.bundle_resources(jax_)]
    assert got == want
    assert list(pbundles.BUNDLES) == list(jbundles.BUNDLES)
    assert pbundles.CORE_DEPLOYMENTS == jbundles.CORE_DEPLOYMENTS


@pytest.mark.parametrize("app", list(jbundles.BUNDLES))
def test_each_bundle_equals_jax(app):
    spec, jspec = pkfdef.default_spec(), jkfdef.default_spec()
    got = [norm(r.to_dict()) for r in pbundles.bundle_resources(spec, [app])]
    assert got == [norm(r.to_dict()) for r in jbundles.bundle_resources(jspec, [app])]
    assert "google.com/tpu" not in repr(got)


# (JAX pool, port pool) pairs with the same host count: a single-host
# pool keeps its topology, a pool of several hosts doubles its count (8
# GPUs a host against 4 chips).
POOLS = [(("v5e", "2x2"), ("h100", "2x2")), (("v5e", "1"), ("h100", "1")),
         (("v5e", "4x4"), ("h100", "4x8")), (("v5e", "2x4"), ("h100", "4x4")),
         (("v4", "2x2x2"), ("h100", "2x2x4"))]


def _translated(jnode: dict, accelerator: str, topology: str, per_host: int) -> dict:
    """A JAX Node dict with the GPU table applied."""
    labels = dict(jnode["metadata"]["labels"])
    del labels[jprov.ACCELERATOR_LABEL]
    labels[pprov.ACCELERATOR_LABEL] = pkfdef.gke_accelerator(accelerator)
    labels[pprov.TOPOLOGY_LABEL] = topology
    spec = dict(jnode["spec"])
    assert list(spec["capacity"]) == [jprov.TPU_RESOURCE]
    spec["capacity"] = {pprov.GPU_RESOURCE: per_host}
    return {**jnode, "metadata": {**jnode["metadata"], "labels": labels}, "spec": spec}


@pytest.mark.parametrize("pair", POOLS, ids=lambda p: f"{p[0][1]}-{p[1][1]}")
@pytest.mark.parametrize("preemptible", [False, True])
def test_fake_cloud_nodes_equal_jax_apart_from_the_gpu_table(pair, preemptible):
    (jacc, jtopo), (acc, topo) = pair
    api, japi = FakeApiServer(), JFakeApiServer()
    pool = pkfdef.NodePool(name="pool-a", accelerator=acc, topology=topo,
                           preemptible=preemptible)
    jpool = jkfdef.NodePool(name="pool-a", accelerator=jacc, topology=jtopo,
                            preemptible=preemptible)
    assert pool.num_hosts == jpool.num_hosts
    pprov.FakeCloud(api).ensure_node_pool(pkfdef.PlatformSpec(name="kf"), pool)
    jprov.FakeCloud(japi).ensure_node_pool(jkfdef.PlatformSpec(name="kf"), jpool)
    per_host = pool.num_chips // pool.num_hosts
    got = sorted((norm(n.to_dict()) for n in api.list("Node", "")),
                 key=lambda n: n["metadata"]["name"])
    want = sorted((_translated(norm(n.to_dict()), acc, topo, per_host)
                   for n in japi.list("Node", "")), key=lambda n: n["metadata"]["name"])
    assert got == want
    assert sum(n["spec"]["capacity"][pprov.GPU_RESOURCE] for n in got) == pool.num_chips


def _snapshot(api) -> list:
    return sorted(
        (kind, o.metadata.namespace, o.metadata.name, norm(o.to_dict()))
        for kind in api.kinds() if kind not in ("Event", "Node") for o in api.list(kind))


@pytest.mark.parametrize("fail_next", [0, 2, 10])
def test_two_phase_apply_leaves_jax_objects_and_status(fail_next):
    """Every object but the Nodes (held above) and the PlatformDeployment
    status equal JAX's after an apply, a second apply and (when the
    apply succeeded) a delete, through a cloud failing `fail_next`
    times."""
    api, japi = FakeApiServer(), JFakeApiServer()
    spec, jspec = pkfdef.default_spec("kf"), jkfdef.default_spec("kf")
    spec.email = jspec.email = "admin@x.co"
    cloud = pprov.FakeCloud(api, fail_next=fail_next)
    jcloud = jprov.FakeCloud(japi, fail_next=fail_next)
    for _ in range(2):
        got = papply.apply_platform(spec, api, cloud)
        want = japply.apply_platform(jspec, japi, jcloud)
        assert vars(got) == vars(want)
        assert _snapshot(api) == _snapshot(japi)
        assert cloud.calls == jcloud.calls
    assert len(api.list("Node", "")) == len(japi.list("Node", ""))
    if got.succeeded:
        papply.delete_platform(spec, api, cloud)
        japply.delete_platform(jspec, japi, jcloud)
        assert _snapshot(api) == _snapshot(japi)
        assert api.list("Node", "") == []


def test_the_gpu_table():
    pool = pkfdef.NodePool(name="p")
    assert (pool.accelerator, pool.topology) == ("h100", "2x2")
    assert (pool.num_chips, pool.num_hosts) == (4, 1)
    assert pkfdef.NodePool(name="p", topology="4x8").num_hosts == 4
    assert pkfdef.NodePool(name="p", accelerator="b200", topology="2x8").num_hosts == 2
    assert pkfdef.GPUS_PER_HOST == {"h100": 8}
    assert pkfdef.gke_accelerator("h100") == "nvidia-h100-80gb"
    assert pkfdef.gke_accelerator("nvidia-l4") == "nvidia-l4"
    [default] = pkfdef.default_spec().node_pools
    assert (default.name, default.accelerator, default.topology) == ("gpu-pool-0", "h100", "4x8")
    assert (pprov.GPU_RESOURCE, pprov.ACCELERATOR_LABEL) == (
        "nvidia.com/gpu", "cloud.google.com/gke-accelerator")
    # The platform, pool and topology labels keep JAX's names.
    for name in ("PLATFORM_LABEL", "POOL_LABEL", "TOPOLOGY_LABEL"):
        assert getattr(pprov, name) == getattr(jprov, name)


def test_spec_yaml_keys_equal_jax():
    spec = pkfdef.PlatformSpec(name="kf", project="p", zone="z", provider="gke",
                               email="a@b.c", applications=["namespace"],
                               node_pools=[pkfdef.NodePool(name="a", topology="4x8",
                                                           preemptible=True)],
                               overlays=[{"namePrefix": "x-"}])
    text = spec.to_yaml()
    assert pkfdef.PlatformSpec.from_yaml(text) == spec
    jspec = jkfdef.PlatformSpec.from_yaml(text)
    assert jspec.to_dict() == spec.to_dict()
    assert jspec.node_pools[0].num_chips == spec.node_pools[0].num_chips == 32


def test_cli_applies_the_default_spec_without_torch(tmp_path):
    spec_file = tmp_path / "platform.yaml"
    gen = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.deploy", "generate"],
                         cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert gen.returncode == 0, gen.stderr
    spec_file.write_text(gen.stdout)
    code = ("import runpy, sys; sys.argv = ['deploy', 'apply', '-f', sys.argv[1]]\n"
            "try:\n    runpy.run_module('kubeflow_tpu_torch.deploy', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "print('torch' in sys.modules, 'jax' in sys.modules, rc)")
    out = subprocess.run([sys.executable, "-c", code, str(spec_file)], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "kubeflow-tpu: succeeded=True resources=33 nodes=4 deployments=13"
    assert lines[-1] == "False False 0"
