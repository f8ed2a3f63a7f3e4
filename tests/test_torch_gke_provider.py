"""The port's GKE provider (`deploy/gke.py`): GPU node-pool payloads
written out in full, and JAX's GkeCloud cases on the port.

- JAX's own tests/test_gke_provider.py runs against the port, its
  imports pointed at the port, with its module pool an `h100` pool of
  4x8 GPUs (four hosts of 8) where JAX's is a `v5e` pool of 4x4 chips
  (four hosts of 4), from the table in
  `kubeflow_tpu_torch/deploy/kfdef.py`. `test_dry_run_cli_prints_payloads`
  then looks for that pool's machine type, `a3-highgpu-8g`, where JAX's
  looks for `ct5lp-hightpu-4t`.
- JAX's three TPU payload cases have no GPU counterpart in JAX:
  `test_multi_host_pool_golden_request`,
  `test_single_host_pool_has_no_placement_policy` and
  `test_v6e_and_v4_machine_types` are replaced by the port's GPU
  payloads, written out here: the first two under JAX's names,
  `test_h100_machine_types` for the third.
"""

import re
from pathlib import Path

import pytest

from kubeflow_tpu.deploy import gke as jgke
from kubeflow_tpu.deploy import kfdef as jkfdef
from kubeflow_tpu_torch.deploy.gke import (
    MACHINE_TYPES,
    GkeCloud,
    RecordingTransport,
    cluster_create_request,
    cluster_get_request,
    dry_run_requests,
    machine_type,
    node_pool_create_request,
    node_pool_delete_request,
    node_pool_list_request,
)
from kubeflow_tpu_torch.deploy.kfdef import NodePool, PlatformSpec
from kubeflow_tpu_torch.deploy.provisioner import CloudError

REPO = Path(__file__).resolve().parents[1]

EDITS = [  # (JAX's text, the port's, occurrences) in tests/test_gke_provider.py
    ('node_pools=[NodePool(name="tpu-pool-0", accelerator="v5e",\n'
     '                         topology="4x4")],',
     'node_pools=[NodePool(name="tpu-pool-0", accelerator="h100",\n'
     '                         topology="4x8")],', 1),
    ('assert "ct5lp-hightpu-4t" in out.stdout', 'assert "a3-highgpu-8g" in out.stdout', 1),
]
REPLACED = {"test_multi_host_pool_golden_request",
            "test_single_host_pool_has_no_placement_policy", "test_v6e_and_v4_machine_types"}


def _jax_tests_on_the_port(stem: str, edits=(), replaced=frozenset()) -> dict:
    """JAX's tests/<stem>.py with `edits` made and `kubeflow_tpu.`
    pointed at the port: its test functions and fixtures, but those in
    `replaced`."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new, count in edits:
        assert src.count(old) == count, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu_torch.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    assert replaced <= set(namespace)
    return {k: v for k, v in namespace.items() if k not in replaced
            and (k.startswith("test_") or hasattr(v, "_fixture_function_marker"))}


JAX_TESTS = _jax_tests_on_the_port("test_gke_provider", EDITS, REPLACED)
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_gke_test_is_collected_or_replaced():
    assert len([k for k in JAX_TESTS if k.startswith("test_")]) + len(REPLACED) == 12


SPEC = PlatformSpec(name="kf-prod", project="my-proj", zone="us-central2-b",
                    node_pools=[NodePool(name="gpu-pool-0", accelerator="h100",
                                         topology="4x8")])
OAUTH = ["https://www.googleapis.com/auth/cloud-platform"]


def test_multi_host_pool_golden_request():
    req = node_pool_create_request(SPEC, SPEC.node_pools[0])
    assert req.method == "POST"
    assert req.url == ("https://container.googleapis.com/v1/projects/my-proj/locations/"
                       "us-central2-b/clusters/kf-prod/nodePools")
    assert req.body == {
        "nodePool": {
            "name": "gpu-pool-0",
            # 4x8 h100 = 32 GPUs at 8/host -> exactly 4 hosts, not a knob.
            "initialNodeCount": 4,
            "config": {
                "machineType": "a3-highgpu-8g",
                "accelerators": [{"acceleratorType": "nvidia-h100-80gb",
                                  "acceleratorCount": 8}],
                "spot": False,
                "labels": {
                    "kubeflow-tpu.org/platform": "kf-prod",
                    "cloud.google.com/tpu-node-pool": "gpu-pool-0",
                    "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                    "cloud.google.com/tpu-topology": "4x8",
                },
                "oauthScopes": OAUTH,
            },
            "management": {"autoRepair": True, "autoUpgrade": False},
            # Several hosts: compact placement, and no TPU topology.
            "placementPolicy": {"type": "COMPACT"},
        }
    }


def test_single_host_pool_has_no_placement_policy():
    pool = NodePool(name="small", accelerator="h100", topology="2x2", preemptible=True)
    body = node_pool_create_request(SPEC, pool).body["nodePool"]
    assert body == {
        "name": "small",
        "initialNodeCount": 1,
        "config": {
            "machineType": "a3-highgpu-4g",
            "accelerators": [{"acceleratorType": "nvidia-h100-80gb", "acceleratorCount": 4}],
            "spot": True,
            "labels": {
                "kubeflow-tpu.org/platform": "kf-prod",
                "cloud.google.com/tpu-node-pool": "small",
                "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
                "cloud.google.com/tpu-topology": "2x2",
            },
            "oauthScopes": OAUTH,
        },
        "management": {"autoRepair": True, "autoUpgrade": False},
    }


@pytest.mark.parametrize("topology,hosts,per_host,machine", [
    ("1", 1, 1, "a3-highgpu-1g"), ("2", 1, 2, "a3-highgpu-2g"), ("1x4", 1, 4, "a3-highgpu-4g"),
    ("8", 1, 8, "a3-highgpu-8g"), ("2x8", 2, 8, "a3-highgpu-8g"), ("4x4x2", 4, 8, "a3-highgpu-8g")])
def test_h100_machine_types(topology, hosts, per_host, machine):
    body = node_pool_create_request(
        SPEC, NodePool(name="p", accelerator="h100", topology=topology)).body["nodePool"]
    assert body["initialNodeCount"] == hosts
    assert body["config"]["machineType"] == machine
    assert body["config"]["accelerators"] == [
        {"acceleratorType": "nvidia-h100-80gb", "acceleratorCount": per_host}]
    assert ("placementPolicy" in body) == (hosts > 1)


@pytest.mark.parametrize("pool", [NodePool(name="p", accelerator="h100", topology="3"),
                                  NodePool(name="p", accelerator="v5e", topology="2x2"),
                                  NodePool(name="p", accelerator="a100", topology="8")])
def test_unknown_machine_raises_cloud_error(pool):
    with pytest.raises(CloudError, match="no GKE machine type"):
        node_pool_create_request(SPEC, pool)


def test_machine_table():
    assert MACHINE_TYPES == {("h100", n): f"a3-highgpu-{n}g" for n in (1, 2, 4, 8)}
    assert machine_type("h100", 8) == "a3-highgpu-8g"


def test_cluster_and_pool_urls_equal_jax():
    """Requests that carry no accelerator are JAX's, byte for byte."""
    jspec = jkfdef.PlatformSpec(name="kf-prod", project="my-proj", zone="us-central2-b")
    for cluster in (None, "other"):
        for port, jax_ in [
                (cluster_create_request(SPEC, cluster), jgke.cluster_create_request(jspec, cluster)),
                (cluster_get_request(SPEC, cluster), jgke.cluster_get_request(jspec, cluster)),
                (node_pool_delete_request(SPEC, "a", cluster),
                 jgke.node_pool_delete_request(jspec, "a", cluster)),
                (node_pool_list_request(SPEC, cluster), jgke.node_pool_list_request(jspec, cluster))]:
            assert port.to_json() == jax_.to_json()


def test_dry_run_prints_the_cluster_then_each_gpu_pool():
    spec = PlatformSpec(name="kf", node_pools=[
        NodePool(name="a", topology="1"), NodePool(name="b", topology="2x8", preemptible=True)])
    reqs = dry_run_requests(spec)
    assert [r.url.rsplit("/", 1)[-1] for r in reqs] == ["clusters", "nodePools", "nodePools"]
    assert [r.body["nodePool"]["config"]["machineType"] for r in reqs[1:]] == [
        "a3-highgpu-1g", "a3-highgpu-8g"]
    transport = RecordingTransport()
    GkeCloud(transport).ensure_node_pool(spec, spec.node_pools[1])
    assert transport.requests[-1] == reqs[2]
