"""The port's PodDefault admission (`controllers/poddefault.py`) against
the JAX package's.

- JAX's own tests/test_poddefault.py runs against the port, every case:
  its source with the imports pointed at the port.
- Seeded pods and PodDefaults (selectors that match or not, env,
  volumes, mounts, tolerations, annotations and labels, conflicting
  pairs) go through both packages' stores with the mutator registered:
  the same stored pods, and the same selection and conflicts.
"""

import random
import re
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.controllers import poddefault as j_poddefault
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers import poddefault
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

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


JAX_TESTS = _jax_tests_on_the_port("test_poddefault")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_poddefault_test_is_collected():
    assert sorted(k for k in JAX_TESTS if k.startswith("test_")) == [
        "test_conflicting_defaults_skip_injection", "test_existing_pod_values_win",
        "test_matching_poddefault_injected", "test_non_matching_ignored",
        "test_tpujob_pods_get_poddefaults"]


def _script(seed: int) -> tuple[list, list]:
    """PodDefault specs and pods drawn from `seed`: label selectors over
    two keys, overlapping env names (some with equal values, some not,
    so some sets conflict), volumes, mounts, tolerations, annotations."""
    rng = random.Random(seed)
    defaults = []
    for i in range(rng.randint(1, 4)):
        spec = {"selector": {"matchLabels": {
            k: rng.choice("ab") for k in rng.sample(["app", "tier"], rng.randint(0, 2))}}}
        spec["env"] = [{"name": f"E{rng.randint(0, 3)}", "value": rng.choice(["x", "y"])}
                       for _ in range(rng.randint(0, 2))]
        if rng.random() < 0.5:
            v = f"v{rng.randint(0, 2)}"
            spec["volumes"] = [{"name": v, "emptyDir": {"medium": rng.choice(["", "Memory"])}}]
            spec["volumeMounts"] = [{"name": v, "mountPath": f"/m/{rng.randint(0, 2)}"}]
        if rng.random() < 0.5:
            spec["tolerations"] = [{"key": "k", "value": rng.choice("pq")}]
        if rng.random() < 0.5:
            spec["annotations"] = {"note": rng.choice("mn")}
            spec["labels"] = {"injected": rng.choice("mn")}
        defaults.append((f"pd{i}", spec))
    pods = []
    for i in range(4):
        labels = {k: rng.choice("ab") for k in rng.sample(["app", "tier"], rng.randint(0, 2))}
        env = [{"name": "E0", "value": "pod"}] if rng.random() < 0.3 else []
        pods.append((f"p{i}", labels, env))
    return defaults, pods


def _run(store_cls, new, module, seed: int) -> list:
    api = store_cls()
    module.register(api)
    defaults, pods = _script(seed)
    for name, spec in defaults:
        api.create(new(module.KIND, name, "ns", spec=spec))
    out = []
    for name, labels, env in pods:
        pod = api.create(new("Pod", name, "ns", labels=labels,
                             spec={"containers": [{"name": "main", "env": env}]}))
        out.append((pod.spec, dict(pod.metadata.labels), dict(pod.metadata.annotations)))
    api.close()
    return out


@pytest.mark.parametrize("seed", range(12))
def test_seeded_pods_mutate_as_in_jax(seed):
    assert _run(FakeApiServer, new_resource, poddefault, seed) == \
        _run(JFakeApiServer, j_new_resource, j_poddefault, seed)
