"""The port's `NativeApiServer` (`kubeflow_tpu_torch/native/apiserver.py`,
FakeApiServer's API over the compiled store) against the JAX package's.

First the storage-semantics suite of JAX's tests/test_fake_apiserver.py
runs on the port, its ``api`` fixture over the port's `FakeApiServer`
and its `NativeApiServer`: versions, conflicts, the status surface,
generations, selectors, watches, finalizers, the owner cascade, apply
and the rv order of a finalizer's cascade in the journal. Then one
seeded script of creates, updates, status updates, finalizers, owner
cascades and namespace drains through JAX's `NativeApiServer` and the
port's gives the same answers, resourceVersions and event journal, and
the port's serves it behind its HTTP facade.
"""

import random
import re
import time
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.api.objects import owner_ref as j_owner_ref
from kubeflow_tpu.native.apiserver import NativeApiServer as JNativeApiServer
from kubeflow_tpu_torch.api.objects import new_resource, owner_ref
from kubeflow_tpu_torch.native.apiserver import NativeApiServer
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(stem: str) -> dict:
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith("test_") or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_fake_apiserver")
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_storage_test_is_collected_over_both_stores():
    src = (REPO / "tests" / "test_fake_apiserver.py").read_text()
    assert set(re.findall(r"^def (test_\w+)", src, re.M)) <= set(JAX_TESTS)
    assert "api" in JAX_TESTS
    src = src.replace("kubeflow_tpu.", "kubeflow_tpu_torch.")
    assert "from kubeflow_tpu_torch.native.apiserver import NativeApiServer" in src


# -- one seeded script through both packages' native stores --------------------


def _script(seed: int, new, ref, api) -> list:
    """Creates, updates, status updates, finalizers, owner cascades and
    namespace drains, chosen by `seed`; returns every answer."""
    rng = random.Random(seed)
    out = []
    namespaces = ["team-a", "team-b"]
    for ns in namespaces:
        out.append(("ns", api.create(new("Namespace", ns, "")).metadata.resource_version))
    for step in range(60):
        op = rng.choice(("create", "create", "child", "update", "status", "finalize",
                         "delete", "drain"))
        ns = rng.choice(namespaces)
        name = f"o{rng.randrange(6)}"
        try:
            if op == "create":
                obj = new("ConfigMap", name, ns, spec={"v": step},
                          labels={"step": str(step % 3)})
                if rng.random() < 0.3:
                    obj.metadata.finalizers = ["keep"]
                got = api.create(obj)
            elif op == "child":
                parent = api.get("ConfigMap", name, ns)
                child = new("Pod", f"{name}-c{step}", ns, spec={})
                child.metadata.owner_references = [ref(parent)]
                got = api.create(child)
            elif op == "update":
                obj = api.get("ConfigMap", name, ns).thaw()
                obj.spec["v"] = -step
                got = api.update(obj)
            elif op == "status":
                obj = api.get("ConfigMap", name, ns).thaw()
                obj.status["seen"] = step
                got = api.update_status(obj)
            elif op == "finalize":
                obj = api.get("ConfigMap", name, ns).thaw()
                obj.metadata.finalizers = []
                got = api.update(obj)
            elif op == "delete":
                api.delete("ConfigMap", name, ns)
                got = None
            else:  # drain a namespace, then make it again
                api.delete("Namespace", ns, "")
                got = api.create(new("Namespace", ns, ""))
            out.append((op, None if got is None else (got.metadata.resource_version,
                                                      got.metadata.generation,
                                                      got.metadata.deletion_timestamp is None)))
        except Exception as e:
            out.append((op, type(e).__name__))
    events, rv = api.events_since(0)
    journal = [(r, e, o.kind, o.metadata.namespace, o.metadata.name, o.spec, o.status,
                o.metadata.finalizers) for r, e, o in events]
    objects = sorted((o.kind, o.metadata.namespace, o.metadata.name, o.metadata.resource_version)
                     for kind in ("Namespace", "ConfigMap", "Pod") for o in api.list(kind))
    return out + [("rv", rv, api.current_rv), ("journal", journal), ("objects", objects)]


@pytest.mark.parametrize("seed", range(5))
def test_seeded_script_same_rvs_and_journal_as_jax_native_store(seed):
    want = _script(seed, j_new_resource, j_owner_ref, JNativeApiServer())
    got = _script(seed, new_resource, owner_ref, NativeApiServer())
    assert got == want
    ops = {x[0] for x in want}
    assert {"create", "update", "status", "finalize", "delete", "drain"} <= ops, ops
    journal = dict(want[-2:-1])["journal"]
    assert [r for r, *_ in journal] == sorted(r for r, *_ in journal)
    assert any(e == "DELETED" and k == "Pod" for _, e, k, *_ in journal)


def test_native_store_serves_behind_the_port_facade_with_long_poll_and_fencing():
    """Behind `ApiServerApp`: CRUD, the long-poll watch from a bookmark,
    the status subresource and a fenced write's 409."""
    from kubeflow_tpu_torch.testing.fake_apiserver import Conflict

    api = NativeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    client = HttpApiClient(f"http://127.0.0.1:{server.server_port}",
                           watch_poll_timeout=1.0, watch_retry=0.05)
    try:
        seen = []
        client.watch(lambda ev, o: seen.append((ev, o.metadata.name)), "ConfigMap")
        time.sleep(0.3)
        created = client.create(new_resource("ConfigMap", "a", "ns", spec={"k": 1}))
        obj = client.get("ConfigMap", "a", "ns")
        obj.status["phase"] = "Ready"
        client.update_status(obj)
        assert client.get("ConfigMap", "a", "ns").status == {"phase": "Ready"}
        client.delete("ConfigMap", "a", "ns")
        deadline = time.monotonic() + 10
        while ("DELETED", "a") not in seen and time.monotonic() < deadline:
            time.sleep(0.05)
        assert seen == [("ADDED", "a"), ("MODIFIED", "a"), ("DELETED", "a")], seen
        assert created.metadata.resource_version < api.current_rv
        api.create(new_resource("Lease", "ctl", "", spec={"holderIdentity": "b",
                                                          "leaseTransitions": 2}))
        with pytest.raises(Conflict, match="fenced"):
            api.create(new_resource("ConfigMap", "late", "ns"),
                       lease_guard=("", "ctl", "a", 1))
    finally:
        client.close()
        server.shutdown()
        server.server_close()
