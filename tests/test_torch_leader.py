"""Leader election and write fencing in the port
(`kubeflow_tpu_torch/controllers/leader.py`, the store's
`check_lease_guard`, the facade's X-Kftpu-Lease-Guard header and the
binary's ``--leader-elect``) against the JAX package's.

- JAX's own tests (tests/test_leader_election.py: CAS acquisition,
  expiry takeover with a new generation, release, step-down, the
  fencing of every write form in process and over HTTP) run against the
  port: the module's source with its imports pointed at the port.
- A stale guard's create, update, update_status and delete are a
  Conflict at the store and a 409 through the facade; a malformed header
  is a 400; an unguarded write and a write under the live term land.
- The binary with ``--leader-elect``: one replica leads and reconciles,
  the other stands by and builds no controller; the leader exits 0 on
  SIGTERM and hands the Lease over at once; the successor exits 2 when
  its Lease is taken. Every wait on a subprocess has its own timeout.
"""

import http.client
import json
import re
import time
from pathlib import Path

import pytest

from kubeflow_tpu_torch.api import make_tpujob
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.controllers.leader import LEASE_KIND, LeaderElector
from kubeflow_tpu_torch.controllers.tpujob import LABEL_JOB
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import Conflict, FakeApiServer
from kubeflow_tpu_torch.testing.job_plane import JobPlane
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: its test functions by name."""
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{path.stem}"}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items() if k.startswith("test_") and callable(v)}


JAX_TESTS = _jax_tests_on_the_port(REPO / "tests" / "test_leader_election.py")


def test_all_of_jax_leader_tests_are_collected():
    assert len(JAX_TESTS) == 11


@pytest.mark.parametrize("name", sorted(JAX_TESTS))
def test_jax_leader_election_tests_on_the_port(name):
    JAX_TESTS[name]()


# -- fencing, every verb, in process and through the facade -------------------


def _deposed_guard(api):
    """A guard of term 1 after another replica took the Lease (term 2)."""
    a = LeaderElector(api, "mgr", "a", lease_duration=0.6, renew_deadline=0.4)
    assert a._try_acquire_or_renew()
    stale = ("", "mgr", "a", a.transitions)
    lease = api.get(LEASE_KIND, "mgr", "").thaw()
    lease.spec["renewTime"] = time.time() - 10
    api.update(lease)
    b = LeaderElector(api, "mgr", "b", lease_duration=0.6, renew_deadline=0.4)
    assert b._try_acquire_or_renew() and b.transitions == 2
    return stale, ("", "mgr", "b", b.transitions)


def _writes(api, guard):
    """Each write form under `guard`, on a Widget w1 that exists."""
    def update(status: bool):
        w = api.get("Widget", "w1").thaw()
        w.spec["touched"] = True
        w.status["seen"] = True
        return (api.update_status if status else api.update)(w, lease_guard=guard)

    return {
        "create": lambda: api.create(new_resource("Widget", "w2"), lease_guard=guard),
        "update": lambda: update(False),
        "update_status": lambda: update(True),
        "delete": lambda: api.delete("Widget", "w1", lease_guard=guard),
    }


@pytest.mark.parametrize("verb", ["create", "update", "update_status", "delete"])
def test_stale_guard_is_a_conflict_at_the_store_and_the_live_term_writes(verb):
    api = FakeApiServer()
    api.create(new_resource("Widget", "w1"))
    stale, live = _deposed_guard(api)
    before = api.get("Widget", "w1")
    with pytest.raises(Conflict, match="fenced"):
        _writes(api, stale)[verb]()
    assert api.get("Widget", "w1") is before  # nothing committed
    assert [w.metadata.name for w in api.list("Widget")] == ["w1"]
    _writes(api, live)[verb]()  # the successor's term writes
    api.create(new_resource("Widget", "w4"))  # an unguarded write is not fenced
    # The guard names a Lease that does not exist: fenced too.
    with pytest.raises(Conflict, match="is gone"):
        api.create(new_resource("Widget", "w3"), lease_guard=("", "nope", "b", 2))


def _http(port: int, method: str, path: str, body=None, guard=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    headers = {"Content-Type": "application/json"}
    if guard is not None:
        headers["X-Kftpu-Lease-Guard"] = guard if isinstance(guard, str) else json.dumps(guard)
    try:
        conn.request(method, path, body=json.dumps(body) if body is not None else None,
                     headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


@pytest.fixture
def facade():
    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    try:
        yield api, server.server_port
    finally:
        server.shutdown()
        server.server_close()
        api.close()


@pytest.mark.parametrize("verb", ["create", "update", "update_status", "delete"])
def test_stale_guard_is_a_409_through_the_facade(facade, verb):
    api, port = facade
    api.create(new_resource("Widget", "w1"))
    stale, live = _deposed_guard(api)
    w1 = api.get("Widget", "w1").to_dict()
    requests = {
        "create": ("POST", "/apis/Widget", new_resource("Widget", "w2").to_dict()),
        "update": ("PUT", "/apis/Widget/default/w1", w1),
        "update_status": ("PUT", "/apis/Widget/default/w1/status", w1),
        "delete": ("DELETE", "/apis/Widget/default/w1", None),
    }
    method, path, body = requests[verb]
    status, text = _http(port, method, path, body, guard=list(stale))
    assert status == 409 and "fenced" in text
    assert [w.metadata.name for w in api.list("Widget")] == ["w1"]
    status, _ = _http(port, method, path, body, guard=list(live))
    assert status in (200, 201)


@pytest.mark.parametrize("header", ["not json", '["", "mgr", "a"]', '["", "mgr", "a", "x"]',
                                    "{}"])
def test_malformed_guard_header_is_a_400(facade, header):
    api, port = facade
    status, text = _http(port, "POST", "/apis/Widget", new_resource("Widget", "w").to_dict(),
                         guard=header)
    assert status == 400 and "X-Kftpu-Lease-Guard" in text
    assert api.list("Widget") == []


# -- the binary -----------------------------------------------------------------


def test_binary_leader_elect_leads_stands_by_hands_over_and_exits_2_when_deposed():
    lease = dict(lease_name="mgr", lease_duration=2.0, renew_deadline=1.2, retry_period=0.2)
    with JobPlane(controllers=(), run_pods=False) as plane:
        a = plane.start_manager(("tpujob",), leader_elect=True, identity="a",
                                wait_for="manager ready tpujob", timeout=60, **lease)
        b = plane.start_manager(("tpujob",), leader_elect=True, identity="b", timeout=60,
                                **lease)
        assert a.line_time("leading a gen 1") is not None
        plane.api.create(make_tpujob("j", replicas=2, tpu_chips_per_worker=0,
                                     command=("true",)))
        plane.run_until(lambda: len(plane.api.list("Pod", label_selector={LABEL_JOB: "j"}))
                        == 2, 60, "the leader to create the gang")
        # The standby built no controller and reconciled nothing.
        assert [line for _, line in b.lines] == ["standby b"]
        # SIGTERM: a clean stop releases the Lease, so b leads at once.
        assert a.stop(timeout=60) == 0
        b.wait_for("leading b gen 2", timeout=10)
        b.wait_for("manager ready tpujob", timeout=60)
        assert plane.api.get(LEASE_KIND, "mgr", "").spec["holderIdentity"] == "b"
        # Another replica takes the Lease: b is deposed and exits 2.
        lease_obj = plane.api.get(LEASE_KIND, "mgr", "").thaw()
        lease_obj.spec["renewTime"] = time.time() - 10
        plane.api.update(lease_obj)
        c = LeaderElector(plane.api, "mgr", "c", lease_duration=60, renew_deadline=30)
        assert c._try_acquire_or_renew() and c.transitions == 3
        b.expect_exit = True
        assert b.proc.wait(timeout=30) == 2
        assert b.line_time("deposed b") is not None
        assert [line for _, line in plane.leadership()] == [
            "standby a", "leading a gen 1", "standby b", "leading b gen 2", "deposed b"]
