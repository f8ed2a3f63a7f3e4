"""The port's long-poll watch (`testing/apiserver_http.py`): the facade's
default watch form and the client's degraded mode, against the JAX
package's facade and client.

- The facade long-polls when ``stream`` is absent: for one seeded
  sequence of writes, every long-poll answer of the port's facade (its
  events and resourceVersion) equals the JAX facade's over a store given
  the same writes; a bookmark past the journal's horizon is a 410 on
  both, `timeoutSeconds` is capped at 60, and the multiplexed ``_``
  watch filters per event by RBAC on the secure facade.
- A facade that affirmatively rejects ``stream=true`` is long-polled and
  re-probed; once it serves the stream again the client streams.
- A stray 400 on the stream does not degrade the client for good: the
  next pass streams.
- Injected stream faults (`ChaosProxy`: truncated streams, a 503 on the
  stream) degrade the watch to long-poll for the breaker's cooldown, the
  client long-polls while degraded and then streams again, with no event
  lost; `watch_stats` counts each of these.
- The events a long-polling client delivers equal those a streaming
  client delivers, in order.
"""

import json
import random
import threading
import time

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.testing.apiserver_http import ApiServerApp as JApiServerApp
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import TestClient as JTestClient
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.api.rbac import (
    CLUSTER_ADMIN_ROLE,
    VIEW_ROLE,
    make_cluster_role_binding,
    seed_cluster_roles,
)
from kubeflow_tpu_torch.api.tokens import TokenRegistry
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.chaos import ChaosProxy, Fault, FaultSchedule
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import TestClient
from kubeflow_tpu_torch.web.wsgi import HttpError, serve


def wait_for(pred, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _writes(seed: int):
    """A seeded sequence of (op, kind, name, spec) writes."""
    rng = random.Random(seed)
    live: list[tuple[str, str]] = []
    out = []
    for i in range(40):
        r = rng.random()
        if r < 0.5 or not live:
            kind = rng.choice(["Widget", "Gadget"])
            out.append(("create", kind, f"o{i}", {"n": i}))
            live.append((kind, f"o{i}"))
        elif r < 0.85:
            kind, name = rng.choice(live)
            out.append(("update", kind, name, {"n": i}))
        else:
            kind, name = live.pop(rng.randrange(len(live)))
            out.append(("delete", kind, name, None))
    return out


def _apply(api, new, op, kind, name, spec):
    if op == "create":
        api.create(new(kind, name, "default", spec=spec))
    elif op == "update":
        obj = api.get(kind, name, "default").thaw()
        obj.spec = spec
        api.update(obj)
    else:
        api.delete(kind, name, "default")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_long_poll_answers_equal_jax(seed):
    t_api, j_api = FakeApiServer(), JFakeApiServer()
    port, jax = TestClient(ApiServerApp(t_api)), JTestClient(JApiServerApp(j_api))
    rv = 0
    for step, (op, kind, name, spec) in enumerate(_writes(seed)):
        _apply(t_api, new_resource, op, kind, name, spec)
        _apply(j_api, j_new_resource, op, kind, name, spec)
        if step % 5:
            continue
        for path in ("/apis/_", "/apis/Widget", "/apis/Gadget"):
            query = f"?watch=true&resourceVersion={rv}&timeoutSeconds=0.05"
            got, want = port.get(path + query), jax.get(path + query)
            assert got.status == want.status == 200
            g, w = got.json(), want.json()
            assert g["resourceVersion"] == w["resourceVersion"]
            strip = lambda evs: [(e["type"], e["rv"], e["object"]["kind"],  # noqa: E731
                                  e["object"]["metadata"]["name"], e["object"]["spec"])
                                 for e in evs]
            assert strip(g["events"]) == strip(w["events"]), (seed, step, path)
        rv = g["resourceVersion"]
    # Malformed bookmarks: the same 400 on both.
    for query in ("?watch=true&resourceVersion=abc",):
        assert port.get("/apis/_" + query).status == jax.get("/apis/_" + query).status == 400


def test_long_poll_gone_past_the_horizon_and_timeout_cap(monkeypatch):
    api = FakeApiServer(journal_size=4)
    client = TestClient(ApiServerApp(api))
    seen = {}
    real = api.wait_events

    def spy(rv, kind=None, namespace=None, timeout=10.0):
        seen["timeout"] = timeout
        return real(rv, kind=kind, namespace=namespace, timeout=0.01)

    monkeypatch.setattr(api, "wait_events", spy)
    assert client.get("/apis/_?watch=true&resourceVersion=0&timeoutSeconds=600").status == 200
    assert seen["timeout"] == 60.0
    assert client.get("/apis/_?watch=true&resourceVersion=0").status == 200
    assert seen["timeout"] == 10.0
    monkeypatch.setattr(api, "wait_events", real)
    for i in range(10):
        api.create(new_resource("Widget", f"w{i}", "default"))
    resp = client.get("/apis/_?watch=true&resourceVersion=1&timeoutSeconds=0.05")
    assert resp.status == 410
    fresh = client.get("/apis/_?watch=true&resourceVersion=8&timeoutSeconds=0.05").json()
    assert [e["rv"] for e in fresh["events"]] == [9, 10] and fresh["resourceVersion"] == 10


def test_secure_long_poll_filters_per_event():
    """On the secure facade the multiplexed long-poll delivers only the
    objects the identity may watch, as the stream does."""
    api = FakeApiServer()
    seed_cluster_roles(api)
    tokens = TokenRegistry()
    admin, viewer = tokens.issue("system:admin"), tokens.issue("vera")
    api.create(make_cluster_role_binding("admin", CLUSTER_ADMIN_ROLE, "system:admin"))
    api.create(new_resource("RoleBinding", "view", "team", spec={
        "roleRef": {"kind": "ClusterRole", "name": VIEW_ROLE},
        "subjects": [{"kind": "User", "name": "vera"}]}))
    api.create(new_resource("Notebook", "mine", "team", spec={"image": "x"}))
    api.create(new_resource("Notebook", "theirs", "other", spec={"image": "x"}))
    app = ApiServerApp(api, tokens=tokens)
    query = "/apis/_?watch=true&resourceVersion=0&timeoutSeconds=0.05"
    names = lambda resp: {e["object"]["metadata"]["name"]  # noqa: E731
                          for e in resp.json()["events"]}
    as_admin = TestClient(app, headers={"authorization": f"Bearer {admin}"}).get(query)
    as_viewer = TestClient(app, headers={"authorization": f"Bearer {viewer}"}).get(query)
    assert {"mine", "theirs"} <= names(as_admin)
    assert "mine" in names(as_viewer) and "theirs" not in names(as_viewer)


class RejectingApp(ApiServerApp):
    """A facade that, while `reject` is set, refuses the stream form the
    way a server without it does (a 400 naming the parameter), or with a
    stray 400 when `stray` is set."""

    def __init__(self, api):
        super().__init__(api)
        self.reject = True
        self.stray = 0
        self.stream_requests = 0

    def _watch(self, req):
        if req.query.get("stream") in ("true", "1"):
            self.stream_requests += 1
            if self.stray:
                self.stray -= 1
                raise HttpError(400, "bad request from an intermediary")
            if self.reject:
                raise HttpError(400, "unknown query parameter: stream")
        return super()._watch(req)


@pytest.fixture
def rejecting():
    api = FakeApiServer()
    app = RejectingApp(api)
    app.STREAM_DURATION = 1.0
    app.STREAM_SLICE = 0.1
    server, _ = serve(app, host="127.0.0.1", port=0)
    yield api, app, f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    server.server_close()


def test_rejected_stream_is_long_polled_and_reprobed(rejecting):
    api, app, url = rejecting
    client = HttpApiClient(url, watch_poll_timeout=0.2, watch_retry=0.05,
                           stream_reprobe_seconds=0.5)
    seen = []
    try:
        client.watch(lambda ev, o: seen.append(o.metadata.name), "Widget")
        api.create(new_resource("Widget", "a", "default"))
        assert wait_for(lambda: "a" in seen)
        assert wait_for(lambda: client.watch_stats()["longpoll_rounds_degraded"] >= 1)
        assert client.stream_degraded and client.watch_stats()["stream_opens"] == 0
        probes = app.stream_requests
        assert wait_for(lambda: app.stream_requests >= probes + 2, timeout=5.0)  # re-probed
        app.reject = False
        assert wait_for(lambda: client.watch_stats()["stream_opens"] >= 1, timeout=5.0)
        api.create(new_resource("Widget", "b", "default"))
        assert wait_for(lambda: "b" in seen)
        stats = client.watch_stats()
        assert stats["streams_after_degraded"] >= 1 and stats["degraded_seconds"] > 0
        assert not client.stream_degraded
    finally:
        client.close()


def test_a_stray_400_does_not_degrade_for_good(rejecting):
    api, app, url = rejecting
    app.reject = False
    app.stray = 1
    client = HttpApiClient(url, watch_poll_timeout=0.2, watch_retry=0.05,
                           stream_reprobe_seconds=3600.0)
    seen = []
    try:
        client.watch(lambda ev, o: seen.append(o.metadata.name), "Widget")
        assert wait_for(lambda: client.watch_stats()["stream_opens"] >= 1, timeout=5.0)
        stats = client.watch_stats()
        assert stats["stream_failures"] == 1 and stats["longpoll_rounds"] >= 1
        assert not client.stream_degraded  # one failure under the threshold of 3
        api.create(new_resource("Widget", "c", "default"))
        assert wait_for(lambda: "c" in seen)
    finally:
        client.close()


def test_stream_faults_degrade_then_stream_again_without_loss():
    api = FakeApiServer()
    app = ApiServerApp(api)
    app.STREAM_DURATION = 1.0
    app.STREAM_SLICE = 0.1
    server, _ = serve(app, host="127.0.0.1", port=0)
    schedule = FaultSchedule.from_plan([Fault("truncate_stream", 60.0, 0),
                                        Fault("error_5xx", 1.0, 0),
                                        Fault("truncate_stream", 60.0, 0)])
    proxy = ChaosProxy("127.0.0.1", server.server_port, schedule).start()
    client = HttpApiClient(proxy.base_url, watch_poll_timeout=0.2, watch_retry=0.05,
                           stream_failure_threshold=2, stream_degraded_seconds=0.5)
    seen = []
    writer_done = threading.Event()

    def writer():
        for i in range(30):
            api.create(new_resource("Widget", f"w{i}", "default"))
            time.sleep(0.05)
        writer_done.set()

    try:
        client.watch(lambda ev, o: seen.append(o.metadata.name), "Widget")
        threading.Thread(target=writer, daemon=True).start()
        assert wait_for(lambda: schedule.exhausted, timeout=30.0), schedule
        assert writer_done.wait(10.0)
        assert wait_for(lambda: all(f"w{i}" in seen for i in range(30)), timeout=20.0)
        assert wait_for(lambda: client.watch_stats()["streams_after_degraded"] >= 1,
                        timeout=10.0), client.watch_stats()
        stats = client.watch_stats()
        assert stats["stream_failures"] >= 2 and stats["degraded_episodes"] >= 1
        assert stats["longpoll_rounds_degraded"] >= 1 and stats["degraded_seconds"] > 0
        fired = {cls: n for cls, n in schedule.coverage().items() if n}
        assert fired == {"truncate_stream": 2, "error_5xx": 1}
    finally:
        client.close()
        proxy.stop()
        server.shutdown()
        server.server_close()


def test_long_poll_and_stream_deliver_the_same_events(rejecting):
    """Two informers on one store, one long-polling (its facade rejects
    the stream), one streaming: the same events in the same order."""
    api, app, url = rejecting
    app.STREAM_DURATION = 60.0
    stream_server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    polling = HttpApiClient(url, watch_poll_timeout=0.2, stream_reprobe_seconds=3600.0)
    streaming = HttpApiClient(f"http://127.0.0.1:{stream_server.server_port}")
    got: dict[str, list] = {"poll": [], "stream": []}
    try:
        for name, client in (("poll", polling), ("stream", streaming)):
            client.watch(lambda ev, o, name=name: got[name].append(
                (ev, o.metadata.name, o.metadata.resource_version, json.dumps(o.spec))),
                "Widget")
        # Both informers past their first list: a marker both deliver.
        api.create(new_resource("Widget", "ready", "default"))
        assert wait_for(lambda: all(any(e[1] == "ready" for e in got[n]) for n in got))
        time.sleep(0.3)
        for events in got.values():
            events.clear()
        for op, kind, name, spec in _writes(3):
            _apply(api, new_resource, op, "Widget", name, spec)
            time.sleep(0.01)
        n_events = sum(1 for _ in _writes(3))
        assert wait_for(lambda: len(got["poll"]) >= n_events and len(got["stream"]) >= n_events,
                        timeout=30.0), (len(got["poll"]), len(got["stream"]))
        time.sleep(0.5)
        assert got["poll"] == got["stream"]
        assert polling.watch_stats()["stream_opens"] == 0
        assert streaming.watch_stats()["longpoll_rounds"] == 0
    finally:
        polling.close()
        streaming.close()
        stream_server.shutdown()
        stream_server.server_close()
