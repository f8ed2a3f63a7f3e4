"""The port's apiserver facade and client (`testing/apiserver_http.py`)
and the web core pieces under them (`web/wsgi.py`).

`ApiServerApp` serves the port's `FakeApiServer` on a localhost port and
`HttpApiClient` talks to it: CRUD with label selectors and namespaces,
store errors mapped onto statuses by the facade and back onto the same
error classes by the client (NotFound 404, AlreadyExists and Conflict
409, Invalid 422, Unavailable 503, Gone 410), a create retried after an
ambiguous failure claiming its own object, the streaming watch
delivering events, resuming from its bookmark after a dropped stream and
re-listing when the journal's horizon has passed it, and endpoints the
port does not serve (https, more than one) refused. The store's frozen
snapshots, owner cascade and journal are checked here too.
"""

import http.client
import json
import socket
import threading
import time

import pytest

from kubeflow_tpu_torch.api.objects import FrozenResourceError, new_resource, owner_ref
from kubeflow_tpu_torch.testing.apiserver_http import (
    ApiServerApp,
    HttpApiClient,
    endpoints_from_env,
)
from kubeflow_tpu_torch.testing.fake_apiserver import (
    AlreadyExists,
    ApiError,
    Conflict,
    FakeApiServer,
    Gone,
    Invalid,
    NotFound,
    Unavailable,
)
from kubeflow_tpu_torch.web import App, TestClient, json_response
from kubeflow_tpu_torch.web.wsgi import serve


@pytest.fixture()
def facade():
    api = FakeApiServer()
    server, thread = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{server.server_port}"
    clients = []

    def client(url=url):
        c = HttpApiClient(url)
        clients.append(c)
        return c

    try:
        yield api, url, client
    finally:
        for c in clients:
            c.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def _wait(predicate, timeout=10.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# -- CRUD and the error mapping ------------------------------------------------


def test_crud_over_http(facade):
    api, _, client = facade
    c = client()
    made = c.create(new_resource("Thing", "a", "team", spec={"n": 1}, labels={"app": "x"}))
    assert made.metadata.uid and made.metadata.resource_version > 0
    c.create(new_resource("Thing", "b", "team", spec={"n": 2}))
    c.create(new_resource("Thing", "c", "other", spec={"n": 3}, labels={"app": "x"}))
    assert c.get("Thing", "a", "team").spec == {"n": 1}
    assert [t.metadata.name for t in c.list("Thing")] == ["c", "a", "b"]
    assert [t.metadata.name for t in c.list("Thing", "team")] == ["a", "b"]
    assert [t.metadata.name for t in c.list("Thing", label_selector={"app": "x"})] == ["c", "a"]

    fresh = c.get("Thing", "a", "team")
    fresh.spec = {"n": 10}
    updated = c.update(fresh)
    assert updated.spec == {"n": 10} and updated.metadata.generation == 2
    fresh.status = {"phase": "Done"}
    with pytest.raises(Conflict):  # fresh's resourceVersion is stale now
        c.update_status(fresh)
    current = c.get("Thing", "a", "team")
    current.status = {"phase": "Done"}
    assert c.update_status(current).status == {"phase": "Done"}
    assert api.get("Thing", "a", "team").spec == {"n": 10}

    c.delete("Thing", "a", "team")
    with pytest.raises(NotFound):
        c.get("Thing", "a", "team")
    with pytest.raises(NotFound):
        c.delete("Thing", "a", "team")
    with pytest.raises(AlreadyExists):
        c.create(new_resource("Thing", "b", "team"))


def test_statuses_on_the_wire(facade):
    api, url, _ = facade
    api.create(new_resource("Thing", "a"))
    host, port = url[len("http://"):].split(":")

    def call(method, path, body=None):
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        conn.request(method, path, body=json.dumps(body) if body else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        status = resp.status
        resp.read()
        conn.close()
        return status

    thing = api.get("Thing", "a").to_dict()
    assert call("GET", "/apis/Thing/default/a") == 200
    assert call("GET", "/apis/Thing/default/zz") == 404
    assert call("POST", "/apis/Thing", thing) == 409
    stale = {**thing, "metadata": {**thing["metadata"], "resourceVersion": 99}}
    assert call("PUT", "/apis/Thing/default/a", stale) == 409
    assert call("PUT", "/apis/Thing/default/b", thing) == 400  # path is authoritative
    assert call("POST", "/apis/Other", thing) == 400
    assert call("DELETE", "/apis/Thing/default/a") == 200
    assert call("DELETE", "/apis/Thing/default/a") == 404
    assert call("GET", "/apis/Thing?watch=true") == 400  # only the stream is served


def test_web_core_maps_store_errors_and_methods():
    app = App("t")
    errors = {
        "nf": NotFound("gone"), "ae": AlreadyExists("a already exists"),
        "cf": Conflict("stale"), "iv": Invalid("bad"), "un": Unavailable("down"),
    }

    def boom(req):
        raise errors[req.path_params["what"]]

    app.add_route("/err/<what>", boom)
    for method in ("PUT", "PATCH", "DELETE"):
        app.add_route("/m", lambda req, m=method: json_response({"m": req.method}), (method,))
    client = TestClient(app)
    statuses = {k: client.get(f"/err/{k}").status for k in errors}
    assert statuses == {"nf": 404, "ae": 409, "cf": 409, "iv": 422, "un": 503}
    assert client.put("/m", {}).json() == {"m": "PUT"}
    assert client.patch("/m", {}).json() == {"m": "PATCH"}
    assert client.delete("/m").json() == {"m": "DELETE"}
    assert client.get("/m").status == 405

    server, thread = serve(app, host="127.0.0.1", port=0)
    try:
        for method in ("PUT", "PATCH", "DELETE"):
            conn = http.client.HTTPConnection("127.0.0.1", server.server_port, timeout=10)
            conn.request(method, "/m", body=b"{}")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read()) == {"m": method}
            conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


@pytest.mark.parametrize("status,detail,error", [
    (404, "x not found", NotFound),
    (409, "('T', 'default', 'x') already exists", AlreadyExists),
    (409, "stale resourceVersion", Conflict),
    (410, "too old", Gone),
    (422, "bad", Invalid),
    (503, "down", Unavailable),
    (500, "boom", ApiError),
])
def test_client_maps_statuses_back(status, detail, error):
    with pytest.raises(error) as info:
        HttpApiClient._raise_for_status(status, detail)
    if error is ApiError:
        assert type(info.value) is ApiError


def test_create_after_an_ambiguous_failure_claims_its_own_object(facade, monkeypatch):
    """The first attempt commits but its connection dies before the
    answer: the retry meets AlreadyExists and claims the stored object,
    which holds what it sent; a stranger's object stays an error."""
    api, _, client = facade
    monkeypatch.setattr(HttpApiClient, "RETRY_BASE", 0.001)
    c = client()
    real_call = c._call
    dropped = []

    def flaky(method, path, body=None):
        out = real_call(method, path, body)
        if method == "POST" and not dropped:
            dropped.append(path)
            raise ConnectionResetError("answer lost")
        return out

    c._call = flaky
    got = c.create(new_resource("Thing", "mine", spec={"n": 1}))
    assert got.spec == {"n": 1} and dropped and c.retries_total == 1
    api.create(new_resource("Thing", "theirs", spec={"n": 2}))
    dropped.clear()
    with pytest.raises(AlreadyExists):
        c.create(new_resource("Thing", "theirs", spec={"n": 3}))


def test_record_event_over_http_collapses_repeats(facade):
    api, _, client = facade
    c = client()
    about = c.create(new_resource("Thing", "a"))
    first = c.record_event(about, "Rolled", "a -> 2")
    again = c.record_event(about, "Rolled", "a -> 2")
    assert first.metadata.name == again.metadata.name
    assert len(api.list("Event")) == 1


def test_endpoints_the_port_does_not_serve_are_refused():
    assert endpoints_from_env(" http://a:1 ,http://b:2,") == ["http://a:1", "http://b:2"]
    with pytest.raises(ValueError, match="no apiserver endpoints"):
        endpoints_from_env(" , ")
    with pytest.raises(ValueError, match="TLS is not ported"):
        HttpApiClient("https://127.0.0.1:6443")
    with pytest.raises(ValueError, match="failover is not ported"):
        HttpApiClient(["http://a:1", "http://b:2"])
    assert HttpApiClient(["http://a:1/"]).base_url == "http://a:1"


# -- the watch stream ---------------------------------------------------------


class Proxy:
    """A TCP relay in front of the facade whose connections the test can
    sever (a dropped stream) and whose new connections it can refuse
    for a while (an apiserver that is away)."""

    def __init__(self, port):
        self.target = port
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.port = self.listener.getsockname()[1]
        self.accepting = threading.Event()
        self.accepting.set()
        self.connections = 0
        self._live: list[socket.socket] = []
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            if not self.accepting.is_set():
                conn.close()
                continue
            upstream = socket.create_connection(("127.0.0.1", self.target))
            with self._lock:
                self.connections += 1
                self._live += [conn, upstream]
            for a, b in ((conn, upstream), (upstream, conn)):
                threading.Thread(target=self._pipe, args=(a, b), daemon=True).start()

    @staticmethod
    def _pipe(src, dst):
        try:
            while data := src.recv(65536):
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def sever(self):
        with self._lock:
            live, self._live = self._live, []
        for s in live:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()

    def close(self):
        self.listener.close()
        self.sever()


def test_watch_stream_delivers_resumes_and_relists(monkeypatch):
    """list-then-watch delivers what exists as MODIFIED and then each
    new event as it happens; a dropped stream reconnects and resumes
    from its bookmark (an event written while it was down arrives as
    ADDED, from the journal); when the journal has moved past the
    bookmark (410), the client lists again and delivers MODIFIED."""
    api = FakeApiServer(journal_size=4)
    server, thread = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    proxy = Proxy(server.server_port)
    monkeypatch.setattr(HttpApiClient, "WATCH_RETRY", 0.05)
    c = HttpApiClient(f"http://127.0.0.1:{proxy.port}")
    seen, lock = [], threading.Lock()

    def handler(event, obj):
        with lock:
            seen.append((event, obj.metadata.name))

    def saw(pair):
        with lock:
            return pair in seen

    try:
        api.create(new_resource("Thing", "old"))
        c.watch(handler, "Thing")
        _wait(lambda: saw(("MODIFIED", "old")), what="the initial list")
        api.create(new_resource("Thing", "live"))
        _wait(lambda: saw(("ADDED", "live")), what="a streamed event")
        streams = proxy.connections

        proxy.accepting.clear()
        proxy.sever()
        api.create(new_resource("Thing", "while-down"))
        time.sleep(0.2)  # the client retries into refused connections
        assert not saw(("ADDED", "while-down"))
        proxy.accepting.set()
        _wait(lambda: saw(("ADDED", "while-down")), what="the resumed stream")
        assert proxy.connections > streams

        proxy.accepting.clear()
        proxy.sever()
        for i in range(8):  # past the journal's 4 entries
            api.create(new_resource("Thing", f"burst-{i}"))
        with pytest.raises(Gone):
            api.events_since(api.current_rv - 8)
        proxy.accepting.set()
        _wait(lambda: saw(("MODIFIED", "burst-0")), what="the relist after 410")
        assert not saw(("ADDED", "burst-0"))
        _wait(lambda: saw(("MODIFIED", "burst-7")), what="the relist after 410")
        api.delete("Thing", "old")
        _wait(lambda: saw(("DELETED", "old")), what="a delete after the relist")
    finally:
        c.close()
        proxy.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


# -- the store ----------------------------------------------------------------


def test_store_snapshots_cascade_and_journal():
    api = FakeApiServer()
    events = []
    api.watch(lambda e, o: events.append((e, o.kind, o.metadata.name)))
    parent = api.create(new_resource("Parent", "p", spec={"a": [1]}))
    with pytest.raises(FrozenResourceError):
        parent.spec["a"].append(2)
    with pytest.raises(FrozenResourceError):
        parent.metadata.labels["x"] = "y"
    mine = parent.thaw()
    mine.spec["a"].append(2)
    assert api.get("Parent", "p").spec == {"a": [1]}
    child = new_resource("Child", "c")
    child.metadata.owner_references = [owner_ref(parent)]
    api.create(child)
    same = api.apply(new_resource("Parent", "p", spec={"a": [1]}))
    assert same.metadata.resource_version == parent.metadata.resource_version
    api.delete("Parent", "p")
    api.flush()
    assert api.list("Child") == []
    assert events == [
        ("ADDED", "Parent", "p"), ("ADDED", "Child", "c"),
        ("DELETED", "Parent", "p"), ("DELETED", "Child", "c"),
    ]
    got, rv = api.events_since(2)
    assert [(e, o.metadata.name) for _, e, o in got] == [("DELETED", "p"), ("DELETED", "c")]
    assert rv == api.current_rv == 4
    assert api.wait_events(rv, timeout=0.05) == ([], rv)
