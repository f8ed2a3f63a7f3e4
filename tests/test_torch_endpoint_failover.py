"""The port's endpoint-list client (`testing/apiserver_http.py`) against
the JAX package's failover rules.

First JAX's own tests (tests/test_endpoint_failover.py, all 8) run on
the port: the module's source with its imports pointed at the port,
one rule a test: the env
contract, a single endpoint behaving as before (no rotation, a refused
dial and an open circuit surfacing as errors), a refused dial rotating
reads and writes, sticky rotation, an open circuit shedding to the next
endpoint, and a watch that dies with its endpoint resuming on the
standby through 410 and a relist, duplicate-free. Then the port's
CircuitBreaker answers a scripted sequence as JAX's does on one clock,
and the rules hold over https with one pinned CA for both endpoints.
"""

import re
import socket
import threading
import time
from pathlib import Path

import pytest

from kubeflow_tpu.testing import apiserver_http as j_http
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.testing import apiserver_http as t_http
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import tls
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.`: the namespace."""
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", path.read_text())
    namespace: dict = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return namespace


PORT = _jax_tests_on_the_port(REPO / "tests" / "test_endpoint_failover.py")
PORT_TESTS = {k: v for k, v in PORT.items() if k.startswith("test_") and callable(v)}




def test_all_of_jax_endpoint_failover_tests_are_ported():
    assert len(PORT_TESTS) == 8


@pytest.mark.parametrize("name", sorted(PORT_TESTS))
def test_jax_endpoint_failover_tests_on_the_port(name, tmp_path):
    fn = PORT_TESTS[name]
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    if params == ("live",):
        api = FakeApiServer()
        server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
        try:
            fn((api, f"http://127.0.0.1:{server.server_port}"))
        finally:
            server.shutdown()
            server.server_close()
            api.close()
    else:
        fn(tmp_path) if params else fn()


# -- the breaker on one clock ---------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


def test_circuit_breaker_answers_as_jax_does(monkeypatch):
    """One scripted sequence of allow/failure/success and clock moves
    through both packages' CircuitBreaker: the same answers, trips and
    open states at every step (threshold 3, cooldown 2 s)."""
    clock = _Clock()
    monkeypatch.setattr(j_http.time, "monotonic", clock.monotonic)
    monkeypatch.setattr(t_http.time, "monotonic", clock.monotonic)
    script = ["allow", "failure", "failure", "allow", "failure", "allow", ("tick", 1.0),
              "allow", ("tick", 1.5), "allow", "allow", "failure", "allow", ("tick", 2.5),
              "allow", "success", "allow", "failure", "allow"]

    def run(breaker):
        out = []
        for step in script:
            if isinstance(step, tuple):
                clock.t += step[1]
                continue
            got = getattr(breaker, step)()
            out.append((step, got, breaker.failures, breaker.trips, breaker.open))
        return out

    start = clock.t
    want = run(j_http.CircuitBreaker(threshold=3, cooldown=2.0))
    clock.t = start
    got = run(t_http.CircuitBreaker(threshold=3, cooldown=2.0))
    assert got == want
    assert ("allow", False, 3, 1, True) in got  # open: shed
    assert got[-1][:2] == ("allow", True)


# -- over https ---------------------------------------------------------------


def test_https_pair_rotates_with_one_pinned_ca(tmp_path):
    """An https endpoint list with one CA: a refused first endpoint
    rotates a write to the second, stickily; each endpoint has its own
    handshake count and a dead endpoint is not dialed again."""
    paths = tls.ensure_tls_dir(str(tmp_path / "tls"))
    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0, tls=paths)
    dead = f"https://127.0.0.1:{free_port()}"
    live = f"https://127.0.0.1:{server.server_port}"
    client = HttpApiClient([dead, live], ca=paths.ca_cert, retry_base=0.02)
    try:
        client.create(new_resource("FailObj", "w", spec={}))
        for _ in range(5):
            client.list("FailObj")
        assert api.get("FailObj", "w") is not None
        assert client.failovers == 1 and client.base_url == live
        assert client._endpoints[0].handshakes == 1  # one refused dial
        assert client._endpoints[1].handshakes == 1 == server.tls_handshakes
        assert client.handshakes == 2
    finally:
        client.close()
        server.shutdown()
        server.server_close()


def test_https_watch_resumes_on_the_standby(tmp_path):
    """The watch over https follows a takeover: the active's listener and
    its held streams go away, a standby restored over the same store
    serves the other endpoint, and the watcher relists (410) there."""
    paths = tls.ensure_tls_dir(str(tmp_path / "tls"))
    store = str(tmp_path / "store")
    api_a = FakeApiServer(persist_dir=store)
    fwd = PORT["_Forwarder"]
    server_a, _ = serve(ApiServerApp(api_a), host="127.0.0.1", port=0, tls=paths)
    front = fwd(server_a.server_port)
    port_b = free_port()
    client = HttpApiClient([f"https://127.0.0.1:{front.port}", f"https://127.0.0.1:{port_b}"],
                           ca=paths.ca_cert, watch_retry=0.05, retry_base=0.02)
    seen, lock = set(), threading.Lock()

    def handler(event, obj):
        with lock:
            seen.add((event, obj.metadata.name))

    def saw(pair, timeout=30.0):
        """Whether (event, name) arrives in time; event None is any."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with lock:
                if any(n == pair[1] and pair[0] in (None, e) for e, n in seen):
                    return True
            time.sleep(0.02)
        return False

    server_b = None
    try:
        client.watch(handler, "FailObj")
        client.create(new_resource("FailObj", "before", spec={}))
        # ADDED from the stream, or MODIFIED from the first list if the
        # create beat it.
        assert saw((None, "before")), seen
        front.kill()
        api_a.create(new_resource("FailObj", "dark", spec={}))
        api_b = FakeApiServer(persist_dir=store)
        server_b, _ = serve(ApiServerApp(api_b), host="127.0.0.1", port=port_b, tls=paths)
        assert saw(("MODIFIED", "dark")), seen
        client.create(new_resource("FailObj", "after", spec={}))
        assert saw(("ADDED", "after")), seen
        assert client.failovers == 1
    finally:
        client.close()
        front.kill()
        server_a.shutdown()
        if server_b is not None:
            server_b.shutdown()
