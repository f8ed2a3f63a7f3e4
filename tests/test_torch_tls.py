"""Transport security for the port's control plane (`web/tls.py`, the
facade's `serve(..., tls=)`, `HttpApiClient(ca=)`), against the JAX
package's.

First the cases of JAX's tests/test_tls.py, on the port: HTTPS end to
end with the pinned CA, a plaintext request to the TLS port refused, a
client pinning another CA refused, the mint idempotent with a private
key and no CA key kept, a re-mint on a changed host set and near expiry,
and an https endpoint without a CA refused before any byte is sent. The
port has no bearer tokens, so JAX's two token cases become the CA pin's
(``KFTPU_CA``, and a refusal that never dials). Then the handshake both
ways: the port's client against a JAX-served facade with a JAX-made CA,
and JAX's client against the port's; a directory made with the openssl
binary (where `cryptography` is missing) serves both; and the layout of
a minted directory is JAX's.
"""

import socket
import ssl
import stat
import threading
import urllib.error
import urllib.request

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.testing.apiserver_http import ApiServerApp as JApiServerApp
from kubeflow_tpu.testing.apiserver_http import HttpApiClient as JHttpApiClient
from kubeflow_tpu.testing.fake_apiserver import FakeApiServer as JFakeApiServer
from kubeflow_tpu.web import tls as j_tls
from kubeflow_tpu.web.wsgi import serve as j_serve
from kubeflow_tpu_torch.api.objects import new_resource
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web import tls
from kubeflow_tpu_torch.web.wsgi import serve


@pytest.fixture(scope="module")
def port_tls(tmp_path_factory):
    return tls.ensure_tls_dir(str(tmp_path_factory.mktemp("port-tls")))


def _secure_server(paths):
    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0, tls=paths)
    return api, server


def _stop(server) -> None:
    server.shutdown()
    server.server_close()


def test_https_end_to_end_with_pinned_ca(port_tls):
    api, server = _secure_server(port_tls)
    client = HttpApiClient(f"https://127.0.0.1:{server.server_port}", ca=port_tls.ca_cert)
    try:
        created = client.create(new_resource("ConfigMap", "cm", spec={"k": "v"}))
        assert created.metadata.name == "cm"
        assert client.get("ConfigMap", "cm").spec == {"k": "v"}
        for _ in range(5):
            client.get("ConfigMap", "cm")
        # Keep-alive: one handshake for the whole request train.
        assert client.handshakes == 1 and server.tls_handshakes == 1
        assert server.requests_served == 7
    finally:
        client.close()
        _stop(server)


def test_https_without_a_ca_never_dials():
    """JAX's plaintext-token case, for the port (no tokens): an https
    endpoint without a pinned CA is refused at construction, and a
    listener on its port sees no connection at all."""
    sniffer = socket.socket()
    sniffer.bind(("127.0.0.1", 0))
    sniffer.listen(1)
    sniffer.settimeout(1.0)
    port = sniffer.getsockname()[1]
    connected = []

    def accept_one():
        try:
            conn, _ = sniffer.accept()
            connected.append(conn.recv(65536))
            conn.close()
        except OSError:
            pass

    t = threading.Thread(target=accept_one, daemon=True)
    t.start()
    with pytest.raises(ValueError, match="KFTPU_CA"):
        HttpApiClient([f"http://127.0.0.1:{port}", f"https://127.0.0.1:{port}"], ca="")
    t.join(timeout=3)
    sniffer.close()
    assert not connected


def test_ca_pin_from_the_environment(port_tls, monkeypatch):
    """JAX's explicit plaintext opt-in case, for the port: the pin rides
    the launcher's env contract (``KFTPU_CA``), as a path or inline PEM."""
    api, server = _secure_server(port_tls)
    url = f"https://127.0.0.1:{server.server_port}"
    try:
        monkeypatch.setenv("KFTPU_CA", port_tls.ca_cert)
        client = HttpApiClient(url)
        assert client.ca == port_tls.ca_cert
        assert client.list("ConfigMap") == []
        client.close()
        with open(port_tls.ca_cert) as f:
            monkeypatch.setenv("KFTPU_CA", f.read())
        client = HttpApiClient(url)
        assert client.list("ConfigMap") == []
        client.close()
    finally:
        _stop(server)


def test_plaintext_request_to_tls_port_is_refused(port_tls):
    _, server = _secure_server(port_tls)
    try:
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{server.server_port}/healthz", timeout=5)
        assert server.requests_served == 0
    finally:
        _stop(server)


def test_wrong_ca_is_rejected(port_tls, tmp_path):
    other = tls.ensure_tls_dir(str(tmp_path / "other-ca"))
    _, server = _secure_server(port_tls)
    client = HttpApiClient(f"https://127.0.0.1:{server.server_port}", ca=other.ca_cert)
    try:
        with pytest.raises((ssl.SSLError, urllib.error.URLError)):
            client.get("ConfigMap", "nope")
        assert server.requests_served == 0
    finally:
        client.close()
        _stop(server)


def test_mint_is_idempotent_and_keys_are_private(tmp_path):
    d = str(tmp_path / "tls")
    first = tls.ensure_tls_dir(d)
    again = tls.ensure_tls_dir(d)
    assert first == again
    with open(first.ca_cert) as f:
        pem1 = f.read()
    with open(again.ca_cert) as f:
        assert f.read() == pem1
    assert stat.S_IMODE((tmp_path / "tls" / "server.key").stat().st_mode) == 0o600
    assert not any("ca.key" in p.name for p in (tmp_path / "tls").iterdir())


def test_host_change_reminted(tmp_path):
    d = str(tmp_path / "tls")
    first = tls.ensure_tls_dir(d)
    with open(first.ca_cert) as f:
        pem1 = f.read()
    tls.ensure_tls_dir(d, hosts=("127.0.0.1", "localhost"))  # reordered: kept
    with open(first.ca_cert) as f:
        assert f.read() == pem1
    tls.ensure_tls_dir(d, hosts=("localhost", "127.0.0.1", "10.0.0.7"))
    with open(first.ca_cert) as f:
        assert f.read() != pem1
    assert tls.read_hosts_marker(d) == ("localhost", "127.0.0.1", "10.0.0.7")


def test_expired_cert_is_reminted(tmp_path, monkeypatch):
    d = str(tmp_path / "tls")
    first = tls.ensure_tls_dir(d)
    with open(first.ca_cert) as f:
        pem1 = f.read()
    assert not tls._expiring_soon(first.server_cert)
    assert tls._expiring_soon(first.server_cert, margin_days=tls.VALID_DAYS + 1)
    monkeypatch.setattr(tls, "_expiring_soon", lambda *a, **k: True)
    tls.ensure_tls_dir(d)
    with open(first.ca_cert) as f:
        assert f.read() != pem1


def test_https_without_ca_fails_actionably(monkeypatch):
    monkeypatch.delenv("KFTPU_CA", raising=False)
    with pytest.raises(ValueError, match="KFTPU_CA"):
        HttpApiClient("https://127.0.0.1:1")


# -- the port against the JAX package -----------------------------------------


def test_port_client_handshakes_with_a_jax_facade_and_ca(tmp_path):
    paths = j_tls.ensure_tls_dir(str(tmp_path / "jax-tls"))
    japi = JFakeApiServer()
    server, _ = j_serve(JApiServerApp(japi), host="127.0.0.1", port=0, tls=paths)
    client = HttpApiClient(f"https://127.0.0.1:{server.server_port}", ca=paths.ca_cert)
    try:
        client.create(new_resource("ConfigMap", "from-port", spec={"k": 1}))
        assert japi.get("ConfigMap", "from-port").spec == {"k": 1}
        assert server.tls_handshakes == client.handshakes == 1
    finally:
        client.close()
        server.shutdown()


def test_jax_client_handshakes_with_the_port_facade(tmp_path):
    paths = tls.ensure_tls_dir(str(tmp_path / "port-tls"))
    api, server = _secure_server(paths)
    client = JHttpApiClient(f"https://127.0.0.1:{server.server_port}", ca=paths.ca_cert)
    try:
        client.create(j_new_resource("ConfigMap", "from-jax", spec={"k": 2}))
        assert api.get("ConfigMap", "from-jax").spec == {"k": 2}
        assert server.tls_handshakes == client.handshakes == 1
    finally:
        client.close()
        _stop(server)


def test_openssl_minted_directory_serves_both_packages(tmp_path, monkeypatch):
    """Without `cryptography` the port mints with the openssl binary:
    the same files, a P-256 leaf with the host SANs under a pathlen-0
    CA, idempotent; JAX's facade serves it and JAX's client pins it."""
    monkeypatch.setattr(tls, "_has_cryptography", lambda: False)
    assert tls.mint_tool() == "openssl"
    d = str(tmp_path / "openssl-tls")
    paths = tls.ensure_tls_dir(d)
    assert tls.ensure_tls_dir(d) == paths
    assert sorted(p.name for p in (tmp_path / "openssl-tls").iterdir()) == [
        "ca.crt", "hosts", "server.crt", "server.key"]
    assert stat.S_IMODE((tmp_path / "openssl-tls" / "server.key").stat().st_mode) == 0o600
    assert not tls._expiring_soon(paths.server_cert)
    assert tls._expiring_soon(paths.server_cert, margin_days=tls.VALID_DAYS + 1)
    from cryptography import x509

    with open(paths.server_cert, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    sans = cert.extensions.get_extension_for_class(x509.SubjectAlternativeName).value
    assert sorted(map(str, sans.get_values_for_type(x509.DNSName))) == ["localhost"]
    assert [str(ip) for ip in sans.get_values_for_type(x509.IPAddress)] == ["127.0.0.1"]
    with open(paths.ca_cert, "rb") as f:
        ca = x509.load_pem_x509_certificate(f.read())
    basic = ca.extensions.get_extension_for_class(x509.BasicConstraints)
    assert basic.critical and basic.value.ca and basic.value.path_length == 0

    japi = JFakeApiServer()
    server, _ = j_serve(JApiServerApp(japi), host="127.0.0.1", port=0,
                        tls=j_tls.TlsPaths(paths.ca_cert, paths.server_cert, paths.server_key))
    try:
        for client in (HttpApiClient(f"https://127.0.0.1:{server.server_port}",
                                     ca=paths.ca_cert),
                       JHttpApiClient(f"https://localhost:{server.server_port}",
                                      ca=paths.ca_cert)):
            assert client.list("ConfigMap") == []
            client.close()
    finally:
        server.shutdown()


def test_no_mint_tool_fails_loudly(tmp_path, monkeypatch):
    monkeypatch.setattr(tls, "_has_cryptography", lambda: False)
    monkeypatch.setattr(tls.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="neither the cryptography package nor the openssl"):
        tls.ensure_tls_dir(str(tmp_path / "none"))
    assert not (tmp_path / "none").exists()


def test_minted_directory_has_jax_layout_and_restarts_in_jax(tmp_path):
    """A directory the port minted is one JAX's `ensure_tls_dir` reuses
    as is (same files, same hosts marker): a facade restarting under the
    other package keeps the CA its clients pinned."""
    d = str(tmp_path / "tls")
    paths = tls.ensure_tls_dir(d)
    with open(paths.ca_cert) as f:
        pem = f.read()
    jpaths = j_tls.ensure_tls_dir(d)
    assert (jpaths.ca_cert, jpaths.server_cert, jpaths.server_key) == (
        paths.ca_cert, paths.server_cert, paths.server_key)
    with open(paths.ca_cert) as f:
        assert f.read() == pem
    assert tls.read_hosts_marker(d) == j_tls.read_hosts_marker(d) == ("localhost", "127.0.0.1")
    assert tls.is_pem_data(pem) and not tls.is_pem_data(paths.ca_cert)
