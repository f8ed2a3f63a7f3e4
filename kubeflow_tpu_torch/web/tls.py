"""Control-plane TLS: a platform CA and a server certificate.

Counterpart of `kubeflow_tpu/web/tls.py` (a module with no JAX in it),
with the same directory layout, so a directory minted by either
package serves and pins in the other:

    <dir>/ca.crt       the platform CA (clients pin it; its key is never kept)
    <dir>/server.crt   the server certificate, SANs = the hosts
    <dir>/server.key   its EC P-256 key, PKCS#8 PEM, mode 0600
    <dir>/hosts        the comma-separated host set it was minted for

- `ensure_tls_dir(dir)` mints (idempotently) a CA plus a server cert
  with localhost/127.0.0.1 SANs and returns the paths; a restart over
  the same directory and host set keeps the CA, so pinned clients
  reconnect without re-trusting anything. A changed host set, or a cert
  within 30 days of expiry, re-mints the whole directory.
- `server_context`/`client_context` build both ends' ssl contexts; the
  client verifies against the pinned CA only, never the system trust
  store.

The certs are made with the `cryptography` package, as in the JAX
package; where it cannot be imported, with the ``openssl`` binary (the
same files, the same extensions). `mint_tool()` names the one in use
and raises when neither exists. Certs are valid for 730 days; the CA
is an issuing root only (CA:TRUE, pathlen 0), the server cert a leaf.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import shutil
import ssl
import subprocess
import tempfile
import threading

_mint_lock = threading.Lock()
VALID_DAYS = 730
RENEW_MARGIN_DAYS = 30.0


@dataclasses.dataclass(frozen=True)
class TlsPaths:
    ca_cert: str
    server_cert: str
    server_key: str


def _has_cryptography() -> bool:
    try:
        import cryptography  # noqa: F401
    except ImportError:
        return False
    return True


def mint_tool() -> str:
    """``cryptography`` when the package imports, else ``openssl`` when
    the binary is on PATH; raises when neither can make certs."""
    if _has_cryptography():
        return "cryptography"
    if shutil.which("openssl"):
        return "openssl"
    raise RuntimeError("cannot mint TLS certs: neither the cryptography package nor the "
                       "openssl binary is available")


def _write_private(path: str, data: bytes) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(data)


def _expiring_soon(cert_path: str, margin_days: float = RENEW_MARGIN_DAYS) -> bool:
    """True when the cert is unreadable, expired, or within the renewal
    margin: a state directory older than the cert's lifetime re-mints at
    boot instead of serving an expired cert."""
    if mint_tool() == "openssl":
        out = subprocess.run(
            ["openssl", "x509", "-noout", "-in", cert_path, "-checkend",
             str(int(margin_days * 86400))], capture_output=True)
        return out.returncode != 0
    from cryptography import x509

    try:
        with open(cert_path, "rb") as f:
            cert = x509.load_pem_x509_certificate(f.read())
    except (OSError, ValueError):
        return True
    now = datetime.datetime.now(datetime.timezone.utc)
    return cert.not_valid_after_utc <= now + datetime.timedelta(days=margin_days)


def read_hosts_marker(directory: str) -> tuple[str, ...]:
    """The host set the directory's cert was minted for, or () when it
    has none yet."""
    try:
        with open(os.path.join(directory, "hosts")) as f:
            line = f.read().strip()
    except (FileNotFoundError, NotADirectoryError):
        return ()
    return tuple(h for h in line.split(",") if h)


def _mint_with_cryptography(paths: TlsPaths, hosts: tuple[str, ...]) -> None:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)
    not_after = now + datetime.timedelta(days=VALID_DAYS)

    def name(cn: str) -> x509.Name:
        return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(name("kubeflow-tpu-ca"))
        .issuer_name(name("kubeflow-tpu-ca"))
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .sign(ca_key, hashes.SHA256())
    )
    server_key = ec.generate_private_key(ec.SECP256R1())
    sans: list[x509.GeneralName] = []
    for host in hosts:
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(host)))
        except ValueError:
            sans.append(x509.DNSName(host))
    server_cert = (
        x509.CertificateBuilder()
        .subject_name(name("kubeflow-tpu-apiserver"))
        .issuer_name(ca_cert.subject)
        .public_key(server_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(not_after)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    pem = serialization.Encoding.PEM
    with open(paths.ca_cert, "wb") as f:
        f.write(ca_cert.public_bytes(pem))
    with open(paths.server_cert, "wb") as f:
        f.write(server_cert.public_bytes(pem))
    _write_private(paths.server_key, server_key.private_bytes(
        pem, serialization.PrivateFormat.PKCS8, serialization.NoEncryption()))


def _mint_with_openssl(paths: TlsPaths, hosts: tuple[str, ...]) -> None:
    def run(*argv: str) -> None:
        out = subprocess.run(["openssl", *argv], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"openssl {argv[0]} failed: {out.stderr.strip()}")

    sans = []
    for host in hosts:
        try:
            ipaddress.ip_address(host)
            sans.append(f"IP:{host}")
        except ValueError:
            sans.append(f"DNS:{host}")
    # The CA key lives only in this scratch directory, removed on return.
    with tempfile.TemporaryDirectory() as scratch:
        ca_key = os.path.join(scratch, "ca.key")
        csr = os.path.join(scratch, "server.csr")
        ext = os.path.join(scratch, "server.ext")
        key_tmp = os.path.join(scratch, "server.key")
        ec = ("-algorithm", "EC", "-pkeyopt", "ec_paramgen_curve:P-256")
        run("genpkey", *ec, "-out", ca_key)
        run("req", "-x509", "-new", "-key", ca_key, "-sha256", "-days", str(VALID_DAYS),
            "-subj", "/CN=kubeflow-tpu-ca",
            "-addext", "basicConstraints=critical,CA:TRUE,pathlen:0",
            "-out", paths.ca_cert)
        run("genpkey", *ec, "-out", key_tmp)
        run("req", "-new", "-key", key_tmp, "-subj", "/CN=kubeflow-tpu-apiserver",
            "-out", csr)
        with open(ext, "w") as f:
            f.write("basicConstraints=critical,CA:FALSE\n"
                    f"subjectAltName={','.join(sans)}\n")
        run("x509", "-req", "-in", csr, "-CA", paths.ca_cert, "-CAkey", ca_key,
            "-set_serial", str(int.from_bytes(os.urandom(16), "big") >> 1),
            "-days", str(VALID_DAYS), "-sha256", "-extfile", ext, "-out", paths.server_cert)
        with open(key_tmp, "rb") as f:
            _write_private(paths.server_key, f.read())


def ensure_tls_dir(
    directory: str, hosts: tuple[str, ...] = ("localhost", "127.0.0.1")
) -> TlsPaths:
    """Mint (or reuse) a CA and server cert pair under `directory`."""
    tool = mint_tool()
    os.makedirs(directory, mode=0o700, exist_ok=True)
    paths = TlsPaths(
        ca_cert=os.path.join(directory, "ca.crt"),
        server_cert=os.path.join(directory, "server.crt"),
        server_key=os.path.join(directory, "server.key"),
    )
    with _mint_lock:
        if all(os.path.exists(p) for p in (paths.ca_cert, paths.server_cert, paths.server_key)):
            # A reordered host set is not a reason to re-mint the CA and
            # break pinned clients.
            if set(read_hosts_marker(directory)) == set(hosts) and not _expiring_soon(
                    paths.server_cert):
                return paths
        # First boot, a changed host set, or a cert near expiry (the CA
        # key is not kept, so renewal is a re-mint): clients re-pin.
        if tool == "cryptography":
            _mint_with_cryptography(paths, hosts)
        else:
            _mint_with_openssl(paths, hosts)
        with open(os.path.join(directory, "hosts"), "w") as f:
            f.write(",".join(hosts) + "\n")
        return paths


def server_context(paths: TlsPaths) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(paths.server_cert, paths.server_key)
    return ctx


def is_pem_data(value: str) -> bool:
    """True when `value` is inline PEM rather than a file path."""
    return "-----BEGIN" in value


def client_context(ca_cert: str) -> ssl.SSLContext:
    """Verify the server against the pinned platform CA only. `ca_cert`
    is inline PEM (`is_pem_data`) or a local file path."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = True
    if is_pem_data(ca_cert):
        ctx.load_verify_locations(cadata=ca_cert)
    else:
        ctx.load_verify_locations(cafile=ca_cert)
    return ctx
