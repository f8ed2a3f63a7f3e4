"""The port's gang-worker sidecar (`kubeflow_tpu_torch/sidecar/`) against
the JAX package's.

First JAX's own tests (tests/test_sidecar.py, all 11) run against the
port: the module's source with its imports pointed at the port, the
CLI among them against the port's HTTP facade. Then one scripted
sequence of probe readings and job phases goes through both packages'
`SidecarController` on one fake clock: the same signal files at the
same times and the same return values. Then what the port changes: the
device probe asks the CUDA driver without torch and without a context,
and the CLI refuses an https endpoint list without a pinned CA, and
takes one with `--ca` through to its client, failing over past a dead
first endpoint.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu.api.objects import new_resource as j_new_resource
from kubeflow_tpu.sidecar import controller as j_sidecar
from kubeflow_tpu.testing import FakeApiServer as JFakeApiServer
from kubeflow_tpu_torch.api.objects import new_resource as t_new_resource
from kubeflow_tpu_torch.sidecar import controller as t_sidecar
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp, HttpApiClient
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import serve

REPO = Path(__file__).resolve().parents[1]


def _jax_tests_on_the_port(path: Path) -> dict:
    """JAX's test module `path` executed with `kubeflow_tpu.` imports
    pointed at `kubeflow_tpu_torch.` (the port's `testing` package
    exports nothing, so its store is named by module): the namespace."""
    src = path.read_text().replace("from kubeflow_tpu.testing import",
                                   "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return namespace


PORT = _jax_tests_on_the_port(REPO / "tests" / "test_sidecar.py")
PORT_TESTS = {k: v for k, v in PORT.items() if k.startswith("test_") and callable(v)}


def _http_api():
    """JAX's `http_api` fixture, on the port: (store, client, server)."""
    api = FakeApiServer()
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0)
    return api, HttpApiClient(f"http://127.0.0.1:{server.server_port}"), server


def test_all_of_jax_sidecar_tests_are_ported():
    assert len(PORT_TESTS) == 11


@pytest.mark.parametrize("name", sorted(PORT_TESTS))
def test_jax_sidecar_tests_on_the_port(name, tmp_path):
    fn = PORT_TESTS[name]
    params = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    if params == ("http_api",):
        api, client, server = _http_api()
        try:
            fn((api, client))
        finally:
            client.close()
            server.shutdown()
            server.server_close()
    else:
        fn(tmp_path) if params else fn()


# -- one scripted sequence through both sidecars ------------------------------

# (time, event): the device and coordinator come up, the job runs, then
# a poll fails, then the job succeeds.
SCRIPT = [(2.0, "device"), (4.0, "coordinator"), (5.0, "running"), (7.0, "poll_error"),
          (9.0, "succeeded")]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run_script(pkg, new_resource, store, tmp_path, timeout: float):
    api = store()
    api.create(new_resource("TpuJob", "job1", "team"))
    clock = _Clock()
    state = {"device": False, "coordinator": False, "poll_error": False}
    timeline = []

    def advance(dt):
        clock.t += dt
        for at, event in SCRIPT:
            if at == clock.t:
                if event in ("running", "succeeded"):
                    job = api.get("TpuJob", "job1", "team").thaw()
                    job.status["phase"] = "Running" if event == "running" else "Succeeded"
                    api.update_status(job)
                state[event] = True
        state["poll_error"] = clock.t == 7.0

    class FlakyApi:
        def get(self, *a, **kw):
            if state["poll_error"]:
                raise ConnectionRefusedError("apiserver restarting")
            return api.get(*a, **kw)

    workdir = tmp_path / pkg.__name__.split(".")[0] / "sig"
    results = tmp_path / pkg.__name__.split(".")[0] / "results"
    results.mkdir(parents=True)
    (results / "metrics.json").write_text("{}")
    uploaded = []

    def upload(path):
        uploaded.append((clock.t, path.name))

    def sleep(dt):
        advance(dt)
        timeline.append((clock.t, sorted(p.name for p in workdir.glob("*"))
                         if workdir.exists() else []))

    ctl = pkg.SidecarController(
        workdir=workdir, job_name="job1", namespace="team", api=FlakyApi(),
        device_probe=lambda: state["device"],
        coordinator_probe=lambda: state["coordinator"],
        upload=upload, poll_seconds=1.0, timeout_seconds=timeout, clock=clock, sleep=sleep)
    try:
        phase = ctl.run(results_dir=results)
    except TimeoutError as e:
        phase = f"timeout: {e}"
    files = sorted(p.name for p in workdir.glob("*")) if workdir.exists() else []
    return phase, files, timeline, uploaded


@pytest.mark.parametrize("timeout", [30.0, 3.0, 6.0])
def test_scripted_sequence_equals_jax(tmp_path, timeout):
    want = _run_script(j_sidecar, j_new_resource, JFakeApiServer, tmp_path, timeout)
    got = _run_script(t_sidecar, t_new_resource, FakeApiServer, tmp_path, timeout)
    assert got[1:] == want[1:]
    # The gate's name for the device is the port's own.
    assert got[0] == want[0].replace("tpu runtime", "cuda device")
    if timeout == 30.0:
        assert got[0] == "Succeeded" and got[1] == ["SIGCONT", "SIGTERM"]


# -- what the port changes ---------------------------------------------------


def test_device_probe_asks_the_driver_without_torch_or_a_context():
    """No torch import (a sidecar does no device work), and False where
    there is no CUDA driver. On the card, chip_smoke's node_lost phase
    holds the sidecar's pid out of nvidia-smi's compute apps."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; from kubeflow_tpu_torch.sidecar.controller import default_device_probe;"
         "ok = default_device_probe(); print(ok, 'torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    probed, imported_torch = out.stdout.split()
    assert imported_torch == "False"
    try:
        import ctypes
        ctypes.CDLL("libcuda.so.1")
    except OSError:
        assert probed == "False"


def test_cli_refuses_an_endpoint_list(tmp_path):
    """An https endpoint list with no CA to pin (no --ca, no KFTPU_CA) is
    refused before the work directory is touched."""
    env = {k: v for k, v in os.environ.items() if k != "KFTPU_CA"}
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.sidecar", "--workdir", str(tmp_path),
         "--job", "j", "--apiserver", "https://127.0.0.1:1,https://127.0.0.1:2",
         "--skip-device-probe"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 2
    assert "KFTPU_CA" in out.stderr
    assert not (tmp_path / "SIGCONT").exists()


def test_cli_passes_an_endpoint_list_and_ca_to_its_client(tmp_path):
    """`--apiserver dead,live --ca`: the sidecar's client pins the CA,
    fails over past the dead endpoint, and reads the job's terminal
    phase from the live one."""
    import socket

    from kubeflow_tpu_torch.web import tls

    paths = tls.ensure_tls_dir(str(tmp_path / "tls"))
    api = FakeApiServer()
    job = api.create(t_new_resource("TpuJob", "j", "team", spec={})).thaw()
    job.status["phase"] = "Succeeded"
    api.update_status(job)
    server, _ = serve(ApiServerApp(api), host="127.0.0.1", port=0, tls=paths)
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    endpoints = f"https://127.0.0.1:{dead},https://127.0.0.1:{server.server_port}"
    try:
        out = subprocess.run(
            [sys.executable, "-m", "kubeflow_tpu_torch.sidecar", "--workdir",
             str(tmp_path / "sig"), "--job", "j", "--namespace", "team", "--apiserver",
             endpoints, "--ca", paths.ca_cert, "--skip-device-probe", "--poll-seconds", "0.1"],
            cwd=REPO, capture_output=True, text=True, timeout=60)
    finally:
        server.shutdown()
        server.server_close()
    assert out.returncode == 0, out.stderr
    assert "terminal phase: Succeeded" in out.stdout
    assert server.tls_handshakes >= 1


def test_cli_builds_its_client_from_the_flags(tmp_path, monkeypatch):
    from kubeflow_tpu_torch.sidecar import __main__ as cli
    from kubeflow_tpu_torch.testing import apiserver_http

    built = []

    class Recorder(HttpApiClient):
        def __init__(self, base_url, **kw):
            built.append((list(base_url), kw))
            super().__init__(base_url, **kw)

    monkeypatch.setattr(apiserver_http, "HttpApiClient", Recorder)
    monkeypatch.setattr(cli.SidecarController, "run", lambda self, results_dir=None: "Succeeded")
    assert cli.main(["--workdir", str(tmp_path), "--job", "j", "--apiserver",
                     " http://127.0.0.1:1 , http://127.0.0.1:2", "--ca", "ca.pem",
                     "--skip-device-probe"]) == 0
    assert built == [(["http://127.0.0.1:1", "http://127.0.0.1:2"], {"ca": "ca.pem"})]


def test_cli_start_gate_only_without_an_apiserver(tmp_path):
    """No apiserver: the gate, then "Unknown" (exit 1), results still
    uploaded."""
    results = tmp_path / "results"
    results.mkdir()
    (results / "observation.json").write_text("{}")
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.sidecar", "--workdir", str(tmp_path / "sig"),
         "--job", "j", "--skip-device-probe", "--results", str(results),
         "--artifacts", str(tmp_path / "store")],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 1, out.stderr
    assert "terminal phase: Unknown" in out.stdout
    assert (tmp_path / "sig" / "SIGCONT").exists()
    assert not (tmp_path / "sig" / "SIGTERM").exists()
    assert (tmp_path / "store" / "observation.json").exists()
