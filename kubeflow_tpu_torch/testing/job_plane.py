"""The job plane on one host: store, facade, controller manager, kubelet.

`JobPlane` stands up what a TpuJob or a Study needs to run end to end
on one machine, as the JAX package's e2e soaks do:

- an in-process `FakeApiServer` with the TpuJob admission hook, served
  over HTTP by `ApiServerApp` on a free localhost port;
- the controller-manager binary (``python -m kubeflow_tpu_torch.controllers
  --apiserver <facade> --controllers ...``) as a separate process,
  waited on until it prints ``manager ready``;
- a `LocalPodRunner` in this process, stepped by `run_until`, that execs
  each pod (every pod gets ``KFTPU_APISERVER``, the facade's URL).

Every wait has a deadline and fails loudly with the manager's output
and the pod logs; `close` reaps the pods, the manager and the facade on
every exit path (use it as a context manager).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from kubeflow_tpu_torch.controllers.tpujob import register_admission
from kubeflow_tpu_torch.runtime.local import LocalPodRunner
from kubeflow_tpu_torch.testing.apiserver_http import ApiServerApp
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer
from kubeflow_tpu_torch.web.wsgi import serve

ROOT = Path(__file__).resolve().parents[2]


class JobPlane:
    def __init__(
        self,
        *,
        controllers: tuple[str, ...] = ("tpujob", "study"),
        extra_env: dict[str, str] | None = None,
        capture_dir: str | None = None,
        ready_timeout: float = 120.0,
    ):
        self.api = FakeApiServer()
        register_admission(self.api)
        self.server, _ = serve(ApiServerApp(self.api), host="127.0.0.1", port=0)
        self.url = f"http://127.0.0.1:{self.server.server_port}"
        self.manager_output: list[str] = []
        self.manager: subprocess.Popen | None = None
        self.runner: LocalPodRunner | None = None
        self.capture_dir = capture_dir
        try:
            self._start_manager(controllers, ready_timeout)
            self.runner = LocalPodRunner(
                self.api, cwd=str(ROOT),
                extra_env={"KFTPU_APISERVER": self.url, **(extra_env or {})},
                capture_dir=capture_dir)
        except BaseException:
            self.close()
            raise

    def _start_manager(self, controllers, timeout: float) -> None:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.manager = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.controllers", "--apiserver", self.url,
             "--controllers", ",".join(controllers)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        ready = threading.Event()

        def read() -> None:
            for line in self.manager.stdout:
                self.manager_output.append(line.rstrip("\n"))
                if line.startswith("manager ready"):
                    ready.set()

        threading.Thread(target=read, name="manager-output", daemon=True).start()
        t0 = time.monotonic()
        while not ready.wait(0.1):
            if self.manager.poll() is not None or time.monotonic() - t0 > timeout:
                raise RuntimeError(
                    f"the controller manager did not come up within {timeout} s "
                    f"(exit {self.manager.poll()}):\n" + "\n".join(self.manager_output))
        # Process start to "manager ready".
        self.manager_ready_s = time.monotonic() - t0

    def run_until(self, predicate, timeout: float, what: str, tick=None) -> float:
        """Step the pod runner every 50 ms (calling `tick` too) until
        `predicate()` holds; returns the seconds it took. Raises with the
        manager's output and the pod logs after `timeout`, or at once if
        the manager died."""
        t0 = time.monotonic()
        while True:
            self.runner.step()
            if tick is not None:
                tick()
            if predicate():
                return time.monotonic() - t0
            if self.manager.poll() is not None:
                raise RuntimeError(f"the controller manager exited ({self.manager.poll()}) "
                                   f"while waiting for {what}\n{self.diagnostics()}")
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"timed out after {timeout} s waiting for {what}\n"
                                   f"{self.diagnostics()}")
            time.sleep(0.05)

    def pod_logs(self) -> dict[str, str]:
        out = {}
        if self.capture_dir and os.path.isdir(self.capture_dir):
            for name in sorted(os.listdir(self.capture_dir)):
                with open(os.path.join(self.capture_dir, name), errors="replace") as f:
                    out[name] = f.read()
        return out

    def diagnostics(self, tail: int = 60) -> str:
        parts = ["--- controller manager ---", *self.manager_output[-tail:]]
        for name, text in self.pod_logs().items():
            parts += [f"--- {name} ---", *text.splitlines()[-tail:]]
        return "\n".join(parts)

    def stop_manager(self, timeout: float = 30.0) -> int:
        """SIGTERM the manager and wait for it; returns its exit code."""
        if self.manager.poll() is None:
            self.manager.terminate()
            try:
                self.manager.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.manager.kill()
                self.manager.wait()
        return self.manager.returncode

    def close(self) -> None:
        if self.runner is not None:
            self.runner.shutdown()
        if self.manager is not None:
            self.stop_manager()
        self.server.shutdown()
        self.server.server_close()
        self.api.close()

    def __enter__(self) -> "JobPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
