"""Start a gang of local processes through the TpuJob env contract.

`run_gang(argv, n)` starts n copies of `argv` with TPUJOB_COORDINATOR on
a free localhost port, TPUJOB_NUM_PROCESSES = n and each its
TPUJOB_PROCESS_ID, as the operator and the local pod runner start a
TpuJob's workers, and waits for all of them with one deadline. On the
deadline, or on any way out, every process still running is killed and
reaped, so a hung collective fails the caller instead of hanging it.
The tests' gangs and chip_smoke's gang phase start their ranks here.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_gang(argv: list[str], n: int, *, timeout: float = 60.0, env: dict | None = None,
             cwd: str | None = None, ranks_env: dict | None = None) -> list[tuple[int, str]]:
    """Each rank's (exit code, output) in rank order: `argv` run by `n`
    processes of one gang. `env` is the base environment (this process's
    by default), `ranks_env` maps a rank to extra variables of its own.
    A rank still running at `timeout` s is killed (its code is then
    negative) and its output says so."""
    base = dict(os.environ if env is None else env,
                TPUJOB_COORDINATOR=f"localhost:{free_port()}",
                TPUJOB_NUM_PROCESSES=str(n))
    procs = [
        subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env={**base, "TPUJOB_PROCESS_ID": str(r),
                                         **(ranks_env or {}).get(r, {})})
        for r in range(n)
    ]
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            try:
                text = p.communicate(timeout=max(0.1, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + f"\n[killed at the gang's {timeout} s deadline]"
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out
