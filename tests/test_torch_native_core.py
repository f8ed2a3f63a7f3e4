"""The port's compiled control-plane core (`kubeflow_tpu_torch/native/`:
`core.py` over ``csrc/{json,workqueue,store,wal}.cc``) against the JAX
package's.

First JAX's own tests/test_native_core.py runs on the port, its imports
pointed at the port's modules: its ``wq`` fixture over both of the
port's queues (the compiled `native.core.WorkQueue` and its Python twin
`controllers.runtime.PyWorkQueue`), controllers on the port's
`NativeApiServer`, the lease-fencing parity (with the two ``.thaw()``
calls JAX's test lacks: it assigns to a frozen Lease snapshot, and then
to a frozen Widget, and fails on its own store), the native store
behind the HTTP facade and the DELETED event's fresh resourceVersion.
Then one seeded script of adds, delays, done, `requeue_error` and
forget through JAX's compiled queue, the port's and the port's twin
gives the same `get` order and backoff values; the
compiled tier is the default of `make_workqueue`, `make_gang_scheduler`
and `open_wal`, and a compiler that fails makes each raise; and the C++
unit tests (`core_test.cc`, `scheduler_test.cc`) build from the port's
sources and pass.
"""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import pytest

from kubeflow_tpu.controllers.runtime import _PyWorkQueue as JPyWorkQueue
from kubeflow_tpu.native.core import WorkQueue as JWorkQueue
from kubeflow_tpu_torch.controllers import runtime
from kubeflow_tpu_torch.native import build, core, scheduler
from kubeflow_tpu_torch.testing import persist
from kubeflow_tpu_torch.testing.fake_apiserver import FakeApiServer

REPO = Path(__file__).resolve().parents[1]
# JAX's test, on the port: the Python twin's name, and the Lease and the
# Widget read thawed before they are edited.
PATCHES = (
    ("from kubeflow_tpu.controllers.runtime import Controller, Result, _PyWorkQueue",
     "from kubeflow_tpu.controllers.runtime import Controller, Result, "
     "PyWorkQueue as _PyWorkQueue"),
    ('    lease = api.get("Lease", "native-ctl", "")\n',
     '    lease = api.get("Lease", "native-ctl", "").thaw()\n'),
    ('    w1 = api.get("Widget", "w1")\n', '    w1 = api.get("Widget", "w1").thaw()\n'),
)


def _jax_tests_on_the_port(stem: str, patches=()) -> dict:
    """JAX's tests/<stem>.py with `kubeflow_tpu.` pointed at the port:
    its test functions, test classes and fixtures."""
    path = REPO / "tests" / f"{stem}.py"
    src = path.read_text()
    for old, new in patches:
        assert old in src, old
        src = src.replace(old, new)
    src = src.replace("from kubeflow_tpu.testing import",
                      "from kubeflow_tpu.testing.fake_apiserver import")
    src = re.sub(r"\bkubeflow_tpu\.", "kubeflow_tpu_torch.", src)
    namespace: dict = {"__name__": f"port_{stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), namespace)
    return {k: v for k, v in namespace.items()
            if k.startswith(("test_", "Test")) or hasattr(v, "_fixture_function_marker")}


JAX_TESTS = _jax_tests_on_the_port("test_native_core", PATCHES)
globals().update(JAX_TESTS)  # collected here, under JAX's names


def test_every_jax_native_core_test_is_collected():
    src = (REPO / "tests" / "test_native_core.py").read_text()
    names = set(re.findall(r"^(?:def (test_\w+)|class (Test\w+))", src, re.M))
    assert {a or b for a, b in names} <= set(JAX_TESTS)
    assert "wq" in JAX_TESTS


# -- one seeded script through the three queues ------------------------------


def _script(seed: int, n: int = 120) -> list[tuple]:
    """Adds (now, or far enough ahead never to come due in the script),
    gets, done, error requeues (a base backoff of 60 s: they come due
    only when a sooner add supersedes them), forgets."""
    rng = random.Random(seed)
    keys = [f"ns/k{i}" for i in range(6)]
    ops = []
    for _ in range(n):
        op = rng.choice(("add", "add", "add_later", "get", "get", "done", "error", "forget"))
        ops.append((op, rng.choice(keys)))
    return ops


def _run(queue, ops) -> list:
    held: list[str] = []
    out = []
    for op, key in ops:
        if op == "add":
            queue.add(key)
        elif op == "add_later":
            queue.add(key, after=3600.0)
        elif op == "get":
            got = queue.get()
            if got is not None:
                held.append(got)
            out.append(("get", got))
        elif op == "done":
            if held:
                queue.done(held.pop(0))
        elif op == "error":
            if held:
                k = held.pop(0)
                out.append(("error", k, queue.requeue_error(k)))
                queue.done(k)
        elif op == "forget":
            queue.forget(key)
        out.append(("len", len(queue)))
    while True:  # drain what is ready
        got = queue.get()
        out.append(("drain", got))
        if got is None:
            break
        queue.done(got)
    pending = queue.next_ready_in()
    out.append(("pending", pending is not None and pending > 30.0))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_seeded_script_same_order_and_backoff_as_jax_compiled_queue(seed):
    ops = _script(seed)
    kw = dict(base_backoff=60.0, max_backoff=600.0)
    want = _run(JWorkQueue(**kw), ops)
    assert _run(core.WorkQueue(**kw), ops) == want
    assert _run(runtime.PyWorkQueue(**kw), ops) == want
    assert _run(JPyWorkQueue(**kw), ops) == want
    assert any(x[0] == "error" for x in want) and any(x[0] == "get" and x[1] for x in want)
    backoffs = [x[2] for x in want if x[0] == "error"]
    assert set(backoffs) <= {60.0, 120.0, 240.0, 480.0, 600.0}


# -- the compiled tier is the default, and a failed build raises --------------


def test_controllers_run_on_the_compiled_queue_by_default():
    api = FakeApiServer()
    ctl = runtime.Controller(api, "Widget", lambda api, key: None)
    assert isinstance(ctl._queue, core.WorkQueue)
    assert core.backend_of(ctl._queue) == "native"
    twin = runtime.Controller(api, "Widget", lambda api, key: None,
                              workqueue=runtime.PyWorkQueue())
    assert core.backend_of(twin._queue) == "python"
    assert core.backend_of(object()) == "custom"
    assert isinstance(scheduler.make_gang_scheduler(), scheduler.GangScheduler)
    api.close()


def test_a_compiler_that_fails_makes_the_compiled_tier_raise(tmp_path, monkeypatch):
    """With nothing built and a ``c++`` on PATH that exits 1, every entry
    to the compiled tier raises; none falls back to its Python twin."""
    fake = tmp_path / "bin" / "c++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'c++: refusing' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)c\\+\\+ failed on .*refusing"):
        runtime.make_workqueue()
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        scheduler.make_gang_scheduler()
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        persist.open_wal(str(tmp_path / "state"))
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        FakeApiServer(persist_dir=str(tmp_path / "state"))
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        runtime.Controller(FakeApiServer(), "Widget", lambda api, key: None)
    # Named twins need no compiler.
    assert runtime.PyWorkQueue().get() is None
    assert type(persist.open_wal(str(tmp_path / "py"), backend="python")).__name__ == "PyWal"
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_core_library_builds_from_the_port_sources(tmp_path, monkeypatch):
    """libkftpu_core is the JAX CMake target's four sources, from the
    port's csrc, named by their hash; a second load is the first's."""
    assert [p.name for p in build.sources("kftpu_core")] == [
        "json.cc", "workqueue.cc", "store.cc", "wal.cc"]
    assert all(p.parent == REPO / "kubeflow_tpu_torch" / "native" / "csrc"
               for p in build.sources("kftpu_core") + build.sources("kftpu_sched"))
    lib = build.build("kftpu_core")
    assert lib == build.target("kftpu_core") and lib.name.startswith("libkftpu_core-")
    assert build.load("kftpu_core", core._configure) is core._lib()


# -- the C++ unit tests, from the port's sources ------------------------------


@pytest.mark.parametrize("test, sources", [
    ("core_test", ("core_test.cc", "json.cc", "workqueue.cc", "store.cc", "wal.cc")),
    ("scheduler_test", ("scheduler_test.cc", "scheduler.cc")),
])
def test_cpp_unit_tests_pass_from_the_port_sources(tmp_path, test, sources):
    # Built beside the libraries, named by the same hash of its sources,
    # the headers and the flags: an unchanged test binary is built once.
    flags = ("-O1", "-std=c++17", "-pthread")
    paths = [build.CSRC / s for s in sources]
    exe = build.BUILD_DIR / f"{test}-{build.source_digest(paths, flags)}"
    if not exe.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
        subprocess.run(["c++", *flags, "-o", str(tmp), *map(str, paths)], check=True,
                       timeout=300)
        os.replace(tmp, exe)
    proc = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120,
                          env={"TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout or "passed" in proc.stdout


def test_core_modules_import_no_jax():
    modules = ["kubeflow_tpu_torch.native", "kubeflow_tpu_torch.native.core",
               "kubeflow_tpu_torch.native.scheduler", "kubeflow_tpu_torch.native.apiserver",
               "kubeflow_tpu_torch.native.build", "kubeflow_tpu_torch.controllers.runtime"]
    code = ("import sys\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'kubeflow_tpu',"
            " 'torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
