"""Bounded joins with loud stuck-thread diagnostics.

The port's own copy of the parts of `kubeflow_tpu/utils/threads.py` that
the checkpointer and the model-server binary use: a thread join and a
drain-wait on a `queue.Queue` with a deadline (`queue.Queue.join` has
none), each raising `StuckThreadError` with a stack dump of every live
thread instead of hanging its caller forever, and the binary's
foreground loop (`run_until_interrupt`). The deadline defaults to
``KFTPU_STUCK_TIMEOUT_S`` (300 s).
"""

from __future__ import annotations

import os
import queue as queue_mod
import sys
import threading
import time
import traceback

DEFAULT_TIMEOUT_S = 300.0


class StuckThreadError(RuntimeError):
    """A bounded join expired: some thread or queue never finished."""


def stuck_timeout_s() -> float:
    """The default deadline, overridable with KFTPU_STUCK_TIMEOUT_S."""
    raw = os.environ.get("KFTPU_STUCK_TIMEOUT_S", "")
    try:
        return float(raw) if raw else DEFAULT_TIMEOUT_S
    except ValueError:
        return DEFAULT_TIMEOUT_S


def dump_thread_stacks() -> str:
    """One formatted stack per live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(sys._current_frames().items()):
        stack = "".join(traceback.format_stack(frame))
        out.append(f"--- thread {names.get(ident, '?')} (ident={ident}) ---\n{stack}")
    return "\n".join(out)


def join_thread(
    thread: threading.Thread,
    timeout: float | None = None,
    *,
    what: str = "",
) -> None:
    """`thread.join` with a deadline; raises `StuckThreadError` (with
    every thread's stack) instead of hanging forever."""
    deadline = timeout if timeout is not None else stuck_timeout_s()
    thread.join(deadline)
    if thread.is_alive():
        raise StuckThreadError(
            f"{what or thread.name} still running after {deadline:.0f}s join — "
            f"thread stacks:\n{dump_thread_stacks()}"
        )


def join_queue(
    q: "queue_mod.Queue",
    timeout: float | None = None,
    *,
    what: str = "",
) -> None:
    """`queue.Queue.join` with a deadline; raises `StuckThreadError`
    (with every thread's stack) when it expires."""
    deadline_s = timeout if timeout is not None else stuck_timeout_s()
    deadline = time.monotonic() + deadline_s
    with q.all_tasks_done:
        while q.unfinished_tasks:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise StuckThreadError(
                    f"{what or 'queue'} still has {q.unfinished_tasks} "
                    f"unfinished task(s) after {deadline_s:.0f}s — "
                    f"thread stacks:\n{dump_thread_stacks()}"
                )
            q.all_tasks_done.wait(remaining)


def run_until_interrupt(thread: threading.Thread) -> bool:
    """The foreground loop of a server binary: wait on the server thread
    in bounded slices (so that ^C interrupts the wait) until it exits or
    the operator hits ^C. True when interrupted, False when the thread
    exited."""
    try:
        while thread.is_alive():
            thread.join(1.0)
    except KeyboardInterrupt:
        return True
    return False
