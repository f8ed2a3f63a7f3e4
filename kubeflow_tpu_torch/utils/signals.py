"""Graceful-shutdown signal handling for long-running processes.

Counterpart of `kubeflow_tpu/utils/signals.py` (a module with no JAX in
it), whole. Two properties every entry point needs:

- **Event-based handlers, installed early.** A handler that raises can
  unwind through half-constructed boot state; setting an Event lets the
  main function finish (or abort) its boot and run one cleanup path.
  SIGINT is installed explicitly: a backgrounding non-interactive shell
  starts children with SIGINT ignored, and Python then skips its
  default handler.
- **Poll, don't park.** A process-directed signal can be delivered to a
  non-main thread; the Python handler runs only when the MAIN thread
  next executes bytecode, which a main thread parked in a bare
  ``Event.wait()`` never does. Waking every half second bounds shutdown
  latency.
"""

from __future__ import annotations

import signal
import threading


def install_shutdown_handlers(
    signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
) -> threading.Event:
    """Install handlers for `signals` that set the returned Event.
    Call from the MAIN thread, before serving anything."""
    stop = threading.Event()
    for sig in signals:
        signal.signal(sig, lambda *_: stop.set())
    return stop


def wait_for_shutdown(stop: threading.Event, poll: float = 0.5) -> None:
    """Block the main thread until `stop` is set — polling (see module
    docstring for why), and treating a raw KeyboardInterrupt (Ctrl-C
    delivered before/around our handler) as the same request."""
    try:
        while not stop.wait(poll):
            pass
    except KeyboardInterrupt:
        stop.set()
