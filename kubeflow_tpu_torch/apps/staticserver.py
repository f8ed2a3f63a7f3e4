"""Static config server.

A copy of `kubeflow_tpu/apps/staticserver.py` (a module with no JAX in
it), whole; ``python -m kubeflow_tpu_torch.apps.staticserver ROOT PORT``.

Parity with `components/static-config-server/main.go` (SURVEY.md §2 #20):
a trivial file server for platform config, with path-traversal protection
and content-type detection — the 38-line Go binary, as an App on the
shared web core."""

from __future__ import annotations

import mimetypes
import pathlib

from kubeflow_tpu_torch.web import App, HttpError, Request, Response


class StaticConfigApp(App):
    def __init__(self, root: str | pathlib.Path):
        super().__init__("static-config-server")
        self.root = pathlib.Path(root).resolve()
        self.add_route("/<path:path>", self.serve_file)

    def serve_file(self, req: Request) -> Response:
        rel = req.path_params["path"] or "index.html"
        target = (self.root / rel).resolve()
        # resolve() collapses ../ — anything escaping the root is refused.
        if not target.is_relative_to(self.root):
            raise HttpError(403, "path escapes the serving root")
        if not target.is_file():
            raise HttpError(404, f"{rel} not found")
        ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        return Response(body=target.read_bytes(), content_type=ctype)


if __name__ == "__main__":  # python -m kubeflow_tpu_torch.apps.staticserver
    import sys

    from kubeflow_tpu_torch.utils import threads
    from kubeflow_tpu_torch.web.wsgi import serve

    root = sys.argv[1] if len(sys.argv) > 1 else "."
    port = int(sys.argv[2]) if len(sys.argv) > 2 else 8080
    server, thread = serve(StaticConfigApp(root), port=port)
    print(f"static-config-server on :{server.server_port} root={root}")
    # Bounded foreground park (^C stops cleanly; no untimed join).
    if threads.run_until_interrupt(thread):
        server.shutdown()
        threads.join_thread(thread, timeout=10.0, what="http server")
