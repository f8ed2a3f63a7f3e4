"""Echo server — the ingress-auth validation sample.

A copy of `kubeflow_tpu/apps/echo.py` (a module with no JAX in it).
Parity with `components/echo-server/main.py` (SURVEY.md §2 #19): reflects
the request (method, path, headers, body) back as JSON so operators can
see exactly what identity headers the mesh/ingress injected — the tool
the reference used to validate its IAP/Cloud-Endpoints auth path."""

from __future__ import annotations

from kubeflow_tpu_torch.web import App, Request, json_response


class EchoApp(App):
    def __init__(self):
        super().__init__("echo-server")
        self.add_route(
            "/<path:path>", self.echo, ("GET", "POST", "PUT", "DELETE")
        )

    def echo(self, req: Request):
        return json_response(
            {
                "method": req.method,
                "path": req.path,
                "query": dict(req.query),
                "headers": {k: v for k, v in sorted(req.headers.items())},
                "body": req.body.decode("utf-8", "replace"),
                "user": req.user,
            }
        )


if __name__ == "__main__":  # python -m kubeflow_tpu_torch.apps.echo
    import sys

    from kubeflow_tpu_torch.utils import threads
    from kubeflow_tpu_torch.web.wsgi import serve

    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8080
    server, thread = serve(EchoApp(), port=port)
    print(f"echo-server on :{server.server_port}")
    # Bounded foreground park (^C stops cleanly; no untimed join).
    if threads.run_until_interrupt(thread):
        server.shutdown()
        threads.join_thread(thread, timeout=10.0, what="http server")
