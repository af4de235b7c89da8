"""HTTP front end for the persistent imputation service.

Port of rag_snvbert_tpu/infer/httpd.py (standard library only).
Endpoints:
  GET  /health   -> {"ok": true, "ref_sites": N, "requests": N}, and
                    "stats" (``BatchingImputationService.stats``) where
                    the service keeps them
  POST /impute   -> the body is one ``ImputationService.handle`` request
                    dict; the response is its response dict (200, or 422
                    when it reports an error); 400 for a body that is not
                    JSON, 404 for any other path.

Concurrency: with a ``BatchingImputationService`` (``concurrent=True``,
the ``serve --http`` service) requests run at once: VCF parse and result
writing on the handler threads, device work through the service's
scheduler thread, which merges same-pattern requests.  A plain
``ImputationService`` is held behind one global request lock.
``ThreadingHTTPServer`` accepts sockets concurrently either way, so health
checks never wait behind an imputation.
"""

from __future__ import annotations

import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .serve import ImputationService


class _Handler(BaseHTTPRequestHandler):
    # set per server in make_server()
    service: ImputationService
    lock: threading.Lock
    counter: list

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: the service reports in-band
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (standard library handler naming)
        if self.path != "/health":
            self._reply(404, {"ok": False, "error": "unknown path"})
            return
        payload = {"ok": True, "ref_sites": self.service.ref_vcf.n_variants,
                   "requests": self.counter[0]}
        stats = getattr(self.service, "stats", None)
        if stats is not None:
            payload["stats"] = stats
        self._reply(200, payload)

    def do_POST(self):  # noqa: N802
        if self.path != "/impute":
            self._reply(404, {"ok": False, "error": "unknown path"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
        except Exception as e:
            self._reply(400, {"ok": False,
                              "error": f"bad request: {type(e).__name__}: {e}"})
            return
        concurrent = getattr(self.service, "concurrent", False)
        guard = contextlib.nullcontext() if concurrent else self.lock
        with guard:
            try:
                resp = self.service.handle(req)
            except Exception as e:  # keep serving; the error goes in-band
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        with self.lock:
            self.counter[0] += 1
        self._reply(200 if resp.get("ok") else 422, resp)


def make_server(service: ImputationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bind an HTTP server around ``service``.  ``port=0`` picks a free
    port (``server.server_address[1]`` has the real one).  Call
    ``serve_forever()`` (blocking) or drive it from a thread; stop it with
    ``server.shutdown()``."""
    handler = type("Handler", (_Handler,),
                   {"service": service, "lock": threading.Lock(),
                    "counter": [0]})
    return ThreadingHTTPServer((host, port), handler)


def serve_http(service: ImputationService, host: str, port: int) -> None:
    """Blocking HTTP serve loop (the ``serve --http`` verb)."""
    server = make_server(service, host, port)
    addr = server.server_address
    print(json.dumps({"ready": True, "http": f"{addr[0]}:{addr[1]}",
                      "ref_sites": service.ref_vcf.n_variants}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if hasattr(service, "close"):
            service.close()     # stop the batching scheduler thread
