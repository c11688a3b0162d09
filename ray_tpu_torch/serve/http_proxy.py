"""HTTP ingress proxy.

Port of ray_tpu/serve/http_proxy.py: HTTP ingress routed by longest prefix
to the application's ingress deployment, each request forwarded through a
streaming handle call, the response streamed back (SSE/chunks when the
deployment returns a generator). Standard library only (``http.server``).

The server runs in a thread carrying the runtime's thread-name prefix,
serving one request at a time off the listening socket and each in a
thread of its own; ``shutdown`` stops the loop, closes the socket and joins
the request threads, and the loop also ends when the runtime shuts down. A
client that closes a stream early ends the handler's write: the stream is
closed, which frees the router slot and stops the replica's generator at
its next yield.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ray_tpu_torch.serve import resilience


@dataclass
class Request:
    """What an ingress deployment's __call__ receives for an HTTP request
    (reference: starlette Request equivalent, minimal surface)."""

    method: str
    path: str
    query_params: dict[str, str] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body) if self.body else None

    @property
    def text(self) -> str:
        return self.body.decode()


class ProxyActor:
    """Binds an HTTP server; routes longest-prefix-match to the ingress
    deployment's handle. Runs as an actor (one per node in the reference;
    one per cluster here until multi-node proxying lands)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        from ray_tpu_torch.core.worker import global_worker

        self._routes: dict[str, str] = {}
        self._handles: dict[str, DeploymentHandle] = {}
        self._lock = threading.Lock()

        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _dispatch(self):
                parsed = urlparse(self.path)
                route, dep = proxy._match(parsed.path)
                if dep is None:
                    self.send_response(404)
                    self.end_headers()
                    self.wfile.write(b"no application at this route")
                    return
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                req = Request(
                    method=self.command,
                    path=parsed.path[len(route.rstrip("/")):] or "/",
                    query_params={k: v[0] for k, v in
                                  parse_qs(parsed.query).items()},
                    headers={k: v for k, v in self.headers.items()},
                    body=body,
                )
                try:
                    hint = (self.headers.get("x-route-hint")
                            or _prefix_route_hint(body))
                    # Per-request budget: the x-request-timeout-s header
                    # overrides the deployment's request_timeout_s; the
                    # deadline rides the call end to end (router queue,
                    # replica admission, batcher).
                    timeout_s = None
                    raw_t = self.headers.get("x-request-timeout-s")
                    if raw_t:
                        try:
                            timeout_s = max(float(raw_t), 0.001)
                        except ValueError:
                            timeout_s = None
                    gen = proxy._get_handle(dep).options(
                        stream=True, route_hint=hint,
                        timeout_s=timeout_s).remote(req)
                    gen.timeout = timeout_s or 60.0  # bound per chunk
                    if gen.streaming:
                        # SSE/chunk streaming: write each produced chunk as
                        # it arrives; length-delimited by connection close
                        # (reference: proxy_request streaming path,
                        # proxy.py:481).
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/event-stream; charset=utf-8")
                        self.send_header("Cache-Control", "no-cache")
                        self.send_header("Connection", "close")
                        self.end_headers()
                        try:
                            for chunk in gen:
                                if isinstance(chunk, str):
                                    chunk = chunk.encode()
                                elif not isinstance(chunk,
                                                    (bytes, bytearray)):
                                    chunk = json.dumps(chunk).encode()
                                self.wfile.write(chunk)
                                self.wfile.flush()
                        except Exception:  # noqa: BLE001
                            # 200 + body already on the wire: terminate the
                            # stream (connection close) — a second status
                            # line would corrupt the client's event stream.
                            # A client gone mid-stream lands here too.
                            gen.close()
                        return
                    result = next(gen)
                except Exception as e:  # noqa: BLE001 - mapped below
                    # Resilience-aware status mapping (reference: serve
                    # returns 503 on backpressure so clients/load balancers
                    # back off instead of piling on):
                    #   Overloaded        → 503 + Retry-After
                    #   DeadlineExceeded  → 504 (budget spent in-cluster)
                    #   anything else     → 500
                    cause = resilience.unwrap(e)
                    if isinstance(cause, resilience.Overloaded):
                        self.send_response(503)
                        self.send_header(
                            "Retry-After",
                            str(max(1, int(cause.retry_after_s))))
                        self.end_headers()
                        self.wfile.write(
                            f"overloaded ({cause.where})".encode())
                        return
                    if isinstance(cause, (resilience.DeadlineExceeded,
                                          TimeoutError)):
                        self.send_response(504)
                        self.end_headers()
                        self.wfile.write(b"request deadline exceeded")
                        return
                    self.send_response(500)
                    self.end_headers()
                    self.wfile.write(repr(e).encode())
                    return
                status, ctype, payload = _encode(result)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_PUT = do_DELETE = _dispatch

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.timeout = 0.1  # the serve loop's poll period
        self._port = self._server.server_address[1]
        self._stopped = threading.Event()
        self._runtime = global_worker.runtime
        self._thread = self._runtime._start_thread(self._serve, (),
                                                   "serve-http")

    def _serve(self) -> None:
        while not self._stopped.is_set() and not self._runtime._shutdown:
            self._server.handle_request()

    def _match(self, path: str):
        with self._lock:
            best = None
            for route, dep in self._routes.items():
                r = route.rstrip("/") or "/"
                if path == r or path.startswith(r.rstrip("/") + "/") or r == "/":
                    if best is None or len(r) > len(best[0]):
                        best = (r, dep)
            return best if best else ("/", None)

    def _get_handle(self, deployment_name: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        with self._lock:
            if deployment_name not in self._handles:
                self._handles[deployment_name] = DeploymentHandle(deployment_name)
            return self._handles[deployment_name]

    # -- control plane --

    def update_routes(self, routes: dict[str, str]) -> None:
        with self._lock:
            self._routes = dict(routes)

    def port(self) -> int:
        return self._port

    def ready(self) -> bool:
        return True

    def shutdown(self) -> None:
        """Stop serving, close the socket and join the request threads."""
        self._stopped.set()
        if self._thread is not threading.current_thread():
            self._thread.join()
        self._server.server_close()


def _prefix_route_hint(body: bytes) -> str | None:
    """Prefix-affinity hint for LLM-shaped requests (reference:
    routing_policies/prefix_aware): requests sharing a prompt prefix hash
    to the same hint, so the router sends them to the replica whose engine
    already holds that prefix's KV (engine-side reuse: LLMEngine prefix
    cache). Non-JSON / non-LLM bodies get no hint (pow-2 routing)."""
    if not body or len(body) > 1 << 20:
        return None
    try:
        payload = json.loads(body)
    except Exception:
        return None
    if not isinstance(payload, dict):
        return None
    text = None
    if isinstance(payload.get("prompt"), str):
        text = payload["prompt"]
    elif isinstance(payload.get("messages"), list) and payload["messages"]:
        first = payload["messages"][0]
        if isinstance(first, dict) and isinstance(first.get("content"), str):
            text = first["content"]
    if not text:
        return None
    import hashlib

    # Hash a FIXED-size head block so the divergent tail never enters the
    # hint: prompts sharing >= 128 chars (the system-prompt shape) map to
    # one replica. Prefixes shorter than the block scatter — acceptable,
    # their prefill is cheap anyway.
    return hashlib.sha1(text[:128].encode("utf-8", "ignore")).hexdigest()[:16]


def _encode(result) -> tuple[int, str, bytes]:
    if isinstance(result, Response):
        return result.status_code, result.content_type, result.body
    if isinstance(result, bytes):
        return 200, "application/octet-stream", result
    if isinstance(result, str):
        return 200, "text/plain; charset=utf-8", result.encode()
    return 200, "application/json", json.dumps(result).encode()


@dataclass
class Response:
    body: bytes
    status_code: int = 200
    content_type: str = "application/octet-stream"
