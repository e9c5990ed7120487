"""OpenMetrics HTTP scrape endpoint: one stdlib server thread per worker.

`obs.export` made exit dumps mergeable; this makes a RUNNING worker
scrapeable. Each worker starts one `MetricsHttpServer` (a
`ThreadingHTTPServer` on its own daemon thread — stdlib only, no
framework) serving:

* ``GET /metrics``  — the live `Metrics` rendered by
  `export.prometheus_text` (histogram buckets included), with a
  per-worker ``member`` label so a Prometheus scraping the whole fleet
  can tell the series apart. Content-Type is the Prometheus text
  exposition type. When the rtrace plane is armed the read/write
  latency histograms carry OpenMetrics exemplars (``#
  {trace_id="..."}``) pointing at the stored request trace behind the
  worst observed latency.
* ``GET /healthz``  — `{"ok": true, "member": ..., "uptime_s": ...}`,
  the liveness probe a supervisor or k8s deployment points at. With a
  ``health_extra`` callable installed, the doc gains serving-readiness
  fields (max peer staleness, applied watermark, overlap queue depth,
  serve-plane snapshot seq) so a load balancer can drain a worker whose
  replica lags instead of routing stale reads to it.
* ``POST /query``   — the serve plane's HTTP surface: the request body
  is the canonical query payload, the response the canonical answer
  bytes (byte-identical to the tcp ``{query}`` frame and the bridge op
  for the same request). 404 until a handler is installed.
* ``POST /write``   — the ingest plane's HTTP surface: the body
  is the canonical write payload (bare JSON or a ``CCRF`` range frame),
  the response the canonical tiered ack bytes — byte-identical to the
  tcp ``{write}`` frame and the bridge op. 404 until installed.

Both POST surfaces carry an rtrace ``"trace"`` context in the request
doc and the ``"rtrace"`` echo in the response opaquely — the body bytes
are handed to the plane verbatim, so request tracing works identically
over HTTP, tcp, sim, and the bridge.

Failure behavior mirrors the transports' "degrade, never hang" rule: a
snapshot/render failure returns a 500 with the error text — the scrape
fails loudly, the NEXT scrape sees a clean registry (`Metrics.snapshot`
hands out copies under its lock, so a failed render can never corrupt
the live counters), and request handling stays bounded by the socket
timeout.

Workers opt in via ``CCRDT_HTTP_PORT`` (`install_from_env` — same
supervisor->worker env propagation as ``CCRDT_FAULTS`` /
``CCRDT_OBS_DIR``). Port ``0`` asks the kernel for a free port; the
bound address is dropped as ``http-<member>`` into `addr_dir` (atomic
replace, like the TCP drill's ``addr-<member>`` rendezvous files) so
the supervisor can discover scrape targets it spawned with port 0.
"""

from __future__ import annotations

import http.server
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

from . import export as obs_export

ENV_PORT = "CCRDT_HTTP_PORT"

# The classic Prometheus text exposition content type (version 0.0.4 is
# what every Prometheus accepts; the OpenMetrics negotiation upgrade is
# backward compatible with this payload).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHttpServer:
    """Serve one worker's metrics over HTTP from a daemon thread.

    `source` is a `Metrics` instance or a zero-arg callable returning
    one (or a snapshot dict) — called per scrape, so the text always
    reflects the registry at scrape time."""

    def __init__(
        self,
        source: Union[Any, Callable[[], Any]],
        member: str,
        host: str = "127.0.0.1",
        port: int = 0,
        labels: Optional[Dict[str, str]] = None,
        query_handler: Optional[Callable[[bytes], bytes]] = None,
        health_extra: Optional[Callable[[], Dict[str, Any]]] = None,
        write_handler: Optional[Callable[[bytes], bytes]] = None,
    ):
        self.member = member
        self._source = source
        self._labels = dict(labels) if labels else {"member": member}
        self._t0 = time.time()
        self.query_handler = query_handler
        self.write_handler = write_handler
        self.health_extra = health_extra
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # Bound per-request: a wedged scraper releases the handler
            # thread instead of pinning it forever.
            timeout = 10.0

            def do_GET(self):  # noqa: N802 - http.server API
                if self.path.split("?", 1)[0] == "/metrics":
                    outer._serve_metrics(self)
                elif self.path.split("?", 1)[0] == "/healthz":
                    outer._serve_health(self)
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.split("?", 1)[0]
                if path == "/query":
                    outer._serve_query(self)
                elif path == "/write":
                    outer._serve_write(self)
                else:
                    self._reply(404, b"not found\n", "text/plain")

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam worker stdout

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._srv = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name=f"ccrdt-http-{member}",
            daemon=True,
        )

    # -- handlers ----------------------------------------------------------

    def _snapshot_source(self) -> Any:
        return self._source() if callable(self._source) else self._source

    def _serve_metrics(self, handler) -> None:
        try:
            text = obs_export.prometheus_text(
                self._snapshot_source(), labels=self._labels
            )
        except Exception as e:  # noqa: BLE001 — degrade to an error
            # response; the registry itself is untouched (snapshot() is
            # a copy) and the next scrape starts clean.
            handler._reply(
                500, f"# scrape failed: {e}\n".encode("utf-8"), "text/plain"
            )
            return
        handler._reply(200, text.encode("utf-8"), CONTENT_TYPE)

    def _serve_health(self, handler) -> None:
        doc = {
            "ok": True,
            "member": self.member,
            "pid": os.getpid(),
            "uptime_s": round(time.time() - self._t0, 3),
        }
        extra = self.health_extra
        if extra is not None:
            try:
                doc.update(extra())
            except Exception as e:  # noqa: BLE001 — a broken readiness
                # probe must not take liveness down with it; flag it.
                doc["health_extra_error"] = str(e)
        handler._reply(
            200, (json.dumps(doc) + "\n").encode("utf-8"), "application/json"
        )

    def _serve_query(self, handler) -> None:
        fn = self.query_handler
        if fn is None:
            handler._reply(404, b"no serve plane\n", "text/plain")
            return
        try:
            n = int(handler.headers.get("Content-Length", "0"))
            body = handler.rfile.read(n) if n > 0 else b""
            resp = bytes(fn(body))
        except Exception as e:  # noqa: BLE001 — degrade to an error
            # response; the plane's registry/caches are lock-protected
            # and the next query starts clean.
            handler._reply(
                500, f"query failed: {e}\n".encode("utf-8"), "text/plain"
            )
            return
        handler._reply(200, resp, "application/json")

    def _serve_write(self, handler) -> None:
        fn = self.write_handler
        if fn is None:
            handler._reply(404, b"no ingest plane\n", "text/plain")
            return
        try:
            n = int(handler.headers.get("Content-Length", "0"))
            body = handler.rfile.read(n) if n > 0 else b""
            resp = bytes(fn(body))
        except Exception as e:  # noqa: BLE001 — degrade to an error
            # response; the writer retries idempotently by write_id.
            handler._reply(
                500, f"write failed: {e}\n".encode("utf-8"), "text/plain"
            )
            return
        handler._reply(200, resp, "application/json")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "MetricsHttpServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def write_addr_file(addr_dir: str, member: str, addr: Tuple[str, int]) -> str:
    """Drop ``http-<member>`` = "host:port" (atomic replace) so a
    supervisor can discover a port-0 endpoint; returns the path."""
    os.makedirs(addr_dir, exist_ok=True)
    path = os.path.join(addr_dir, f"http-{member}")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{addr[0]}:{addr[1]}")
    os.replace(tmp, path)
    return path


def read_addr_files(addr_dir: str) -> Dict[str, Tuple[str, int]]:
    """{member: (host, port)} for every ``http-<member>`` drop in a dir
    (torn writes skipped — the next poll sees them whole)."""
    out: Dict[str, Tuple[str, int]] = {}
    try:
        names = os.listdir(addr_dir)
    except OSError:
        return out
    for fn in names:
        if not fn.startswith("http-") or ".tmp" in fn:
            continue
        try:
            with open(os.path.join(addr_dir, fn)) as f:
                host, port = f.read().strip().rsplit(":", 1)
            out[fn[len("http-"):]] = (host, int(port))
        except (OSError, ValueError):
            continue
    return out


def install_from_env(
    source: Any,
    member: str,
    env: Optional[Dict[str, str]] = None,
    addr_dir: Optional[str] = None,
    query_handler: Optional[Callable[[bytes], bytes]] = None,
    health_extra: Optional[Callable[[], Dict[str, Any]]] = None,
    write_handler: Optional[Callable[[bytes], bytes]] = None,
) -> Optional[MetricsHttpServer]:
    """Start a metrics endpoint iff ``CCRDT_HTTP_PORT`` is set (port 0 =
    kernel-assigned). Returns the running server, or None when the env
    var is absent/unparseable — workers call this unconditionally, like
    `faults.install_from_env`. With `addr_dir`, the bound address is
    dropped as ``http-<member>`` for supervisor discovery."""
    raw = (env if env is not None else os.environ).get(ENV_PORT)
    if raw is None or raw == "":
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    srv = MetricsHttpServer(
        source,
        member,
        port=port,
        query_handler=query_handler,
        health_extra=health_extra,
        write_handler=write_handler,
    ).start()
    if addr_dir:
        write_addr_file(addr_dir, member, srv.address)
    return srv
