"""/metrics HTTP endpoint, the port's copy of ``k8s1m_tpu/obs/http.py``
(the reference serves one per component — mem_etcd's axum server on
--metrics-port, reference main.rs:83-101).

``ssl_context`` + ``basic_auth`` reproduce the reference's exposure
path: VM-level nginx reverse proxies terminate TLS and check basic-auth
before the scrape reaches the component (reference
terraform/k8s-server/server.tf:204-229).  Certs come from
a CA the caller provisions, as for the webhook.
"""

from __future__ import annotations

import base64
import hmac
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from k8s1m_tpu_torch.lint import guarded_by
from k8s1m_tpu_torch.obs.metrics import REGISTRY

# Socket timeout of every scrape connection (plain and TLS): a scraper
# that connects and stalls must not pin a ThreadingHTTPServer thread
# forever — threads are the resource an overloaded host runs out of.
REQUEST_TIMEOUT_S = 30.0
# A stalled TLS handshake's bound (the handler's timeout only applies
# after setup(), i.e. post-handshake).
HANDSHAKE_TIMEOUT_S = 10.0


@guarded_by(scrapes="_lock", denied="_lock", not_found="_lock")
class ScrapeStats:
    """Per-server scrape counters, mutated by concurrent handler threads.

    ThreadingHTTPServer runs one thread per connection, so these counts
    are exactly the shared-state shape the lint/guards.py audit checks:
    every increment and read takes ``_lock`` (int += is not atomic under
    free-threading, and torn counts in the self-monitoring endpoint are
    the kind of lie that wastes an incident hour).  Exposed as
    ``server.scrape_stats`` for harnesses and tests.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.scrapes = 0
        self.denied = 0
        self.not_found = 0

    def note(self, outcome: str) -> None:
        with self._lock:
            if outcome == "ok":
                self.scrapes += 1
            elif outcome == "denied":
                self.denied += 1
            else:
                self.not_found += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "scrapes": self.scrapes,
                "denied": self.denied,
                "not_found": self.not_found,
            }


def start_metrics_server(
    port: int,
    host: str = "127.0.0.1",
    ssl_context=None,
    basic_auth: tuple[str, str] | None = None,
) -> ThreadingHTTPServer:
    """Serve REGISTRY on /metrics.

    Runs in a daemon thread; returns the server (``.server_port`` for
    port=0 auto-assignment, ``.shutdown()`` to stop).  Every connection
    carries ``REQUEST_TIMEOUT_S`` as its socket timeout.
    """
    expected = None
    if basic_auth is not None:
        expected = "Basic " + base64.b64encode(
            f"{basic_auth[0]}:{basic_auth[1]}".encode()
        ).decode()
    stats = ScrapeStats()

    class Handler(BaseHTTPRequestHandler):
        # Applied to the connection by StreamRequestHandler.setup();
        # a read timing out drops the connection instead of hanging.
        timeout = REQUEST_TIMEOUT_S

        def do_GET(self):
            if expected is not None and not hmac.compare_digest(
                self.headers.get("Authorization", ""), expected
            ):
                stats.note("denied")
                self.send_response(401)
                self.send_header("WWW-Authenticate", "Basic realm=metrics")
                self.end_headers()
                return
            if self.path.rstrip("/") not in ("", "/metrics"):
                stats.note("not_found")
                self.send_response(404)
                self.end_headers()
                return
            stats.note("ok")
            body = REGISTRY.render()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.end_headers()
            self.wfile.write(body.encode())

        def log_message(self, *args):  # quiet
            pass

    if ssl_context is None:
        server = ThreadingHTTPServer((host, port), Handler)
    else:
        # Wrap per-connection, after accept, with the handshake deferred
        # into the handler thread — wrapping the *listening* socket runs
        # the handshake inside the serve_forever accept loop, so one
        # client stalling mid-handshake would block every later scrape.
        class TLSServer(ThreadingHTTPServer):
            def get_request(self):
                sock, addr = super().get_request()
                sock.settimeout(HANDSHAKE_TIMEOUT_S)
                return (
                    ssl_context.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False,
                    ),
                    addr,
                )

            def finish_request(self, request, client_address):
                request.do_handshake()  # in the per-connection thread
                super().finish_request(request, client_address)

            def handle_error(self, request, client_address):
                # Failed/stalled handshakes are the client's problem
                # (ssl.SSLError is an OSError subclass); anything else
                # is OUR bug and must not vanish.
                import sys

                if not isinstance(sys.exc_info()[1], OSError):
                    super().handle_error(request, client_address)

        server = TLSServer((host, port), Handler)
    server.daemon_threads = True
    server.scrape_stats = stats
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
