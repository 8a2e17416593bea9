"""Admission-webhook pod intake: the reference's primary intake path.

The port's own copy of ``k8s1m_tpu/control/webhook.py``.  The HTTP
threads run only host code (the admission decision, ``pod_priority_of``,
the sink); the sink, ``Coordinator.submit_external``, appends to a locked
staging list, so every launch and scatter stays on the coordinator's
thread and stream.

The reference feeds pods to the scheduler through a ValidatingWebhook —
the apiserver POSTs an AdmissionReview to the leader's ``/validate``
endpoint, which always allows and enqueues pods whose schedulerName
matches (reference pkg/webhook/webhook.go:71-126).  It exists because
the fieldSelector pod watch stalled for tens of seconds above ~5K pods/s
(reference README.adoc:684-695): admission fires *before* the write is
persisted, shaving the store round-trip off schedule latency.

Same contract here: ``WebhookServer`` accepts AdmissionReview v1 JSON,
always allows, and hands matching pods to a sink (the coordinator's
``submit_external``).  A webhook-intake pod carries no mod revision yet
(the object isn't persisted at admission time), so the bind path resolves
the current revision at bind time; the store-watch intake remains the
fallback — a pod whose webhook delivery was lost still arrives via watch
(intake is deduplicated by pod key).

Two robustness layers on top (see k8s1m_tpu_torch/loadshed):

- **Admission control**: with a ``controller`` (loadshed
  HealthController) installed, pods our scheduler would claim are
  admission-checked *before* the response — past the overload
  watermarks the answer is HTTP 429 with ``Retry-After``, lowest
  ``spec.priority`` shed first.  This is the same contract
  kube-apiserver priority-and-fairness gives webhook-fronted intake:
  clients see explicit backpressure with a retry hint, never a
  timeout.  "Always allow" still holds for everything the scheduler
  does NOT claim (foreign schedulerName, already-bound pods) — a shed
  scheduler must not veto unrelated admissions.
- **Connection hygiene**: every accepted connection carries a socket
  timeout (``request_timeout_s``), so a stalled client cannot pin a
  ThreadingHTTPServer thread forever — an overload vector admission
  control alone would leave open.

TLS: the reference terminates TLS with terraform-provisioned certs
(dist-scheduler.tf:713-740); pass ``ssl_context`` to match, or run plain
HTTP behind a trusted boundary.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from k8s1m_tpu_torch.config import DEFAULT_SCHEDULER
from k8s1m_tpu_torch.control.objects import pod_key_str_of_obj
from k8s1m_tpu_torch.obs.metrics import Counter
from k8s1m_tpu_torch.obs.podtrace import NULL_TRACER
from k8s1m_tpu_torch.ops.priority import pod_priority_of

log = logging.getLogger("k8s1m.webhook")

_REQUESTS = Counter(
    "webhook_requests_total", "AdmissionReview requests", ("outcome",)
)


def review_response(uid: str) -> bytes:
    return json.dumps(
        {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "response": {"uid": uid, "allowed": True},
        },
        separators=(",", ":"),
    ).encode()


class WebhookServer:
    """Threaded HTTP server for ``POST /validate``.

    ``sink(pod_obj: dict)`` is called for every admitted pod with our
    schedulerName and no nodeName; it must be thread-safe (the
    coordinator's submit_external only appends to a locked queue).
    With a ``controller`` the call becomes ``sink(obj, admitted=True)``
    — admission already ran here, and the marker travels out-of-band so
    the pod object itself stays canonical.
    """

    def __init__(
        self,
        sink,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        scheduler_name: str = DEFAULT_SCHEDULER,
        ssl_context=None,
        # Overload admission (loadshed.HealthController); None
        # preserves the historical always-allow behavior.
        controller=None,
        # Per-connection socket timeout: a stalled client gets dropped
        # instead of pinning a handler thread indefinitely.
        request_timeout_s: float = 30.0,
        # Per-pod lifecycle tracing (obs/podtrace.py): a sampled pod's
        # trace opens HERE, at webhook receipt — the earliest intake
        # timestamp the system observes — so the admit span covers the
        # admission decision itself.  None = the null tracer (free).
        tracer=None,
    ):
        self.sink = sink
        self.scheduler_name = scheduler_name
        self.controller = controller
        self.tracer = tracer if tracer is not None else NULL_TRACER
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # StreamRequestHandler applies this to the connection in
            # setup(); handle_one_request treats the resulting timeout
            # as a dropped connection.
            timeout = request_timeout_s

            def log_message(self, fmt, *args):  # route through logging
                log.debug(fmt, *args)

            def do_POST(self):
                if self.path.split("?")[0] != "/validate":
                    self.send_error(404)
                    _REQUESTS.inc(outcome="not_found")
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    review = json.loads(self.rfile.read(length))
                    req = review["request"]
                    uid = req.get("uid", "")
                    obj = req.get("object") or {}
                except Exception:
                    # 400 is the contract for malformed reviews, but the
                    # parse failure itself must stay diagnosable.
                    log.debug("malformed AdmissionReview", exc_info=True)
                    self.send_error(400)
                    _REQUESTS.inc(outcome="bad_request")
                    return
                spec = obj.get("spec", {})
                claimed = (
                    obj.get("kind") == "Pod"
                    # Unset schedulerName = "default-scheduler" (upstream
                    # semantics): only explicitly-marked pods are claimed,
                    # matching the reference's intake filter
                    # (webhook.go:102-125) and decode_pod_obj.
                    and spec.get("schedulerName") == outer.scheduler_name
                    and not spec.get("nodeName")
                )
                if claimed and outer.controller is not None:
                    # Tenancy-aware controllers (tenancy.FairAdmission)
                    # derive the tenant from the object and shed per
                    # tenant; the plain HealthController keeps the
                    # priority-only global form.
                    admit_obj = getattr(outer.controller, "admit_obj", None)
                    if admit_obj is not None:
                        allowed = admit_obj(obj, point="webhook")
                    else:
                        allowed = outer.controller.admit(
                            pod_priority_of(obj), point="webhook"
                        )
                else:
                    allowed = True
                if not allowed:
                    # Overload shed: explicit backpressure with a retry
                    # hint (the kube-apiserver priority-and-fairness
                    # answer), never a hang or a silent drop.
                    _REQUESTS.inc(outcome="shed")
                    self.send_response(429)
                    self.send_header(
                        "Retry-After",
                        str(max(1, round(outer.controller.retry_after_s()))),
                    )
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                # Allow — admission must never block the write path
                # (the reference responds before even parsing the pod,
                # webhook.go:102-125).
                body = review_response(uid)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                if claimed:
                    _REQUESTS.inc(outcome="enqueued")
                    tracer = outer.tracer
                    key = ""
                    if tracer.enabled:
                        # Open the trace at webhook receipt — the
                        # earliest intake timestamp the system sees
                        # (only for pods we actually claim: a foreign
                        # scheduler's pod must not hold a live trace
                        # that can never close).
                        key = pod_key_str_of_obj(obj)
                        tracer.begin(
                            key, time.perf_counter(), source="webhook",
                        )
                    try:
                        if outer.controller is not None:
                            # This pod already passed admission here —
                            # the sink must not draw (and count) a
                            # second decision.  Out-of-band kwarg, never
                            # a key smuggled into the pod object (a sink
                            # that persists the object must store the
                            # canonical bytes).
                            outer.sink(obj, admitted=True)
                        else:
                            outer.sink(obj)
                    except Exception:
                        if tracer.enabled:
                            # The pod never reached the queue: close
                            # the receipt-anchored chain or it pins a
                            # live-trace slot forever (max_live leak).
                            tracer.finish(
                                key, "requeue", outcome="sink_error",
                            )
                        log.exception("webhook sink failed")
                else:
                    _REQUESTS.inc(outcome="ignored")

        if ssl_context is None:
            self._httpd = ThreadingHTTPServer((host, port), Handler)
        else:
            # Wrap per-connection with the handshake deferred into the
            # handler thread (the pattern of the JAX obs/http.py): wrapping the
            # LISTENING socket runs the TLS handshake inside the
            # serve_forever accept loop, so one client stalling
            # mid-handshake would block every later admission — the
            # exact thread-pinning vector request_timeout_s exists to
            # close.  The pre-wrap settimeout bounds the handshake
            # itself (Handler.timeout only applies after setup()).
            class TLSServer(ThreadingHTTPServer):
                def get_request(self):
                    sock, addr = super().get_request()
                    sock.settimeout(min(10.0, request_timeout_s))
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
                    # (ssl.SSLError is an OSError subclass); anything
                    # else is OUR bug and must not vanish.
                    import sys

                    if not isinstance(sys.exc_info()[1], OSError):
                        super().handle_error(request, client_address)

            self._httpd = TLSServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="webhook", daemon=True
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "WebhookServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
