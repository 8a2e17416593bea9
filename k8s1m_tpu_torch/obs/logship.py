"""Log aggregation for multi-process cluster runs — the fluent-bit →
VictoriaLogs role at rig scale (reference terraform/kubernetes/
fluentbit.tf: every pod's stderr shipped to one queryable place).  The
port's own copy of ``k8s1m_tpu/obs/logship.py``.

A cluster run spans many processes (store server, watch-cache tier,
KWOK controllers, shard coordinators, webhook); without collection,
diagnosing a failed 1M run means stitching N interleaved stderr streams
by eye.  LogShipper funnels every process's stderr/stdout into ONE
timestamped JSONL file:

    {"ts": 1735689600.123, "src": "store", "line": "..."}

Usage (the harness wires this automatically when ClusterSpec.log_dir is
set):

    ship = LogShipper(run_dir)
    proc = subprocess.Popen(cmd, stderr=ship.pipe("store"))
    ...
    ship.close()

Each pipe() returns a real file descriptor the child inherits; a reader
thread per source timestamps lines as they arrive, so ordering in the
file reflects arrival order across the whole cluster.  The parent's own
logging can join the stream via attach_logging().
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from k8s1m_tpu_torch.lint import guarded_by


@guarded_by(
    # Reader threads emit concurrently with pipe()/close() callers; the
    # fd and reader bookkeeping used to mutate unlocked (a close racing
    # a late pipe() could leak the new fd or skip its join) — found by
    # the lint/guards.py audit, fixed by taking _lock everywhere and
    # refusing pipe() once close() has begun (_accepting).
    _f="_lock",
    _closed="_lock",
    _accepting="_lock",
    _readers="_lock",
    _write_fds="_lock",
)
class LogShipper:
    """Funnel many processes' output streams into one JSONL file."""

    def __init__(self, run_dir: str, name: str | None = None):
        os.makedirs(run_dir, exist_ok=True)
        ts = time.strftime("%Y%m%dT%H%M%S")
        self.path = os.path.join(run_dir, name or f"cluster-{ts}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)
        self._readers: list[threading.Thread] = []
        self._write_fds: list[int] = []
        # _accepting gates pipe() the moment close() begins (a pipe
        # registered after close's snapshot would leak its fd and strand
        # its reader); _closed gates emit() only after the readers have
        # drained, so the tail lines still land in the file.
        self._accepting = True
        self._closed = False

    def emit(self, src: str, line: str) -> None:
        # graftlint: disable=no-wall-clock (cross-process log correlation needs epoch time)
        rec = {"ts": round(time.time(), 3), "src": src, "line": line}
        with self._lock:
            if not self._closed:
                self._f.write(json.dumps(rec) + "\n")

    def pipe(self, src: str) -> int:
        """A write fd to hand a child as stderr/stdout; lines arriving on
        it are shipped under ``src``.  The caller (subprocess.Popen)
        closes its copy after spawn; the reader thread exits on EOF when
        the LAST process holding the fd exits."""
        r, w = os.pipe()

        def read() -> None:
            with os.fdopen(r, "r", errors="replace") as f:
                for line in f:
                    self.emit(src, line.rstrip("\n"))

        t = threading.Thread(target=read, name=f"logship-{src}", daemon=True)
        # Register AND start under one lock acquisition: close() must
        # either see nothing (and this call raises) or see a started
        # reader plus its fd (and joins/closes both) — never a half-
        # registered pipe.
        with self._lock:
            if not self._accepting:
                os.close(r)
                os.close(w)
                raise RuntimeError("LogShipper is closed")
            self._write_fds.append(w)
            self._readers.append(t)
            t.start()
        return w

    def attach_logging(self, src: str = "harness",
                       logger: logging.Logger | None = None) -> logging.Handler:
        """Route the parent's own logging records into the stream."""
        ship = self

        class _H(logging.Handler):
            def emit(self, record: logging.LogRecord) -> None:
                try:
                    ship.emit(src, self.format(record))
                # A logging handler must never raise into its caller.
                except Exception:  # graftlint: disable=broad-except
                    pass

        h = _H()
        h.setFormatter(logging.Formatter("%(levelname)s %(name)s %(message)s"))
        (logger or logging.getLogger()).addHandler(h)
        return h

    def close(self, timeout: float = 5.0) -> None:
        """Close parent-side write fds (children should have exited) and
        drain the readers."""
        # Snapshot under the lock, join outside it: the readers need the
        # lock inside emit(), so holding it across join() would deadlock.
        with self._lock:
            self._accepting = False     # no pipes registered past here
            fds, self._write_fds = self._write_fds, []
            readers = list(self._readers)
        for w in fds:
            try:
                os.close(w)
            except OSError:
                pass
        for t in readers:
            t.join(timeout=timeout)
        with self._lock:
            self._closed = True
            self._f.close()
