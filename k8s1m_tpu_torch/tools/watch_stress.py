"""N concurrent watches measuring event delivery rates: the apiserver-stress
equivalent (reference apiserver-stress/src/main.rs:54-97: N watchers
against the apiserver count events/s to expose watch amplification, 18M
watches at 1M nodes, README.adoc:410-416).  The port's copy of
``k8s1m_tpu/tools/watch_stress.py`` on the port's wire transport, with
threads instead of asyncio.

    python -m k8s1m_tpu_torch.tools.watch_stress --watchers 100 --writes 10000

One connection carries the watches (each its own HTTP/2 stream, counted
on the connection's reader thread as the events arrive) and one the
writers.  Every watcher sees every write: the run ends when ``watchers x
writes`` events were delivered (waiting at most 30 s after the last
write), or at SIGTERM/SIGINT, which stops the writers, waits up to 5 s for
the events of the writes made so far, and reports.  The writers start
once the server has confirmed every watch.  A stream that fails is
counted in ``stream_errors``, never logged.  The report is one JSON line
on stdout (``--quiet`` keeps stdout empty), with the fewest and the most
events one watcher saw.

``--prefix`` watches another prefix (the writers write there too), and
``--writes 0`` only watches: the watchers count what others write under
the prefix until SIGTERM/SIGINT, then wait up to 30 s for every watcher to
have seen ``--expect-events`` events, and report.  That is how a client
population watches, say, ``/registry/pods/`` through a watch-cache tier
while a scheduler writes there.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time

from k8s1m_tpu_torch.store.native import prefix_end
from k8s1m_tpu_torch.store.proto import codec as pb
from k8s1m_tpu_torch.store.remote import RemoteStore
from k8s1m_tpu_torch.store.wire import Channel, StatusCode, WireError

PREFIX = b"/stress/watched/"
_WATCH = "/etcdserverpb.Watch/Watch"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="concurrent watch stress (port)")
    ap.add_argument("--target", default="127.0.0.1:2379")
    ap.add_argument("--watchers", type=int, default=50)
    ap.add_argument("--writes", type=int, default=1000)
    ap.add_argument("--write-concurrency", type=int, default=50)
    ap.add_argument("--prefix", default=PREFIX.decode(),
                    help="the watched (and written) prefix")
    ap.add_argument("--expect-events", type=int, default=0,
                    help="with --writes 0: the events each watcher must see "
                    "before the report, once stopped")
    ap.add_argument("--ca-pem", default=None, help="TLS: trust this CA for --target")
    ap.add_argument("--token", default=None, help="bearer token for --target")
    ap.add_argument("--quiet", action="store_true", help="print no report")
    return ap.parse_args(argv)


class _Tally:
    """Delivered events and failed streams, counted on the reader thread."""

    def __init__(self, want: int):
        self.want = want
        self.delivered = 0
        self.per_watcher: list[int] = []
        self.created = 0
        self.stream_errors = 0
        self.closing = False
        self._lock = threading.Lock()
        self.done = threading.Event()

    def on_message_for(self, i: int):
        """The message callback of watcher ``i``."""
        self.per_watcher.append(0)

        def on_message(data: bytes) -> None:
            n = pb.count_watch_events(data)
            with self._lock:
                if n:
                    self.delivered += n
                    self.per_watcher[i] += n
                    if self.delivered >= self.want:
                        self.done.set()
                elif pb.parse_watch_response(data).created:
                    self.created += 1

        return on_message

    def on_close(self, code, _details: str) -> None:
        if not self.closing and code != StatusCode.OK:
            with self._lock:
                self.stream_errors += 1


def run(args, stop: threading.Event | None = None) -> dict:
    stop = stop or threading.Event()
    prefix = args.prefix.encode()
    watch_only = args.writes == 0
    tally = _Tally(args.watchers * (args.expect_events if watch_only else args.writes))
    watch_ch = Channel(args.target, ca_pem=args.ca_pem, token=args.token)
    writer = RemoteStore(args.target, ca_pem=args.ca_pem, token=args.token)
    streams = []
    writes = 0
    write_lock = threading.Lock()
    try:
        create = pb.WatchRequest(create_request=pb.WatchCreateRequest(
            key=prefix, range_end=prefix_end(prefix))).encode()
        for i in range(args.watchers):
            try:
                s = watch_ch.stream(_WATCH, tally.on_message_for(i), tally.on_close)
                s.send(create)
                streams.append(s)
            except WireError:
                tally.stream_errors += 1
        deadline = time.perf_counter() + 30.0
        while tally.created < len(streams) and time.perf_counter() < deadline:
            time.sleep(0.005)

        def write(wid: int) -> None:
            nonlocal writes
            for i in range(wid, args.writes, args.write_concurrency):
                if stop.is_set():
                    return
                writer.put(prefix + b"key-%06d" % (i % 100), b"x" * 64)
                with write_lock:
                    writes += 1

        t0 = time.perf_counter()
        if watch_only:
            # Others write: count until stopped, then let every watcher
            # reach --expect-events (30 s at most).
            while not stop.wait(0.1):
                pass
            deadline = time.perf_counter() + 30.0
            while (min(tally.per_watcher, default=0) < args.expect_events
                   and time.perf_counter() < deadline):
                time.sleep(0.01)
        threads = [] if watch_only else [
            threading.Thread(target=write, args=(w,), daemon=True)
            for w in range(args.write_concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        write_s = time.perf_counter() - t0
        # Every write so far reaches every watcher: wait out the deliveries
        # in flight (30 s at most, 5 s once stopped).
        deadline = time.perf_counter() + (5.0 if stop.is_set() else 30.0)
        while (tally.delivered < args.watchers * writes and not tally.done.is_set()
               and time.perf_counter() < deadline):
            tally.done.wait(0.01)
        total_s = time.perf_counter() - t0
    finally:
        tally.closing = True
        for s in streams:
            s.cancel()
        watch_ch.close()
        writer.close()
    return {
        "watchers": args.watchers,
        "writes": writes,
        "writes_per_sec": round(writes / write_s, 1) if write_s else 0.0,
        "events_delivered": tally.delivered,
        "events_per_sec": round(tally.delivered / total_s, 1) if total_s else 0.0,
        "amplification": args.watchers,
        "stream_errors": tally.stream_errors,
        "per_watcher_min": min(tally.per_watcher, default=0),
        "per_watcher_max": max(tally.per_watcher, default=0),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    report = run(args, stop)
    if not args.quiet:
        print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
