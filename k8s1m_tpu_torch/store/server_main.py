"""CLI bootstrap for the etcd-compatible store server (the port's copy of
``k8s1m_tpu/store/server_main.py``).

Mirrors the reference's flags (reference mem_etcd/src/main.rs:60-81):

    python -m k8s1m_tpu_torch.store.server_main \\
        --port 2379 --metrics-port 9000 \\
        --wal-dir /var/lib/memstore --wal-default buffered \\
        --wal-no-write-prefix /registry/leases/

The server is the native front-end (``--wire native``, the default:
``WireFront``, HTTP/2, HPACK and the etcd protobuf subset in C++) or the
asyncio etcd server (``--wire asyncio``: ``store/etcd_server.py`` on
``store/wire_server.py``, gRPC in Python with no ``grpcio``), either over the
port's ``MemStore``.  Nothing falls back from one wire to the other: a
server that cannot start exits non-zero.  The first line on stdout is the
bound port, so a caller can pass ``--port 0`` and read it back.  SIGTERM or
SIGINT stops the server and closes the store (its write-ahead log flushed).
``--metrics-port N`` (not 0) serves the process's metrics registry as
Prometheus text on ``http://127.0.0.1:N/metrics`` (``obs/http.py``; the
store gauges of ``etcd_server.py`` are registered on either wire, and fed
on the asyncio one); the port's default is 0, off.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import logging
import os
import select
import signal
import subprocess
import sys
import threading

from k8s1m_tpu_torch.obs.http import start_metrics_server
from k8s1m_tpu_torch.store.etcd_server import serve
from k8s1m_tpu_torch.store.native import MemStore, WireFront


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="etcd-compatible in-memory store (port)")
    ap.add_argument("--port", type=int, default=2379)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics on 127.0.0.1:PORT (0 = off)")
    ap.add_argument("--wal-dir", default=None)
    ap.add_argument("--wal-default", choices=["none", "buffered", "fsync"],
                    default="buffered")
    ap.add_argument("--wal-no-write-prefix", action="append", default=[],
                    help="prefixes whose writes skip the WAL (e.g. /registry/leases/)")
    ap.add_argument("--wire", choices=["asyncio", "native"], default="native",
                    help="wire implementation: the C++ front-end (native/wirefront) "
                    "or the asyncio gRPC server (store/wire_server.py)")
    ap.add_argument("--wire-threads", type=int, default=1,
                    help="event-loop threads for --wire native")
    return ap.parse_args(argv)


async def _serve_asyncio(args, store: MemStore) -> None:
    """The asyncio lane: serve until SIGTERM or SIGINT."""
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    server, port = await serve(store, port=args.port, host=args.host,
                               metrics_port=args.metrics_port)
    try:
        print(port, flush=True)
        logging.info("memstore serving etcd API on :%d via the asyncio server "
                     "(metrics :%d)", port, args.metrics_port)
        await stop.wait()
    finally:
        await server.stop()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    store = MemStore(wal_dir=args.wal_dir, wal_mode=args.wal_default,
                     no_write_prefixes=tuple(args.wal_no_write_prefix))
    if args.wire == "asyncio":
        try:
            asyncio.run(_serve_asyncio(args, store))
        finally:
            store.close()
        sys.stdout.flush()
        return
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    metrics = None
    try:
        wf = WireFront(store, host=args.host, port=args.port, threads=args.wire_threads)
        try:
            if args.metrics_port:
                metrics = start_metrics_server(args.metrics_port)
            print(wf.port, flush=True)
            logging.info("memstore serving etcd API on :%d via native wirefront "
                         "(metrics :%d)", wf.port, args.metrics_port)
            # The C++ loops serve; this thread only waits for the signal.
            while not stop.wait(1.0):
                pass
        finally:
            if metrics is not None:
                metrics.shutdown()
                metrics.server_close()
            wf.close()
    finally:
        store.close()
    sys.stdout.flush()


def child_env() -> tuple[str, dict]:
    """The repository root and an environment with it first on
    ``PYTHONPATH``: a child started as ``python -m k8s1m_tpu_torch...`` from
    that root finds the port whatever the caller's directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return root, env


@contextlib.contextmanager
def serve_subprocess(*extra_args: str):
    """Run this server in a child process on a free port of 127.0.0.1, with
    ``extra_args`` appended to its command line (``"--metrics-port",
    "9000"``); yields ``(process, "127.0.0.1:port")``.  A server that does not report
    its port within two minutes (a first run builds ``libmemstore.so``)
    fails the caller; on every exit path the child is terminated (killed
    if it lingers) and reaped."""
    root, env = child_env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "k8s1m_tpu_torch.store.server_main", "--port", "0",
         "--host", "127.0.0.1", "--wal-default", "none", *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=root)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120.0)
        line = proc.stdout.readline().strip() if ready else ""
        if not line.isdigit():
            raise RuntimeError(f"store server did not start (exit code {proc.poll()}, "
                               f"first line {line!r})")
        yield proc, f"127.0.0.1:{line}"
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        proc.stdout.close()


if __name__ == "__main__":
    main()
