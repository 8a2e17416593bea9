"""Sampling profiler: the continuous-profiling role (Parca / pprof).

The port's own copy of ``k8s1m_tpu/obs/profiler.py`` (artifacts default
to the process's temporary directory, ``tempfile.gettempdir()``).

The reference runs a Parca server + eBPF agent fleet-wide (reference
terraform/victoriametrics/main.tf:190-236, terraform/kubernetes/
parca-agent.tf) and wires pprof + contention profiles into the
scheduler's mux (cmd/dist-scheduler/scheduler_metrics.go:68-74), so
"where do the microseconds go" is always answerable.  This is the same
capability without external agents: a wall-clock sampler over
``sys._current_frames()`` that folds stacks into collapsed-stack
format (flamegraph-compatible) plus a self-time table, cheap enough to
leave on for a whole bench window.

Three entry points:

- ``SamplingProfiler`` — start/stop around a window (sched_bench
  --profile wires it); ``report()`` returns the aggregate, ``dump()``
  writes the artifact next to the flight-recorder dumps.
- ``install_signal_dump()`` — the py-spy-dump-on-demand equivalent:
  SIGUSR2 writes every thread's current stack to a file, for attaching
  to a live coordinator that stopped making progress.
- Coordinator integration: the flight recorder's slow-cycle dump can
  carry the profiler's report (coordinator.py wires ``profiler=``), so
  a >threshold cycle leaves both the event ring AND where the time went.
"""

from __future__ import annotations

import collections
import json
import os
import signal
import sys
import tempfile
import threading
import time
import traceback

_EXCLUDE_THREADS = ("sampling-profiler",)


def _fold(frame) -> str:
    """Innermost-last collapsed stack for one thread's current frame."""
    parts: list[str] = []
    while frame is not None:
        code = frame.f_code
        name = os.path.basename(code.co_filename)
        parts.append(f"{code.co_name} ({name}:{frame.f_lineno})")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Aggregating wall-clock sampler over the interpreter's threads.

    ``target_thread_ids=None`` samples every thread except the sampler
    itself; pass a set of idents to focus (e.g. just the coordinator's
    driving thread).
    """

    def __init__(
        self,
        hz: float = 97.0,
        target_thread_ids: set[int] | None = None,
    ):
        # A prime-ish rate avoids beating against periodic work.
        self.interval = 1.0 / hz
        self.targets = target_thread_ids
        self.stacks: collections.Counter[str] = collections.Counter()
        # Held by the sampler around each tick's inserts and by report()
        # around its one copy of ``stacks``: a walk of the live table
        # would meet a new stack mid-walk and raise.
        self._lock = threading.Lock()
        self.samples = 0
        self.started_at = 0.0
        self.wall_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        # Wall stamp is report metadata; durations below use perf_counter.
        self.started_at = time.time()  # graftlint: disable=no-wall-clock
        self._t0 = time.perf_counter()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="sampling-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None
        self.wall_s = time.perf_counter() - self._t0

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            # Re-resolve the excluded set EVERY tick (names are in
            # threading.enumerate(), a cheap list walk): a profiler
            # thread started after this one would otherwise be sampled
            # as workload — its wait/fold frames accruing a full-count
            # entry per tick — because a start-time snapshot can never
            # see it.
            skip_idents = {
                t.ident for t in threading.enumerate()
                if t.name.startswith(_EXCLUDE_THREADS)
            }
            frames = sys._current_frames()
            folded = [
                _fold(frame) for ident, frame in frames.items()
                if ident != me and ident not in skip_idents
                and (self.targets is None or ident in self.targets)
            ]
            with self._lock:
                self.samples += 1
                for stack in folded:
                    self.stacks[stack] += 1

    # -- reporting ------------------------------------------------------

    def report(self, top: int = 25) -> dict:
        """Self-time and cumulative-time tables + collapsed stacks, all
        from one snapshot of ``stacks``."""
        with self._lock:
            stacks = collections.Counter(dict(self.stacks))
            samples = self.samples
        self_time: collections.Counter[str] = collections.Counter()
        cum_time: collections.Counter[str] = collections.Counter()
        for stack, n in stacks.items():
            frames = stack.split(";")
            self_time[frames[-1]] += n
            for f in set(frames):
                cum_time[f] += n
        total = sum(stacks.values()) or 1
        return {
            "samples": samples,
            "thread_samples": total,
            "wall_s": round(self.wall_s, 3),
            "started_at": self.started_at,
            "top_self": [
                {"frame": f, "pct": round(100.0 * n / total, 2), "n": n}
                for f, n in self_time.most_common(top)
            ],
            "top_cumulative": [
                {"frame": f, "pct": round(100.0 * n / total, 2), "n": n}
                for f, n in cum_time.most_common(top)
            ],
            "collapsed": dict(stacks.most_common()),
        }

    def dump(self, path: str | None = None, top: int = 25) -> str:
        """Write the report next to the flight-recorder dumps."""
        if path is None:
            # graftlint: disable=no-wall-clock (epoch-ms dump name, correlates across restarts)
            path = os.path.join(
                tempfile.gettempdir(), f"profile-{int(time.time() * 1e3)}.json"
            )
        with open(path, "w") as f:
            json.dump(self.report(top), f, indent=1)
        return path

    def format_top(self, top: int = 12) -> str:
        rep = self.report(top)
        lines = [
            f"profile: {rep['thread_samples']} samples over "
            f"{rep['wall_s']}s (self-time %)"
        ]
        for row in rep["top_self"][:top]:
            lines.append(f"  {row['pct']:6.2f}%  {row['frame']}")
        return "\n".join(lines)


def install_signal_dump(
    dump_dir: str | None = None, sig: int = signal.SIGUSR2
) -> None:
    """py-spy dump equivalent: SIGUSR2 writes every thread's stack.

    For a live process that stopped making progress — the on-demand half
    of the reference's pprof endpoint (scheduler_metrics.go:68-74).
    """

    if dump_dir is None:
        dump_dir = tempfile.gettempdir()

    def handler(signum, frame):
        path = os.path.join(
            # graftlint: disable=no-wall-clock (epoch dump name, correlates across restarts)
            dump_dir, f"stacks-{os.getpid()}-{int(time.time())}.txt"
        )
        names = {t.ident: t.name for t in threading.enumerate()}
        try:
            with open(path, "w") as f:
                for ident, fr in sys._current_frames().items():
                    f.write(f"--- thread {names.get(ident, '?')} ({ident})\n")
                    f.write("".join(traceback.format_stack(fr)))
                    f.write("\n")
        except OSError:
            pass

    signal.signal(sig, handler)
