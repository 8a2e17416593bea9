"""The port's sampling profiler report (``k8s1m_tpu_torch/obs/profiler.py``)
against the JAX package's, and its read of the stack table while the sampler
thread inserts into it.

``report()`` folds ``stacks`` three times (self time, cumulative time, the
collapsed table).  The sampler thread adds a key whenever a new stack shows
up, so a report that walks the live table can meet an insert in the middle
of a walk and raise ``RuntimeError: dictionary changed size during
iteration``.  The port's report reads one snapshot taken under the lock the
sampler holds around its inserts.  Tolerance: exact equality.
"""

import _torch_cpu  # noqa: F401  (bounds torch's CPU threads first)

import collections
import sys
import threading

import pytest

from k8s1m_tpu.obs.profiler import SamplingProfiler as JaxProfiler
from k8s1m_tpu_torch.obs.profiler import SamplingProfiler

# A fixed stack table: shared leaves, shared callers, ties in both tables.
STACKS = {
    "main (a.py:1);loop (a.py:9);wave (c.py:40)": 40,
    "main (a.py:1);loop (a.py:9);bind (c.py:80)": 25,
    "main (a.py:1);loop (a.py:9);wave (c.py:40);greedy (g.py:7)": 25,
    "main (a.py:1);idle (a.py:3)": 7,
    "feed (h.py:2);encode (h.py:30)": 3,
}


class _ArrivingStacks(collections.Counter):
    """A stack table whose walks meet an insert: after a walk yields its
    first entry, a new stack arrives, as the sampler thread adds one.  The
    C-level copy (``dict(table)``) is left alone, like any single step the
    sampler cannot interleave with."""

    def __init__(self, *args):
        super().__init__(*args)
        self.arrivals = 0

    def _arrive(self, view):
        for i, item in enumerate(view):
            yield item
            if i == 0:
                self.arrivals += 1
                self[f"new (n.py:{self.arrivals})"] += 1

    def items(self):
        return self._arrive(super().items())

    def values(self):
        return self._arrive(super().values())


def _fixed(cls, stacks):
    prof = cls(hz=97.0)
    prof.stacks.update(stacks)
    prof.samples, prof.wall_s, prof.started_at = 97, 1.25, 1700000000.0
    return prof


@pytest.mark.parametrize("top", [1, 3, 25])
def test_report_matches_jax_on_fixed_stacks(top):
    """Keys, top-N order (ties in first-seen order) and percentages equal the
    JAX report's on the same table."""
    got = _fixed(SamplingProfiler, STACKS).report(top)
    want = _fixed(JaxProfiler, STACKS).report(top)
    assert got == want
    assert list(got) == ["samples", "thread_samples", "wall_s", "started_at", "top_self",
                         "top_cumulative", "collapsed"]
    assert [r["frame"] for r in got["top_self"]] == [
        "wave (c.py:40)", "bind (c.py:80)", "greedy (g.py:7)", "idle (a.py:3)",
        "encode (h.py:30)"][:top]
    assert got["top_cumulative"][0] == {"frame": "main (a.py:1)", "pct": 97.0, "n": 97}
    assert list(got["collapsed"].values()) == sorted(STACKS.values(), reverse=True)


def test_report_reads_one_snapshot_while_stacks_arrive(tmp_path):
    """An insert in the middle of a walk of the live table raises in the
    report; the port's report and dump read one snapshot instead, and the
    late stack shows up in the next report."""
    prof = _fixed(SamplingProfiler, {})
    prof.stacks = _ArrivingStacks(STACKS)
    rep = prof.report(top=25)
    assert rep["thread_samples"] == sum(STACKS.values())
    assert rep["collapsed"] == dict(collections.Counter(STACKS).most_common())
    prof.stacks["late (n.py:0)"] += 1
    assert "late (n.py:0)" in prof.report()["collapsed"]
    assert prof.dump(str(tmp_path / "p.json")).endswith("p.json")
    assert prof.format_top().startswith("profile:")


def _deep(n, stop):
    if n:
        return _deep(n - 1, stop)
    stop.wait(0.0005)
    return n


def test_reports_taken_while_the_sampler_runs():
    """A live sampler at 1 kHz over a thread whose stack depth keeps changing
    (every tick can bring a new stack), with a short switch interval: 300
    reports all succeed and each counts no more than the table holds."""
    stop = threading.Event()

    def churn():
        i = 0
        while not stop.is_set():
            _deep(i % 40, stop)
            i += 1

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    worker = threading.Thread(target=churn, name="stack-churn", daemon=True)
    prof = SamplingProfiler(hz=1000.0)
    try:
        worker.start()
        prof.start()
        for _ in range(300):
            rep = prof.report(top=5)
            assert rep["thread_samples"] == sum(rep["collapsed"].values()) or not rep["collapsed"]
    finally:
        prof.stop()
        stop.set()
        sys.setswitchinterval(old)
        worker.join(timeout=5)
    assert not worker.is_alive()
