"""What the readers of the program's own spans and counters share
(`gemnet_pytorch_tpu_torch.perf.spans`, the program's store).

The program records its spans on `time.perf_counter_ns()` while a profiler
records, which in a run is the traced stretch after the window; the
trace's events are on the profiler's clock. `offset_us` puts the first on
the second through the benchmark's ranges (`tracing.Spans`) that enclose
the program's spans on the thread that launches: the least offset that
keeps every paired span inside its range. Where no offset does (by more
than `SLACK_US`), the pairs have slipped and nothing is placed. Each
function returns None where there is nothing to read: a program without
the store, no trace, spans that cannot be placed, or no span of the name
in the traced window.
"""

from __future__ import annotations

import collections
import importlib
import statistics

# the benchmark's range around each of the program's spans on the thread
# that launches
ENCLOSING = {"md.calculate": "calculate", "train.step": "step_host", "data.wait": "data_wait"}
# microseconds by which the least offset that keeps each span past its
# range's start may exceed the most that keeps each span before its end: the
# 0.2 ms to which the alignment is held. A pair that slipped by one span
# misses by a step or more (30 ms and up).
SLACK_US = 200.0


def store():
    """The program's span module, or None where the program has none."""
    try:
        return importlib.import_module("gemnet_pytorch_tpu_torch.perf.spans")
    except ModuleNotFoundError:
        return None


def offset_us(records, host):
    """(microseconds that put a record's `start / 1e3` on the trace's clock,
    the thread of the paired spans), or None where no span pairs with a
    range or no offset keeps the pairs' spans in their ranges. `records`
    are the program's, oldest first; `host` the trace's benchmark ranges
    (`Trace.host`: start, end, name). The last spans of a name pair in
    order with the last ranges of its enclosing name."""
    lows, highs, threads = [], [], collections.Counter()
    for name, bench in ENCLOSING.items():
        spans = [r for r in records if r.name == name]
        ranges = [(s, e) for s, e, n in host if n == bench]
        k = min(len(spans), len(ranges))
        for r, (s, e) in zip(spans[len(spans) - k:], ranges[len(ranges) - k:]):
            lows.append(s - r.start / 1e3)  # the least offset that keeps r in its range
            highs.append(e - r.end / 1e3)  # the most
            threads[r.thread] += 1
    if not lows:
        return None
    lo, hi = max(lows), min(highs)
    if lo > hi + SLACK_US:
        return None
    return lo, threads.most_common(1)[0][0]


def placed(records, trace):
    """([(record, start, end)] of the records on the trace's clock
    (microseconds), the thread that launches), or None where the records
    cannot be placed."""
    found = offset_us(records, trace.host)
    if found is None:
        return None
    off, thread = found
    return [(r, r.start / 1e3 + off, r.end / 1e3 + off) for r in records], thread


def _records(run):
    """The program's records, where it has a store and the run a trace."""
    mod = store()
    return None if mod is None or run.trace is None else mod.records()


def mean_ms(run, name):
    """Mean ms of the program's spans `name` that lie in the traced window,
    in any thread (a prefetch thread's span that outlasts the window runs
    beside the work after it)."""
    records = _records(run)
    found = None if records is None else placed(records, run.trace)
    if found is None:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    v = [(r.end - r.start) / 1e6 for r, s, e in found[0]
         if r.name == name and t0 <= s and e <= t1]
    return statistics.fmean(v) if v else None


def host_bound_pct_of(records, trace):
    """% of the trace's window in which the device is idle and the thread
    that launches is inside one of the program's spans."""
    found = placed(records, trace)
    if found is None or not trace.device:
        return None
    spans, thread = found
    inside = []  # the union of the thread's spans, clipped to the window
    for _, s, e in sorted((x for x in spans if x[0].thread == thread), key=lambda x: x[1]):
        s, e = max(s, trace.t0), min(e, trace.t1)
        if inside and s <= inside[-1][1]:
            inside[-1][1] = max(inside[-1][1], e)
        elif e > s:
            inside.append([s, e])
    idle = sum(max(0.0, min(ge, e) - max(gs, s)) for gs, ge in trace.gaps() for s, e in inside)
    return 100.0 * idle / (trace.t1 - trace.t0)


def host_bound_pct(run):
    records = _records(run)
    return None if records is None else host_bound_pct_of(records, run.trace)


def counter(name):
    """The program's counter `name`, over the whole process."""
    mod = store()
    return None if mod is None else mod.counters().get(name)
