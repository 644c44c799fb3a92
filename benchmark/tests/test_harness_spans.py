"""The readers of the program's own spans and counters
(`program_spans.py`, `metrics/`): the share of the window the device idles
while the launching thread is in a program span, on a trace written here;
span means cut to the traced window; None from a program without the
store; and a traced MD run on the CPU that prints the span metrics."""

import json
import sys
import types

import pytest
import torch

from benchmark import program_spans, run
from benchmark.tests import tiny
from benchmark.tracing import WINDOW, Trace

OFFSET_US = 7.0e11  # the trace's clock minus the program's
MAIN, WORKER = 1, 2


def _rec(name, start_us, end_us, thread=MAIN, parent=None):
    """A program record at trace times (µs), on the program's clock (ns)."""
    from gemnet_pytorch_tpu_torch.perf.spans import Record
    return Record(name, thread, round((start_us - OFFSET_US) * 1e3),
                  round((end_us - OFFSET_US) * 1e3), parent, None)


def _trace(tmp_path, kernels, ranges, window=1000):
    """A chrome trace of a `window` µs window from OFFSET_US + 1000, with
    device kernels and benchmark ranges at offsets (µs) into it."""
    t0 = OFFSET_US + 1000
    events = [{"name": WINDOW, "cat": "user_annotation", "ph": "X", "ts": t0, "dur": window}]
    events += [{"name": f"bench.{n}", "cat": "user_annotation", "ph": "X", "ts": t0 + s,
                "dur": e - s} for s, e, n in ranges]
    events += [{"name": "k", "cat": "kernel", "ph": "X", "ts": t0 + s, "dur": e - s}
               for s, e in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace(str(path))


def test_host_bound_pct(tmp_path):
    t0 = OFFSET_US + 1000
    trace = _trace(tmp_path, kernels=[(0, 100), (300, 400), (600, 1000)],
                   ranges=[(50, 260, "step_host"), (450, 560, "step_host")])
    recs = [
        _rec("train.step", t0 + 50, t0 + 250),  # 100-250 of the gap 100-300
        _rec("replay", t0 + 60, t0 + 70, parent="train.step"),
        _rec("train.step", t0 + 450, t0 + 550),  # all 100 inside the gap 400-600
        _rec("pad", t0 + 100, t0 + 600, thread=WORKER),  # another thread: not counted
    ]
    assert program_spans.offset_us(recs, trace.host)[1] == MAIN
    assert program_spans.host_bound_pct_of(recs, trace) == pytest.approx(25.0, abs=1e-6)
    # no device events: nothing to read
    bare = _trace(tmp_path, kernels=[], ranges=[(40, 260, "step_host")])
    assert program_spans.host_bound_pct_of(recs[:1], bare) is None


def test_slipped_pairs_place_nothing(tmp_path):
    """One `data.wait` span too many (its range missed): the tail pairs
    `data.wait` with the range of the step before, no offset keeps every
    span in its range, and no reader gets a clock."""
    t0 = OFFSET_US + 1000
    steps = [(1000 * i, 1000 * i + 900) for i in range(8)]  # 1 ms steps (30 ms and up on the card)
    ranges = [(s, s + 10, "data_wait") for s, _ in steps]
    ranges += [(s + 10, e, "step_host") for s, e in steps]
    trace = _trace(tmp_path, kernels=[(0, 8000)], ranges=ranges, window=8000)
    recs = []
    for s, e in steps:
        recs += [_rec("data.wait", t0 + s + 2, t0 + s + 8),
                 _rec("train.step", t0 + s + 12, t0 + e - 2)]
    off, thread = program_spans.offset_us(recs, trace.host)
    assert abs(off - OFFSET_US) <= 2 and thread == MAIN
    slipped = recs + [_rec("data.wait", t0 + 8002, t0 + 8008)]  # no range of its own
    assert program_spans.offset_us(slipped, trace.host) is None
    assert program_spans.host_bound_pct_of(slipped, trace) is None


def test_span_means_cut_to_the_window(tmp_path, monkeypatch):
    t0 = OFFSET_US + 1000
    trace = _trace(tmp_path, kernels=[(0, 1000)], ranges=[(40, 260, "step_host")])
    recs = [_rec("pad", t0 - 500, t0 - 100, thread=WORKER),  # before the window
            _rec("train.step", t0 + 50, t0 + 250),
            _rec("pad", t0 + 300, t0 + 340, thread=WORKER),
            _rec("pad", t0 + 400, t0 + 460, thread=WORKER),
            _rec("pad", t0 + 900, t0 + 1500, thread=WORKER)]  # outlasts the window
    fake = types.SimpleNamespace(records=lambda: recs,
                                 counters=lambda: {"pad.real_rows": 30.0,
                                                   "pad.padded_rows": 40.0, "capture_s": 2.5})
    monkeypatch.setattr(program_spans, "store", lambda: fake)
    r = run.Run(None, {}, trace)
    assert run.reader("pad_ms.train")(r) == pytest.approx(0.05)
    assert run.reader("pack_ms.train")(r) is None
    assert run.reader("pad_fill_pct.md")(r) == pytest.approx(75.0)
    assert run.reader("capture_s.setup")(r) == 2.5
    assert run.reader("host_bound_pct.train")(r) == pytest.approx(0.0, abs=1e-6)


NEW = ("graph_build_ms.md", "pad_ms.md", "pack_ms.md", "md_fetch_ms.md",
       "host_bound_pct.md", "capture_s.setup", "pad_fill_pct.md")


def test_no_store_reads_none(tmp_path, monkeypatch):
    """A program without `perf/spans.py` (the parent of the change that
    added it): every reader of it returns None and raises nothing."""
    monkeypatch.setitem(sys.modules, "gemnet_pytorch_tpu_torch.perf.spans", None)
    assert program_spans.store() is None
    trace = _trace(tmp_path, kernels=[(0, 100)], ranges=[(40, 260, "calculate")])
    assert all(run.reader(name)(run.Run(None, {}, trace)) is None for name in NEW)


def test_traced_md_run_reads_the_program_spans():
    torch.set_num_threads(2)
    r = run.run("t-md-cluster", 2**31 + 5, 0.3, True, device="cpu",
                overrides=tiny.overrides("t-md-cluster"))
    got = set(r["metrics"])
    # on the CPU the calculator predicts eagerly (no pack, upload or replay)
    # and the trace has no device events
    assert {"graph_build_ms.md", "pad_ms.md", "md_fetch_ms.md", "pad_fill_pct.md"} <= got
    assert not got & {"pack_ms.md", "host_bound_pct.md"}
    assert all(r["metrics"][k]["value"] > 0 for k in got)
    assert 0 < r["metrics"]["pad_fill_pct.md"]["value"] <= 100
