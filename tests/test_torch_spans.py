"""The port's spans and counters (`perf.spans`) on the CPU: off, a span
records nothing and costs under a microsecond; under a `torch.profiler` the
provider's prefetch threads record their batch's spans with its sequence
number and no parent from the consumer's thread, the profiling thread's
spans are `gemnet.*` ranges of the chrome trace, and nested spans take
their parent and id; `pad_batch` counts real and padded rows and
`graphs.capture` counts its captures and their seconds; the benchmark's
alignment (`benchmark/program_spans.py`) puts the program's spans on the
trace's clock, inside the benchmark's ranges around them."""

import collections
import contextlib
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import program_spans
from benchmark.tracing import WINDOW, Trace
from gemnet_pytorch_tpu_torch import graphs
from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider, Molecule, build_graph
from gemnet_pytorch_tpu_torch.data.packer import BatchPacker
from gemnet_pytorch_tpu_torch.data.padding import PadDims, pad_batch, scale_graph_dims
from gemnet_pytorch_tpu_torch.data.synthetic import make_dataset, random_molecule
from gemnet_pytorch_tpu_torch.perf import spans

torch.set_num_threads(2)


def _new(since, thread=None):
    """The records of spans that started after `since` (perf_counter_ns);
    those of `thread` only, where given: another test's prefetch threads
    may still be building."""
    return [r for r in spans.records() if r.start >= since and thread in (None, r.thread)]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return make_dataset(str(tmp_path_factory.mktemp("spans") / "d.npz"), n_molecules=24, seed=3)


def test_spans_off_by_default():
    before = spans.records()
    with spans.span("pad"), spans.span("pack", id=3):
        pass
    assert spans.records() == before
    assert spans.span("a") is spans.span("b")  # one shared null context

    def hundred_k():
        t0 = time.perf_counter()
        for _ in range(100_000):
            with spans.span("pad"):
                pass
        return time.perf_counter() - t0

    # the best of three, so that a busy host's stalls do not count
    assert min(hundred_k() for _ in range(3)) < 0.1
    with spans.timed("capture") as t:  # reads the clock even off
        time.sleep(0.002)
    assert t.seconds >= 0.002 and spans.records() == before


def test_provider_threads_record_their_batches(npz):
    provider = DataProvider(DataContainer(npz, 5.0, 10.0), 24, 0, 4, seed=1)
    packer = BatchPacker()
    it = provider.get_dataset("train", transform=packer.pack, prefetch_workers=2)
    before = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            next(it)
            with spans.span("train.step"):
                pass
    it.close()
    recs = _new(before)
    main = threading.get_ident()
    waits = [r for r in recs if r.name == "data.wait"]
    assert [r.id for r in waits] == [0, 1, 2, 3]
    assert all(r.thread == main and r.parent is None for r in waits)
    # the consumer's spans after a batch carry its number
    assert [r.id for r in recs if r.name == "train.step"] == [0, 1, 2, 3]
    for seq in range(4):
        by_thread = {}
        for r in recs:
            if r.id == seq and r.name in ("graph.build", "pad", "pack"):
                by_thread.setdefault(r.thread, []).append(r)
        # one prefetch thread built the batch, under no span of the consumer's
        (built,) = [v for v in by_thread.values()
                    if sorted(r.name for r in v) == ["graph.build", "pack", "pad"]]
        assert built[0].thread != main and all(r.parent is None for r in built)
        (wait,) = [r for r in waits if r.id == seq]
        assert max(r.end for r in built) <= wait.end


def test_threads_lose_no_count_or_record():
    """More threads than cores, switching every microsecond, count and
    record at once: every count and every span is kept (as many as the
    store holds)."""
    n_threads = min((os.cpu_count() or 4) + 2, 64)
    n = min(2000, spans.STORE_LEN // (2 * n_threads))
    c0 = spans.counters().get("stress", 0)
    before = time.perf_counter_ns()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            def work(i):
                for _ in range(n):
                    spans.count("stress")
                    with spans.span("stress", id=i):
                        pass

            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert spans.counters()["stress"] - c0 == n_threads * n
    recs = [r for r in _new(before) if r.name == "stress"]
    assert len(recs) == n_threads * n and all(r.parent is None for r in recs)
    assert sorted(collections.Counter(r.id for r in recs).values()) == [n] * n_threads


def test_nested_spans_take_parent_and_id():
    rng = np.random.default_rng(0)
    Z, R = random_molecule(rng, 9)
    mol = Molecule(R, Z, 5.0, 10.0)
    before = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("md.calculate", id=7):
            mol.get()
    recs = _new(before, threading.get_ident())
    assert sorted(r.name for r in recs) == ["graph.build", "md.calculate", "pad"]
    assert all(r.id == 7 for r in recs)
    assert {r.name: r.parent for r in recs} == {"graph.build": "md.calculate",
                                                "pad": "md.calculate", "md.calculate": None}
    outer = next(r for r in recs if r.name == "md.calculate")
    assert all(outer.start <= r.start <= r.end <= outer.end for r in recs)


def test_profiling_thread_spans_are_trace_ranges(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("train.step"):
            with spans.span("replay"):
                torch.ones(4).sum()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"gemnet.train.step", "gemnet.replay"} <= names


@pytest.mark.parametrize("triplets_only", [False, True])
def test_pad_counts_rows(triplets_only):
    rng = np.random.default_rng(1)
    Z, R = random_molecule(rng, 10)
    g = build_graph(R, np.array([10]), 5.0, 10.0, triplets_only=triplets_only)
    base = PadDims(n_mol=1, n_atoms=16, n_edges=128, n_triplets=256, kmax3=4,
                   n_int_edges=0 if triplets_only else 64, n_intm=0 if triplets_only else 256,
                   n_quads=0 if triplets_only else 512, kmax4=0 if triplets_only else 4)
    dims = base.grow_to(scale_graph_dims(g, 1.25), 1, 10)
    c0 = spans.counters()
    pad_batch(g, Z, R, dims, triplets_only=triplets_only)
    c1 = spans.counters()
    real = c1["pad.real_rows"] - c0.get("pad.real_rows", 0)
    padded = c1["pad.padded_rows"] - c0.get("pad.padded_rows", 0)
    assert real == g.n_triplets + g.n_quads > 0
    assert (g.n_quads == 0) == triplets_only
    assert padded == dims.n_triplets + (0 if triplets_only else dims.n_quads)


def test_molecule_counts_grown_dims():
    rng = np.random.default_rng(2)
    Z, R = random_molecule(rng, 8)
    mol = Molecule(R, Z, 5.0, 10.0)
    c0 = spans.counters().get("pad.grow", 0)
    mol.get()  # the first sizing is no growth
    assert spans.counters().get("pad.grow", 0) == c0
    mol.dims = PadDims(n_mol=1, n_atoms=8, n_edges=8, n_triplets=8, kmax3=1, n_int_edges=8,
                       n_intm=8, n_quads=8, kmax4=1)
    mol.get()
    assert spans.counters()["pad.grow"] == c0 + 1


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    def enable_debug_mode(self):
        pass

    def instantiate(self):
        pass


def test_capture_counts_captures(monkeypatch):
    """`graphs.capture` on stand-ins for CUDA's streams and graphs: each
    capture adds one to `captures` and its seconds, the `Captured`'s, to
    `capture_s`, and is the span `capture` under a profiler."""
    cuda = types.SimpleNamespace(
        current_stream=lambda device: _Stream(), Stream=lambda device: _Stream(),
        device=lambda device: contextlib.nullcontext(),
        stream=lambda s: contextlib.nullcontext(), CUDAGraph=lambda **kw: _Graph(),
        graph=lambda g: contextlib.nullcontext(), synchronize=lambda device: None)
    for name, value in vars(cuda).items():
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(graphs, "_WARMUP_STREAMS", {})
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.001)
        return torch.zeros(1)

    c0 = spans.counters()
    before = time.perf_counter_ns()
    caps = [graphs.capture(fn, "cpu")]
    with profile(activities=[ProfilerActivity.CPU]):
        caps.append(graphs.capture(fn, "cpu", debug=True))
    c1 = spans.counters()
    assert len(calls) == 2 * (graphs.WARMUP_CALLS + 1)
    assert c1["captures"] - c0.get("captures", 0) == 2
    assert all(c.seconds >= 0.001 * (graphs.WARMUP_CALLS + 1) for c in caps)
    assert c1["capture_s"] - c0.get("capture_s", 0.0) == pytest.approx(
        sum(c.seconds for c in caps))
    (rec,) = [r for r in _new(before) if r.name == "capture"]
    assert (rec.end - rec.start) / 1e9 == caps[1].seconds


def test_alignment_recovers_known_offset():
    rng = np.random.default_rng(4)
    true_us = 1.234567e12  # the trace's clock minus the program's, microseconds
    recs, host = [], []
    t = 5_000_000_000
    for i in range(20):
        dur = int(rng.integers(1_000_000, 30_000_000))  # ns
        recs.append(spans.Record("train.step", 1, t, t + dur, None, i))
        lead, lag = rng.uniform(2, 60, size=2)  # µs the range opens before, closes after
        host.append((t / 1e3 + true_us - lead, (t + dur) / 1e3 + true_us + lag, "step_host"))
        t += dur + int(rng.integers(100_000, 5_000_000))
    off, thread = program_spans.offset_us(recs, sorted(host))
    assert abs(off - true_us) < 200 and thread == 1
    # unpaired names and spans older than the ranges do not move it
    older = [spans.Record("train.step", 1, 10, 20, None, None)]
    assert abs(program_spans.offset_us(older + recs, sorted(host))[0] - true_us) < 200
    assert program_spans.offset_us(recs, [(0.0, 1.0, "integrate")]) is None


def test_alignment_in_a_cpu_profile(tmp_path):
    """In a real CPU profile, each program span, once shifted, lies inside
    the benchmark range around it."""
    before = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            for _ in range(6):
                with record_function("bench.step_host"):
                    with spans.span("train.step"):
                        time.sleep(0.002)
                time.sleep(0.001)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    trace = Trace(path)
    placed, thread = program_spans.placed(_new(before, threading.get_ident()), trace)
    assert thread == threading.get_ident() and len(placed) == 6
    ranges = [(s, e) for s, e, n in trace.host if n == "step_host"]
    for (rec, s, e), (rs, re) in zip(placed, ranges):
        assert rs <= s <= e <= re
        assert (e - s) == pytest.approx((rec.end - rec.start) / 1e3)
