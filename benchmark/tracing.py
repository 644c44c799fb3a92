"""The benchmark's spans and its reading of a `torch.profiler` trace.

`Spans` times the benchmark's own calls into the program's layers on the
host clock; inside a traced stretch each span is also a `record_function`
range named `bench.<span>`, so the trace shows what the host was doing.

The readers are a frozen copy of the port's trace readers as they stood
when the benchmark was defined (its `perf/trace.py`): the names of the
hand-written kernels' device functions (`PROFILE_GROUPS`) and the grouping
of device work by kernel name (`categorize_op`). On top of them: the union
of the device intervals (busy time), the idle gaps between them, each named
by the benchmark span the host was in, and device time by group.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import time

PROFILE_GROUPS = {
    "K1": ("outer_sum_kernel", "outer_sum_merge_kernel", "outer_sum_ffma_ring",
           "outer_sum_mma_ring", "outer_sum_warp_kernel"),
    "K2": ("gather_contract_",),
    "K3": ("sorted_segsum_",),
    "K4": ("outer_sum_split3_", "gather_contract_split3_"),
}
K4_DIRECTIONS = dict(zip(("forward", "backward"), PROFILE_GROUPS["K4"]))
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the range around the traced steps
WINDOW = "bench.traced"


def profile_group(key: str) -> str | None:
    if "split3" in key:
        return "K4" if any(p in key for p in PROFILE_GROUPS["K4"]) else None
    for group, prefixes in PROFILE_GROUPS.items():
        if any(p in key for p in prefixes):
            return group
    return None


def categorize_op(name: str) -> str:
    """K1, K2, K3, K4_forward, K4_backward, elementwise, gather,
    gather_backward, gemm or other."""
    group = profile_group(name)
    if group == "K4":
        return "K4_forward" if K4_DIRECTIONS["forward"] in name else "K4_backward"
    if group:
        return group
    low = name.lower()
    if any(k in low for k in ("indexing_backward", "indexfunc", "index_add", "scatter")):
        return "gather_backward"
    if "index" in low or "gather" in low:
        return "gather"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "elementwise" in low or "functor" in low:
        return "elementwise"
    return "other"


class Spans:
    """Durations (seconds) of named spans; `traced` makes each a profiler range."""

    def __init__(self):
        self.times = collections.defaultdict(list)
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.times[name].append(time.perf_counter() - t0)

    def copy(self) -> dict:
        return {k: list(v) for k, v in self.times.items()}


class Trace:
    """The device events and the benchmark's host ranges of one trace,
    clipped to the `bench.traced` range (times in microseconds)."""

    def __init__(self, path: str):
        with open(path) as f:
            raw = json.load(f)
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        ranges = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
        window = [e for e in ranges if e["name"] == WINDOW]
        if not window:
            raise ValueError(f"trace {path} has no {WINDOW} range")
        self.t0 = window[0]["ts"]
        self.t1 = self.t0 + window[0]["dur"]
        self.device = sorted(
            (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"
            and self.t0 <= e["ts"] <= self.t1)
        self.host = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("bench."):])
                           for e in ranges if e["name"].startswith("bench.")
                           and e["name"] != WINDOW)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self):
        """The union of the device intervals, clipped to the window."""
        out = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            elif e > s:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e6

    def gaps(self):
        """(start, end) of every stretch of the window with no device work."""
        edges = [self.t0] + [x for iv in self.intervals() for x in iv] + [self.t1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def host_span_at(self, t: float) -> str:
        """The innermost benchmark span holding time t, or "none"."""
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        best = None
        for s, e, name in self.host[max(0, i - 64):i + 1]:
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "none"

    def group_s(self) -> dict[str, float]:
        out = collections.defaultdict(float)
        for s, e, name in self.device:
            out[categorize_op(name)] += (e - s) / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        the span the host was in, seconds in the traced window."""
        ops = collections.defaultdict(float)
        for s, e, name in self.device:
            ops[name] += (e - s) / 1e6
        idle = collections.defaultdict(float)
        for s, e in self.gaps():
            idle[self.host_span_at((s + e) / 2)] += (e - s) / 1e6
        return {
            "device_ops": sorted(([k, v] for k, v in ops.items()), key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:top],
        }
