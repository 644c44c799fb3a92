"""Device time read back from a `torch.profiler` trace (the counterpart of
`gemnet_pytorch_tpu/perf/trace.py`): the bench's third instrument, beside
the host clock and CUDA events.

`record_trace` runs a function under the profiler, each call inside a
`record_function` range, and writes the chrome trace (`export_chrome_trace`).
The readers parse that file back:
- `module_times` / `step_device_ms`: the device time of the work launched
  inside each named range. A device event (kernel, memcpy, memset) is
  matched to its launch (the runtime call with the same correlation id),
  and counts under every range whose host interval holds the launch,
  whatever thread launched it (the autograd engine launches the backward
  from its own thread while the step's thread waits in it). The kernels of
  a CUDA graph replay carry the correlation id of the `cudaGraphLaunch`
  that launched the graph (a runtime or driver call like any launch), so a
  captured step's kernels count under the range that holds its replay;
- `op_times`, `categorize_op`, `op_category_summary`, `summarize`: device
  time by kernel name and by group (the hand-written kernels K1-K4, K4 by
  direction; elementwise; gathers and their backwards; GEMM; other).

A trace of a CPU run holds no device events: the readers return empty
device summaries (`step_device_ms` None). `profile` prints where one call's
device time goes, from `key_averages()`.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import time
from dataclasses import dataclass

import torch

# the hand-written kernels' device functions, by the names the profiler
# shows (K1 is outer_sum_ffma_ring (fp32) / outer_sum_mma_ring (bf16) at the
# quadruplet shape, outer_sum_warp_kernel at the triplet shape and
# outer_sum_kernel at other shapes; K4's backward is
# gather_contract_split3_ring at the quadruplet shape,
# gather_contract_split3_warp (a warp per work item, split3 FFMAs) at the
# triplet shape and gather_contract_split3_kernel at other shapes and on
# unaligned tensors, its forward outer_sum_split3_ring at the quadruplet
# shape, outer_sum_split3_warp (K1's warp kernel with split3 products) at
# the triplet shape and outer_sum_split3_kernel at other shapes. The merge
# kernel of K1's general kernel also serves K4's wmma forward, at shapes the
# model does not give: it counts under K1)
PROFILE_GROUPS = {
    "K1": ("outer_sum_kernel", "outer_sum_merge_kernel", "outer_sum_ffma_ring",
           "outer_sum_mma_ring", "outer_sum_warp_kernel"),
    "K2": ("gather_contract_",),
    "K3": ("sorted_segsum_",),
    "K4": ("outer_sum_split3_", "gather_contract_split3_"),
}
# K4's device functions by direction
K4_DIRECTIONS = dict(zip(("forward", "backward"), PROFILE_GROUPS["K4"]))
# the groups of `categorize_op`, in the order `summarize` prints them
GROUPS = ("K1", "K2", "K3", "K4_forward", "K4_backward", "elementwise", "gather",
          "gather_backward", "gemm", "other")
# trace categories of device work, and of the host calls that launch it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def profile_group(key: str) -> str | None:
    """The PROFILE_GROUPS kernel a profiler key names, or None."""
    if "split3" in key:
        return "K4" if any(p in key for p in PROFILE_GROUPS["K4"]) else None
    for group, prefixes in PROFILE_GROUPS.items():
        if any(p in key for p in prefixes):
            return group
    return None


def categorize_op(name: str) -> str:
    """The group (GROUPS) of a device event's name."""
    group = profile_group(name)
    if group == "K4":
        return "K4_forward" if K4_DIRECTIONS["forward"] in name else "K4_backward"
    if group:
        return group
    low = name.lower()
    # index_put with accumulate (the plain gathers' backward), index_add_
    # (indexFunc*), scatter_add
    if any(k in low for k in ("indexing_backward", "indexfunc", "index_add", "scatter")):
        return "gather_backward"
    if "index" in low or "gather" in low:
        return "gather"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    if "elementwise" in low or "functor" in low:
        return "elementwise"
    return "other"


# ------------------------------------------------------------ write a trace


def record_trace(fn, n: int, trace_dir: str, name: str = "step", device="cuda") -> str:
    """Run `fn()` `n` times under torch.profiler, each call inside
    record_function(`name`), the device traced where `device` is CUDA; the
    last call's output is fetched inside the profiled window. Writes and
    returns `trace_dir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        for _ in range(n):
            with record_function(name):
                out = fn()
        float(out.item())
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


# ------------------------------------------------------------- read it back


@dataclass
class ModuleTime:
    name: str
    count: int
    total_ms: float

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


def _events(path: str) -> list[dict]:
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _device_events(events):
    """(device events, {correlation id: launch timestamp})."""
    device = [e for e in events if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {})}
    return device, launches


def module_times(trace: str) -> dict[str, ModuleTime]:
    """{range name: ModuleTime(name, ranges, device ms launched inside
    them)} over the record_function ranges of a trace (a file, or the
    directory `record_trace` wrote to)."""
    events = _events(trace)
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    out = {}
    for name, spans in ranges.items():
        spans.sort()
        out[name] = ModuleTime(name, len(spans), 0.0)
    device, launches = _device_events(events)
    for e in device:
        ts = launches.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for name, spans in ranges.items():
            i = bisect.bisect_right(spans, (ts, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                out[name].total_ms += e["dur"] / 1e3
    return out


def step_device_ms(trace: str, match: str = "step") -> ModuleTime | None:
    """The ranges whose name contains `match` (the largest total if
    several names do), or None where they hold no device time (a CPU run,
    or a trace without them)."""
    hits = [m for n, m in module_times(trace).items() if match in n and m.total_ms > 0]
    return max(hits, key=lambda m: m.total_ms) if hits else None


def op_times(trace: str) -> dict[str, ModuleTime]:
    """{device event name: ModuleTime(name, executions, total ms)}."""
    out: dict[str, ModuleTime] = {}
    for e in _device_events(_events(trace))[0]:
        mt = out.setdefault(e["name"], ModuleTime(e["name"], 0, 0.0))
        mt.count += 1
        mt.total_ms += e["dur"] / 1e3
    return out


def op_category_summary(trace: str, n_execs: int = 1) -> dict[str, float]:
    """{group: device ms per execution} over the trace's device events,
    every group of GROUPS present (0.0 where nothing ran)."""
    cats = dict.fromkeys(GROUPS, 0.0)
    for name, mt in op_times(trace).items():
        cats[categorize_op(name)] += mt.total_ms / max(n_execs, 1)
    return cats


def summarize(trace: str, n_execs: int = 1) -> str:
    """The ranges with their device ms, then device ms per execution by
    group; "(no device events in trace)" where there are none."""
    lines = [f"{m.name}: {m.count} ranges, device {m.total_ms:.3f} ms, mean {m.mean_ms:.4f} ms"
             for m in sorted(module_times(trace).values(), key=lambda m: -m.total_ms)]
    cats = op_category_summary(trace, n_execs)
    if not any(cats.values()):
        return "\n".join(lines + ["(no device events in trace)"])
    return "\n".join(lines + [f"  {g:16s} {ms:9.3f} ms" for g, ms in cats.items()])


# ------------------------------------------------------- one call, in print


def profile(fn, what: str, log=print, top: int = 12) -> dict | None:
    """Where one call's time goes: torch.profiler over one `fn()`, the
    device's busy share of the wall time, the kernels by device time, and
    the device ms of K1-K4 summed by group (K4 also by direction), which
    it returns. (The profiler slows the host, so its wall time exceeds the
    timed one.) None, logged as "not measured", where the profiler gives
    no device events: it is a measurement aid only."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
    except (RuntimeError, AttributeError) as exc:
        log(f"  profiler breakdown: not measured ({exc})")
        return None
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    log(f"  profiled {what}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches, "
        f"{n_ops} aten op calls")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    groups = {g: [0.0, 0] for g in GROUPS[:5]}
    for e in kernels:
        g = categorize_op(e.key)
        if g in groups:
            groups[g][0] += e.self_device_time_total / 1e3
            groups[g][1] += e.count
    k4 = {d: groups[f"K4_{d}"] for d in K4_DIRECTIONS}
    log(f"  {what}, hand-written kernels' device ms (launches): "
        + ", ".join(f"{g} {ms:.3f} ({n})" for g, (ms, n) in groups.items()
                    if not g.startswith("K4"))
        + f", K4 {k4['forward'][0] + k4['backward'][0]:.3f} "
        f"({k4['forward'][1] + k4['backward'][1]}); K4 forward {k4['forward'][0]:.3f}, "
        f"backward {k4['backward'][0]:.3f}")
    return dict(device_ms=busy_us / 1e3, K1=groups["K1"][0], K2=groups["K2"][0],
                K3=groups["K3"][0], K4=k4["forward"][0] + k4["backward"][0],
                **{f"K4_{d}": ms for d, (ms, _) in k4.items()})
