"""Timing instruments of the port's bench (the counterpart of
`gemnet_pytorch_tpu/perf/timing.py`).

A timing window ends with a host value fetch of a scalar that depends on
the whole chain of work in it: the host cannot hold the value before the
device has made it, whatever the runtime's barriers do. PyTorch queues CUDA
work and returns, so a host clock stopped without such a fetch (or a
`torch.cuda.synchronize()`) measures the enqueue, not the work.

    res = timed_windows(chained_fn)      # chained_fn returns a device scalar
    res["median_s"], res["best_s"], res["spread_s"]   # per call, RTT-corrected
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


def fetch_scalar(x) -> float:
    """Pull a (device) scalar's value to the host: a barrier on every
    queued op it depends on."""
    return float(x.item())


def measure_rtt(device=None, n: int = 30) -> float:
    """Median seconds to dispatch a fresh trivial op on `device` and fetch
    its value (the CPU when `device` is None). Each iteration makes a new
    tensor, so no cached value is read. It slightly overstates a bare fetch (one dispatch is in it),
    which only makes the windows that subtract it conservative."""
    x = torch.zeros((), device=device)
    fetch_scalar(x + 1.0)  # warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fetch_scalar(x + 1.0)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def timed_windows(
    fn: Callable[[], torch.Tensor],
    windows: int = 5,
    min_window_s: float = 0.5,
    max_iters: int = 2000,
    rtt_s: float | None = None,
) -> dict:
    """Time chained calls of `fn` in windows that end in a value fetch.

    `fn()` must queue work whose (k+1)-th call depends on the k-th call's
    output (a train step threading its state does; a forward is chained
    through a zero scalar) and return a scalar tensor that depends on the
    whole call.

    A pilot of min(5, max_iters) calls estimates the time per call; each
    window then runs `iters` calls, at least 10 (at most `max_iters`), and
    enough for `min_window_s` and 100 times the fetch RTT, and ends with one
    fetch of the last output, whose RTT is subtracted. `rtt_s` is measured
    on the device of `fn`'s output when not given.

    Returns {"best_s", "median_s", "spread_s" (max - min of the windows),
    "windows_s", "iters", "rtt_s", "total_s"}, per call in seconds.
    """
    pilot_iters = min(5, max_iters)
    t0 = time.perf_counter()
    for _ in range(pilot_iters):
        out = fn()
    fetch_scalar(out)
    pilot_s = time.perf_counter() - t0
    if rtt_s is None:
        rtt_s = measure_rtt(out.device)
    est = max((pilot_s - rtt_s) / pilot_iters, 1e-6)

    iters = int(min(max_iters, max(10, min_window_s / est, 100 * rtt_s / est)))
    times = []
    t_all = time.perf_counter()
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        fetch_scalar(out)
        times.append(max(time.perf_counter() - t0 - rtt_s, 0.0) / iters)
    return {
        "best_s": min(times),
        "median_s": statistics.median(times),
        "spread_s": max(times) - min(times),
        "windows_s": times,
        "iters": iters,
        "rtt_s": rtt_s,
        "total_s": time.perf_counter() - t_all,
    }
