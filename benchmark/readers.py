"""What the per-layer metric readers (`metrics/<name>.py`) share: device
time of kernel groups, the bilinear kernels' roofline and the model's FLOPs
over the traced steps. Each returns None where its run has nothing to read
(no trace, or no device events in it)."""

from __future__ import annotations

import statistics

from . import flops, roofline
from .tracing import profile_group


def _device(run) -> bool:
    return run.trace is not None and bool(run.trace.device)


def group_ms(run, *groups):
    """Device ms a step of the trace's kernel groups."""
    if not _device(run):
        return None
    g = run.trace.group_s()
    return 1e3 * sum(g.get(k, 0.0) for k in groups) / run.rec.traced_steps


def p95_ms(run, span):
    v = run.span_ms(span)
    return statistics.quantiles(v, n=20)[18] if len(v) >= 20 else None


def bilinear_roofline(run):
    """% of the traced device time of K1, K2 and K4 that their bound takes:
    every launch of a step (the captured step's census) at the real rows
    of that step's batch, its bound the larger of operations over the
    peak of its class and bytes over the HBM rate."""
    if not _device(run) or not run.rec.launches:
        return None
    rec = run.rec
    spent = sum((e - s) / 1e6 for s, e, name in run.trace.device
                if profile_group(name) in ("K1", "K2", "K4"))
    rows = {rec.padded["triplets"]: "triplets", rec.padded["quads"]: "quads"}
    bound = 0.0
    for counts in rec.traced_counts:
        for (entry, shape), k in rec.launches.items():
            if entry not in roofline.ENTRIES:
                continue
            kernel, dtype = roofline.ENTRIES[entry]
            real = counts[rows[shape[0]]] if shape[0] in rows else None
            used = counts["edges"] if shape[3] == rec.padded["edges"] else None
            bound += k * roofline.bound_s(kernel, dtype, tuple(shape), real, used)
    return 100.0 * bound / spent if spent > 0 else None


def mfu(run, phase):
    """% of the fp32 peak that the model's FLOPs (flops.py) over the traced
    steps are, in the traced window's time."""
    if not _device(run):
        return None
    total = sum(flops.step_flops(run.cfg, c, phase) for c in run.rec.traced_counts)
    return 100.0 * total / run.trace.window_s / roofline.PEAKS["f32"]


def idle_pct(run):
    if not _device(run):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
