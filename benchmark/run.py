"""Run one cell of the benchmark and print its result as the last line of
standard output.

    python3 benchmark/run.py --workload q-coll-train --seed 7 --seconds 30 --trace 0

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`configs/<name>.json`) and a traffic mix (`traffic/<name>.json`, whose
`loop` names the timed loop, `loops/<loop>.py`). With `--trace 0` the line
holds the cell's end-to-end metrics; with `--trace 1` its per-layer
metrics and the trace's breakdown. Every metric, of either kind, is read
by `metrics/<name>.py`, or where there is no such file by the reader of the
name's part before its first dot (`metrics/mfu.py` reads `mfu.train` and
`mfu.md`), from the loop's record: its times and spans, the program's
counters and the profiler's trace of the steps after the window. Every run
then checks its outputs against the plain reference (the loop's `numbers`,
`check.py`) and prints each number compared beside its limit, last on
standard error and last in the line. It exits non-zero and prints no line
where no CUDA device is there (or fewer than the cell asks for), or where
JAX or the JAX package were loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may load: the JAX package is the port's reference
FORBIDDEN = ("jax", "jaxlib", "flax", "gemnet_pytorch_tpu")


def process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROCESS = process_start()


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, traffic mix) of a workload name."""
    m = manifest()
    w = next((w for w in m["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    return m, w, cfg, load_json("traffic", f"{w['traffic']}.json")


def reader_path(name: str) -> str:
    """`metrics/<name>.py`, or the reader of the name's stem before its
    first dot."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    if os.path.exists(path):
        return path
    return os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")


def reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{os.path.basename(path)[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))


def power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def read_metrics(metrics: list, w: dict, run) -> dict:
    """The value of each of `metrics` that the cell reports, where its
    reader finds something to read."""
    out = {}
    for metric in metrics:
        if w["name"] not in metric.get("workloads", [w["name"]]):
            continue
        value = reader(metric["name"])(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


class Run:
    """What a metric reader reads: the loop's record, the configuration and
    the parsed trace (None without one)."""

    def __init__(self, rec, cfg, trace):
        self.rec, self.cfg, self.trace = rec, cfg, trace

    def span_ms(self, name: str) -> list[float]:
        return [1e3 * s for s in self.rec.spans.get(name, [])]

    def mean_span_ms(self, name: str):
        v = self.span_ms(name)
        return statistics.fmean(v) if v else None


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides: dict | None = None) -> dict:
    """One run of a cell; the result's dict. `device` and `overrides` (keys
    of the configuration and of the traffic mix, {"config": {...},
    "traffic": {...}}) serve the CPU tests; a run on the card passes
    neither."""
    cache_dirs()
    import torch

    from . import check, loops
    from .tracing import Trace

    m, w, cfg, mix = cell(workload)
    cfg = {**cfg, **(overrides or {}).get("config", {})}
    mix = {**mix, **(overrides or {}).get("traffic", {})}
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            raise SystemExit(f"{workload} needs {w['chips']} CUDA device(s); "
                             f"{torch.cuda.device_count()} found")
        device = "cuda"
    device = torch.device(device)
    loop = loops.find(mix["loop"])
    rec = loop.run(cfg, mix, seed, seconds, trace, device, T_PROCESS)
    result = {"correct": None, "attempted": rec.steps, "failed": rec.failed}
    tr = Trace(rec.trace_path) if trace else None
    if trace:
        os.remove(rec.trace_path)
    result["metrics"] = read_metrics(m["per_layer"] if trace else m["end_to_end"], w,
                                     Run(rec, cfg, tr))
    if tr is not None and tr.device:
        result["breakdown"] = tr.breakdown()
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": w["chips"], "memory_peak_bytes": rec.peak_bytes,
           # of setup_s: building the program's kernels, which a checkout's first run does
           "build_s": rec.build_s}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result["device"] = dev
    numbers = loop.numbers(cfg, rec, seed, device)
    for note in rec.notes:
        print(f"note: {note}", file=sys.stderr)
    lim = check.limits(workload)
    result["correct"] = bool(rec.failed == 0 and all(numbers[k] <= lim[k] for k in lim))
    # a number that is not finite (a step that accumulated nothing) fails, and
    # goes into the line as null: JSON has no NaN
    result["checks"] = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else None,
                            "limit": lim[k]} for k in lim}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; no run may load them",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):  # run as a file: benchmark/run.py
        sys.path[0] = ROOT  # the checkout's root, not benchmark/
        __package__ = "benchmark"
        import benchmark  # noqa: F401
    sys.exit(main())
