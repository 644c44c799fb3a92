"""The cells' timed loops, one module each: `loops/<name>.py`, found by the
name that a traffic mix gives under `loop` (`find`).

A loop module has:
- `run(cfg, mix, seed, seconds, trace, device, t_process) -> Record`: builds
  the program from the run's seed, warms up every shape the window uses
  (that is set-up), runs for `seconds` on the host clock with the
  benchmark's spans around its calls into the program, then, in a traced
  run, a fixed number of steps more under the profiler. The program's state
  is freed before it returns;
- `numbers(cfg, rec, seed, device) -> dict`: the numbers the check compares
  (the keys of `limits/<cell>.json`), from what the record kept of the
  timed path and the plain reference.

A new kind of loop is a new module here, and nothing else changes.
"""

from __future__ import annotations

import gc
import importlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from .. import weights
from ..tracing import WINDOW


def find(name: str):
    """The loop module `loops/<name>.py`."""
    return importlib.import_module(f"{__name__}.{name}")


@dataclass
class Record:
    kind: str  # the loop's name: "train", "md", ...
    setup_s: float
    window_s: float
    steps: int  # steps in the window
    units: int  # what the cell's rate counts (structures, MD steps) in the window
    peak_bytes: int
    spans: dict  # span name -> seconds of each, over the window
    failed: int = 0
    build_s: float = 0.0  # of set-up: building the program's kernels (0 once built)
    trace_path: str | None = None
    traced_steps: int = 0
    # the launches of one captured step: {(C entry, shape): count}
    launches: dict = field(default_factory=dict)
    # padded row counts of the program's batches: {"triplets": n, "quads": n, "edges": n}
    padded: dict = field(default_factory=dict)
    # real counts of each traced step's batch (reference.graph.counts)
    traced_counts: list = field(default_factory=list)
    # what the check compares, filled by the loop
    check: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


def build_kernels(device) -> float:
    """Build the program's CUDA kernels and its native graph builder where
    they are missing; the seconds it took (about 0 once they are built)."""
    if device.type != "cuda":
        return 0.0
    from gemnet_pytorch_tpu_torch.data import native
    from gemnet_pytorch_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    native.build()
    return _cuda.build() + time.perf_counter() - t0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_reserved(device) if device.type == "cuda" else 0


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def traced(spans, device, n, step):
    """`step()` n times under the profiler inside the window range; the
    chrome trace's path."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    spans.traced = True
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                step()
            sync(device)
    spans.traced = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    return path


def program(cfg, seed, device):
    """The program's model at the run's weights, and those weights."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models.gemnet import GemNet
    sd = weights.make(cfg, seed, device)
    model = GemNet(ModelConfig.from_dict(cfg), generator=torch.Generator().manual_seed(0),
                   device=device)
    model.load_state_dict(sd, strict=True)
    return model, sd


def halves(spans: dict, *names) -> str:
    """The mean ms of each span in the window's first and second halves: a
    rate that drifts within a run shows here."""
    out = []
    for name in names:
        v = spans.get(name, [])
        if len(v) >= 2:
            a, b = (1e3 * sum(h) / len(h) for h in (v[:len(v) // 2], v[len(v) // 2:]))
            out.append(f"{name} {a:.6g} / {b:.6g} ms")
    return "mean span in the window's halves: " + ("; ".join(out) or "too few steps")


def setup_s(t_process, device) -> float:
    sync(device)
    return time.time() - t_process
