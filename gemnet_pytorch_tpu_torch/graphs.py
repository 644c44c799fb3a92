"""CUDA graphs: the port's counterpart of the JAX package's `jax.jit`.

A jitted JAX function is compiled once per shape and then dispatched as one
program. Its counterpart here is a `torch.cuda.CUDAGraph`: the function runs
once under `torch.cuda.graph` on a private memory pool, every kernel it
launches (the hand-written K1-K4 among them, through `ops._cuda.launch`,
which launches on the current stream, and the autograd engine's backward
launches, on the stream of their forward) is recorded, and each `replay()`
launches all of them again with one host call. Its inputs are static
buffers the caller refills before a replay; its outputs are tensors of the
pool, overwritten by the next replay.

`capture` warms the function up on a side stream first, as PyTorch asks
(cuBLAS handles and workspaces, the autograd engine's device thread and the
kernels' libraries are set up outside the capture), then lets the caller
undo what the warm-up changed, then captures. Every capture on a device
warms up on the same side stream, so captures do not each add a stream's
cuBLAS workspaces to what the process holds. A failed capture raises: no
caller falls back to running the function eagerly on the card.
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass

import torch

from .ops import _cuda
from .perf import spans

# eager calls on a side stream before a capture
WARMUP_CALLS = 2
# the warm-up stream of each device, shared by every capture: each stream
# that runs a cuBLAS call gets cuBLAS and cuBLASLt workspaces of its own,
# which PyTorch keeps for the life of the process
_WARMUP_STREAMS: dict[torch.device, torch.cuda.Stream] = {}
# the hand-written kernels' device functions (perf/trace.PROFILE_GROUPS)
KERNEL_NAMES = ("outer_sum", "gather_contract", "sorted_segsum")


@dataclass
class Captured:
    graph: torch.cuda.CUDAGraph
    outputs: object  # what the captured call returned: tensors of the pool
    launches: collections.Counter  # hand-written kernel launches, by (C entry, shape)
    seconds: float  # wall time of the warm-up and the capture (the span `capture`)


def capture(fn, device, before_capture=None, warmup: int = WARMUP_CALLS,
            debug: bool = False) -> Captured:
    """fn() `warmup` times on a side stream, then `before_capture()` (the
    caller restores what the warm-up changed), then fn() captured into a new
    CUDA graph. `debug` keeps the graph for `kernel_nodes`. The launches the
    capture recorded are counted in `_cuda.LAUNCHES` as any launch is; the
    capture is the span `capture` and the counters `captures` and
    `capture_s` (`perf.spans`)."""
    with spans.timed("capture") as timer:
        device = torch.device(device)
        current = torch.cuda.current_stream(device)
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.device(device), torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        current.wait_stream(side)
        if before_capture is not None:
            before_capture()
        # debug: keep the cudaGraph_t (instantiated below) for its DOT dump
        graph = torch.cuda.CUDAGraph(keep_graph=True) if debug else torch.cuda.CUDAGraph()
        if debug:
            graph.enable_debug_mode()
        before = collections.Counter(_cuda.LAUNCHES)
        with torch.cuda.device(device), torch.cuda.graph(graph):
            outputs = fn()
        launches = collections.Counter(_cuda.LAUNCHES)
        launches.subtract(before)
        if debug:
            graph.instantiate()
        torch.cuda.synchronize(device)
    spans.count("captures")
    spans.count("capture_s", timer.seconds)
    return Captured(graph, outputs, +launches, timer.seconds)


def kernel_nodes(graph: torch.cuda.CUDAGraph, path: str) -> tuple[int, int]:
    """(kernel nodes, of which hand-written kernels) of a graph captured with
    `debug=True`, from its `debug_dump` DOT file at `path`."""
    graph.debug_dump(path)
    with open(path) as f:
        text = f.read()
    nodes = re.split(r'\n\s*(?="?graph_\d+_node_\d+"?\s*\[)', text)
    kernels = [n for n in nodes if "KERNEL" in n]
    return len(kernels), sum(any(k in n for k in KERNEL_NAMES) for n in kernels)


def pool_mib(graph: torch.cuda.CUDAGraph) -> float:
    """MiB the graph's private memory pool holds (the cudaMalloc'd size of
    its segments): memory a replay uses that `max_memory_allocated` does not
    count once the capture has freed its intermediates back to the pool."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg["segment_pool_id"]) == pool) / 2**20
