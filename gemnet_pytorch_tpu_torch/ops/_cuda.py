"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

Each source compiles with nvcc into a shared library with a plain C
interface (loaded with ctypes), at first use, into `_build/` beside the
package. Library names carry a digest of the source and flags, so an edited
source is rebuilt and never loaded stale. `build()` starts one nvcc per
source, all together.

Every launch goes through `launch`, which counts it (per C function and
shape; the function's name carries the stream dtype, `_f32` or `_bf16`, or
the `_split3` mode, for the launch census of a run) and raises when the C
function reports a CUDA error. `cuda_ms` times calls with CUDA events
around their host loop (wrapper included); `graph_ms` times their device
work alone, replayed from a CUDA graph.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("segment_outer.cu", "expand_gather.cu", "row_gather.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# K1 and the K4 forward take the same arguments: a, b, items, n_items,
# merge_ptr, merge_seg, n_merge, tree_nodes, tree_parent, tree_arrivals,
# partial, out, n, n_seg, S, M, stream
_K1_ARGS = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
_K2_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]
_K4_FWD_ARGS = _K1_ARGS
_K4_BWD_ARGS = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P]
_K3_ARGS = [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P]
_GATHER_ARGS = [_P, _P, _P, _I, _I, _I, _P]
# C function -> (source, argtypes, restype)
_FUNCTIONS = {
    "gemnet_segment_outer_sum_f32": ("segment_outer.cu", _K1_ARGS, _I),
    "gemnet_segment_outer_sum_bf16": ("segment_outer.cu", _K1_ARGS, _I),
    "gemnet_segment_outer_sum_smem": ("segment_outer.cu", [_I, _I], ctypes.c_size_t),
    "gemnet_segment_outer_sum_threads": ("segment_outer.cu", [_I, _I], _I),
    "gemnet_segment_gather_contract_f32": ("segment_outer.cu", _K2_ARGS, _I),
    "gemnet_segment_gather_contract_bf16": ("segment_outer.cu", _K2_ARGS, _I),
    "gemnet_segment_gather_contract_smem": ("segment_outer.cu", [_I, _I], ctypes.c_size_t),
    "gemnet_segment_outer_sum_split3": ("segment_outer.cu", _K4_FWD_ARGS, _I),
    "gemnet_segment_outer_sum_split3_smem": ("segment_outer.cu", [_I, _I], ctypes.c_size_t),
    "gemnet_segment_gather_contract_split3": ("segment_outer.cu", _K4_BWD_ARGS, _I),
    "gemnet_segment_gather_contract_split3_smem": ("segment_outer.cu", [_I, _I],
                                                   ctypes.c_size_t),
    "gemnet_sorted_segsum_f32": ("expand_gather.cu", _K3_ARGS, _I),
    "gemnet_sorted_segsum_bf16": ("expand_gather.cu", _K3_ARGS, _I),
    "gemnet_row_gather": ("row_gather.cu", _GATHER_ARGS, _I),
    "gemnet_row_gather_fm": ("row_gather.cu", _GATHER_ARGS, _I),
}
# stream dtype -> suffix of the kernel entries that take it
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_LIBS: dict[str, ctypes.CDLL] = {}
# kernel launches by (C function, shape); see `kernel_launches`
LAUNCHES: collections.Counter = collections.Counter()
# the open kernel censuses (`perf.roofline.kernel_census`): lists that
# `note_kernel` appends to
CENSUSES: list[list] = []


def use_kernel(device: torch.device) -> bool:
    """Whether a wrapper launches its hand-written kernel on `device`: the
    kernel on a CUDA tensor, the plain version on a CPU tensor (no plain
    version runs on the card); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type != "cpu":
        raise ValueError(f"no kernel or plain version for device {device}")
    return False


def set_matmul_precision() -> None:
    """The port's matmul precision on the card, process-wide: fp32 products
    in full fp32, as on the CPU (a TF32 product keeps ~10 mantissa bits, and
    -dE/dR differentiates through every product of the network), and bf16
    products summed in fp32, as XLA's are (no bf16 split-K reductions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return nvcc


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def build(sources=SOURCES) -> float:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns the wall seconds it took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, proc, tmp, out))
    failed = []
    for source, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {source}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def _library(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        for name, (src, argtypes, restype) in _FUNCTIONS.items():
            if src == source:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        lib.gemnet_cuda_error_string.argtypes = [_I]
        lib.gemnet_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


def function(name: str):
    """The ctypes function `name` of its (built, loaded) library."""
    return getattr(_library(_FUNCTIONS[name][0]), name)


def launch(name: str, shape: tuple, device: torch.device, *args) -> None:
    """Call kernel entry `name` on `device`'s current stream; count it under
    (name, shape). Pointer arguments are passed as ints (`data_ptr()`)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = function(name)(*args, stream)
    if code:
        msg = _library(_FUNCTIONS[name][0]).gemnet_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} failed to launch: CUDA error {code} ({msg})")
    LAUNCHES[(name, shape)] += 1


def kernel_launches() -> dict[str, int]:
    """Launches per kernel since the last `reset_launches`."""
    out: dict[str, int] = collections.Counter()
    for (name, _), n in LAUNCHES.items():
        out[name] += n
    return dict(out)


def reset_launches() -> None:
    LAUNCHES.clear()


def note_kernel(kernel: str, direction: str, dtype: str, name: str, shape: tuple) -> None:
    """Record one call of a hand-written kernel's wrapper in every open
    census: kernel K1-K4, its direction, stream dtype ("f32", "bf16") or
    "split3", C entry `name` and shape. The wrappers note the call on
    either device, where they choose between the kernel and its plain
    version, so a census is the same on the CPU as on the card."""
    for census in CENSUSES:
        census.append(dict(kernel=kernel, direction=direction, dtype=dtype, fn=name,
                           shape=tuple(shape)))


def cuda_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> tuple[float, float, float]:
    """(median, min, max) over `windows` CUDA-event windows of `iters` calls
    each, in ms per call, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times)), min(times), max(times)


def graph_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> tuple[float, float, float]:
    """Device time of `fn` per call without the host: `iters` calls captured
    into one CUDA graph (on the side stream `torch.cuda.graph` makes
    current, so the wrappers' launches and their `torch.empty`s land in the
    graph and its pool), replayed under CUDA events. (median, min, max) in
    ms per call over `windows` replays, after `warmup` eager calls and one
    replay. Raises when the capture fails; the replay counts no launches
    (the wrappers run once, at capture)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return float(np.median(times)), min(times), max(times)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_plan(plan, device: torch.device) -> None:
    """Raise unless `plan` (a data.batch.SegmentPlan) lies on `device`."""
    check_tensor(plan.items, "plan.items", torch.int32, device)
    check_tensor(plan.merge_ptr, "plan.merge_ptr", torch.int32, device)
    check_tensor(plan.merge_seg, "plan.merge_seg", torch.int32, device)
    check_tensor(plan.arrivals, "plan.arrivals", torch.int32, device)
    check_tensor(plan.tree_nodes, "plan.tree_nodes", torch.int32, device)
    check_tensor(plan.tree_parent, "plan.tree_parent", torch.int32, device)
    check_tensor(plan.tree_arrivals, "plan.tree_arrivals", torch.int32, device)
    if plan.items.ndim != 2 or plan.items.shape[1] != 4:
        raise ValueError(f"plan.items has shape {tuple(plan.items.shape)}, expected (n, 4)")
