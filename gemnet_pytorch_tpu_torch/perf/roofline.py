"""Cost model and speed of light of the port's train step on an NVIDIA H100
(the counterpart of `gemnet_pytorch_tpu/perf/roofline.py`, re-derived for
the hand-written Hopper kernels).

A step does two kinds of work:

1. **aten ops** (dense layers, bases, geometry, gathers, optimizer, the
   autograd of all of them): `aten_costs` counts, over one call, their
   matmul FLOPs as `torch.utils.flop_counter` prices them and the bytes of
   every op's tensor inputs and outputs, with one dispatch mode. That byte
   sum is an accounting of per-op traffic, as XLA's "bytes accessed" is:
   L2 hits and in-place ops make it exceed real HBM traffic, so it feeds
   the `hi` bound only.
2. **the hand-written kernels** K1-K4 (`csrc/`): they launch through ctypes
   and are invisible to both counters on the card, so nothing is counted
   twice there. (On the CPU their plain versions run as aten ops and are
   counted by both.) `kernel_census` records each call where its wrapper
   chooses between the kernel and its plain version, and `kernel_costs`
   prices it: each input read once, each output written once, 2·n·S·M
   (K1) or 4·n·S·M (K2) operations, three times that on the tensor cores
   for split3 (K4), n·M additions for K3. The `lo` count reads the real
   rows and the used segments' cotangent tiles only; `hi` every padded row.

Speed of light: max(compute, memory). compute = aten FLOPs over the peak of
the step's matmul dtype + the kernels' FLOPs over the peak of their streams'
class; memory lo = (`train_step_min_bytes` + the kernels' `bytes_lo`) over
the HBM rate, a floor under any fusion; memory hi = (aten bytes + the
kernels' `bytes_hi`) over it. A measured step below `sol_ms_lo` flags the
measurement (`below_floor`). Unlike the TPU model there is no row-gather
rate term: Hopper's gathers are bound by the bytes they move, which both
byte counts already hold.

Peaks: the shares are stated against NVIDIA's published H100 SXM peaks
(`H100_DATASHEET`), beside the card's name and power limit. `calibrate_peaks`
measures the card with CUDA events and `check_peaks` fails a calibration no
card could give; the calibrated peaks are printed and checked, never
divided by, and there is no fallback.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops import _cuda

# NVIDIA H100 SXM data sheet, dense rates: bf16 on the tensor cores, fp32
# outside them (the port turns TF32 off: ops/_cuda.set_matmul_precision),
# HBM3 bytes/s
H100_DATASHEET = {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12}
# the peak each kernel stream's operations run at (split3: bf16 products
# of fp32 rows on the tensor cores) and the bytes of its row elements
FLOP_CLASS = {"f32": "f32", "bf16": "bf16", "split3": "bf16"}
BYTES = {"f32": 4, "bf16": 2, "split3": 4}


def peak_flops(dtype: str, peaks: dict = H100_DATASHEET) -> float:
    """Peak FLOP/s of a kernel stream dtype ("f32", "bf16", "split3")."""
    return peaks[FLOP_CLASS[dtype]]


# ------------------------------------------------------------------ kernels


def kernel_census(fn: Callable, *args) -> list[dict]:
    """Run `fn(*args)` once and return one record per hand-written kernel
    call in it: {"kernel": "K1".."K4", "direction", "dtype" ("f32", "bf16"
    or "split3"), "fn" (the C entry), "shape" ((n, S, M, n_segments), K3
    (n, M, n_segments))}. On the card each record is one launch."""
    census: list[dict] = []
    _cuda.CENSUSES.append(census)
    try:
        fn(*args)
    finally:
        _cuda.CENSUSES.remove(census)
    return census


def kernel_cost(kernel: str, dtype: str, shape: tuple, real_rows: dict | None = None,
                used_segments: dict | None = None) -> tuple[float, float]:
    """(bytes, operations) one call must move and do: each input read once,
    each output written once, row data at the stream dtype (split3: fp32),
    the segment structure as n_segments+1 int32 offsets, K3's permutation as
    n int32; split3 does three bf16 products per fp32 one. `kernel` is the
    function computed: K1, K2 (K4 is K1 or K2 at dtype "split3"), K3, or the
    probe's row gathers P1/P2, which read the indices and the N-row table
    once (a row read twice comes from L2), write R rows and do no arithmetic.

    `real_rows` / `used_segments` map a padded row or segment count to the
    real one: given, the rows read and the cotangent tiles read are the real
    ones (the `lo` count); the outputs are written whole either way."""
    w = BYTES[dtype]
    if kernel in ("P1", "P2"):
        R, M, N = shape
        return 4 * R + w * N * M + w * R * M, 0.0
    real_rows, used_segments = real_rows or {}, used_segments or {}
    if kernel in ("K1", "K2"):
        n, S, M, n_seg = shape
        n_eff, seg_eff = real_rows.get(n, n), used_segments.get(n_seg, n_seg)
        offsets = 4 * (n_seg + 1)
        passes = 3 if dtype == "split3" else 1
        if kernel == "K1":
            return (w * n_eff * (S + M) + offsets + w * S * n_seg * M,
                    passes * 2.0 * n_eff * S * M)
        return (w * S * seg_eff * M + w * n_eff * (S + M) + offsets + w * n * (S + M),
                passes * 4.0 * n_eff * S * M)
    n, M, n_seg = shape
    n_eff = real_rows.get(n, n)
    return w * n_eff * M + 4 * n_eff + 4 * (n_seg + 1) + w * n_seg * M, float(n_eff * M)


def kernel_costs(census: list[dict], real_rows: dict | None = None,
                 used_segments: dict | None = None) -> dict:
    """The census priced by `kernel_cost`, `lo` (real rows and used
    segments) and `hi` (padded): {"f32_flops_lo", "f32_flops_hi",
    "bf16_flops_lo", "bf16_flops_hi", "bytes_lo", "bytes_hi", "n_calls"}."""
    out = dict.fromkeys(("f32_flops_lo", "f32_flops_hi", "bf16_flops_lo", "bf16_flops_hi",
                         "bytes_lo", "bytes_hi"), 0.0)
    out["n_calls"] = len(census)
    for c in census:
        kernel = c["kernel"]
        if kernel == "K4":
            kernel = "K1" if c["direction"] == "forward" else "K2"
        cls = FLOP_CLASS[c["dtype"]]
        for bound, rows, segs in (("lo", real_rows, used_segments), ("hi", None, None)):
            nbytes, flops = kernel_cost(kernel, c["dtype"], c["shape"], rows, segs)
            out[f"bytes_{bound}"] += nbytes
            out[f"{cls}_flops_{bound}"] += flops
    return out


# ---------------------------------------------------------------- aten ops

# ops that move no bytes: allocations (their contents are undefined)
_ALLOCATIONS = frozenset({torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
                          torch.ops.aten.empty_like.default})


class _CostCounter(TorchDispatchMode):
    """Adds up the FLOPs of every aten op that FlopCounterMode's registry
    prices (the matmuls and convolutions) and the bytes of every op's tensor
    inputs and outputs; views and allocations move none. (FlopCounterMode
    itself also tracks modules through autograd hooks, which
    `torch.autograd.grad` of E with respect to the leaf R refuses.)"""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        price = self.registry.get(func._overloadpacket)
        if price is not None:
            self.flops += price(*args, **kwargs, out_val=out)
        if not (func.is_view or func in _ALLOCATIONS):
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def aten_costs(fn: Callable, *args) -> dict:
    """{"flops", "bytes"} of the aten ops of one call of `fn(*args)`:
    the matmul FLOPs as torch.utils.flop_counter prices them, and the
    per-op byte accounting of `_CostCounter` (an upper-side count, see the
    module docstring)."""
    with _CostCounter() as counter:
        fn(*args)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes)}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def train_step_min_bytes(state, batch) -> float:
    """Bytes one train step must move at least: every tensor of the
    TrainState read and written once, every batch tensor (segment plans
    included) read once. Activations and all intermediate traffic are left
    out, so this stays a floor."""
    return (2.0 * sum(t.nbytes for t in _tensors(state))
            + sum(t.nbytes for t in _tensors(batch)))


# ---------------------------------------------------------------- roofline


@dataclass
class Roofline:
    aten_flops: float
    aten_bytes: float
    kernels: dict  # kernel_costs
    peaks: dict
    # live bytes a step must move (train_step_min_bytes): the floor's
    # memory term beside the kernels' bytes_lo
    min_bytes: float = 0.0
    # peak class of the aten matmuls: the step's compute dtype ("f32" for a
    # fp32 model, "bf16" for a bf16 one, whose few fp32 products then count
    # at the bf16 peak: the floor stays a floor)
    aten_class: str = "bf16"

    def sol_seconds(self, bound: str = "lo") -> float:
        """max(compute, memory) with the `bound` counts; a measured step
        below sol_seconds("lo") cannot be."""
        k, p = self.kernels, self.peaks
        compute = (self.aten_flops / p[self.aten_class] + k[f"f32_flops_{bound}"] / p["f32"]
                   + k[f"bf16_flops_{bound}"] / p["bf16"])
        nbytes = (self.min_bytes + k["bytes_lo"] if bound == "lo"
                  else self.aten_bytes + k["bytes_hi"])
        return max(compute, nbytes / p["hbm"])

    def total_flops(self, bound: str = "hi") -> float:
        k = self.kernels
        return self.aten_flops + k[f"f32_flops_{bound}"] + k[f"bf16_flops_{bound}"]

    def report(self, measured_seconds: float, on_device: bool = True) -> dict:
        """The bounds, and the shares of the published peaks that a step of
        `measured_seconds` reaches; the shares are None unless the time was
        measured on the card (`on_device`)."""
        sol_lo, sol_hi = self.sol_seconds("lo"), self.sol_seconds("hi")
        flops = self.total_flops("hi")
        bytes_hi = self.aten_bytes + self.kernels["bytes_hi"]
        bytes_lo = self.min_bytes + self.kernels["bytes_lo"]

        def share(x):
            return x if on_device else None

        return {
            "sol_ms_lo": sol_lo * 1e3,
            "sol_ms_hi": sol_hi * 1e3,
            "measured_ms": measured_seconds * 1e3,
            "sol_fraction": share(sol_hi / measured_seconds),
            "mfu_bf16peak": share(flops / measured_seconds / self.peaks["bf16"]),
            "model_flops": flops,
            "model_bytes": bytes_hi,
            "hbm_util": share(bytes_hi / measured_seconds / self.peaks["hbm"]),
            "hbm_util_lo": share(bytes_lo / measured_seconds / self.peaks["hbm"]),
            "min_bytes": self.min_bytes,
            "sol_band": sol_hi / sol_lo if sol_lo > 0 else math.inf,
            "kernel_calls": self.kernels["n_calls"],
            "below_floor": share(measured_seconds < sol_lo),
        }


def speed_of_light(aten: dict, kernels: dict, peaks: dict | None = None, min_bytes: float = 0.0,
                   aten_class: str = "bf16") -> Roofline:
    return Roofline(aten_flops=aten["flops"], aten_bytes=aten["bytes"], kernels=kernels,
                    peaks=dict(H100_DATASHEET, **(peaks or {})), min_bytes=min_bytes,
                    aten_class=aten_class)


# -------------------------------------------------------------- calibration


class CalibrationError(RuntimeError):
    """Calibrated peaks no card could reach: the timing instrument is
    broken, and no share derived from it may be recorded."""


def check_peaks(peaks: dict, datasheet: dict | None = None) -> None:
    """Raise CalibrationError on an impossible calibration:
    - a peak over 1.25x its data-sheet rate: the probe timed less than the
      device work (or fp32 ran as TF32);
    - fp32 at or over 0.9x bf16: fp32 products outside the tensor cores
      cannot approach the tensor cores' bf16 rate, so two probes of the same
      product count in nearly the same time timed overhead, not work."""
    ds = datasheet or H100_DATASHEET
    errs = [f"{k} {peaks[k]:.4g}/s > 1.25x the data sheet's {ds[k]:.4g}/s"
            for k in ("bf16", "f32", "hbm") if peaks[k] > 1.25 * ds[k]]
    if peaks["f32"] >= 0.9 * peaks["bf16"]:
        errs.append(f"f32 {peaks['f32']:.4g} FLOP/s is not well below bf16 "
                    f"{peaks['bf16']:.4g} FLOP/s")
    if errs:
        raise CalibrationError("; ".join(errs))


def _events_seconds(fn, iters: int, windows: int = 3) -> float:
    """Best seconds per call of `fn` over `windows` CUDA-event windows of
    `iters` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / iters)
    return best


def calibrate_peaks(strict: bool = True, datasheet: dict | None = None, device="cuda") -> dict:
    """Measure the card: {"bf16", "f32"} FLOP/s of 8192^3 `torch.matmul`s
    and {"hbm"} bytes/s of a 1 GiB device copy (read + write), each the
    best of three CUDA-event windows. `strict` runs `check_peaks`, which
    raises instead of returning an impossible calibration."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"calibrate_peaks measures a CUDA device, not {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    peaks = {}
    n = 8192
    for name, dtype, iters in (("bf16", torch.bfloat16, 50), ("f32", torch.float32, 5)):
        a = torch.randn(n, n, generator=gen, device=device).to(dtype)
        b = torch.randn(n, n, generator=gen, device=device).to(dtype)
        c = torch.empty(n, n, device=device, dtype=dtype)
        peaks[name] = 2.0 * n**3 / _events_seconds(lambda: torch.matmul(a, b, out=c), iters)
        del a, b, c
    x = torch.ones(1 << 28, device=device)  # 1 GiB of fp32
    y = torch.empty_like(x)
    peaks["hbm"] = 2.0 * x.nbytes / _events_seconds(lambda: y.copy_(x), 20)
    del x, y
    if strict:
        check_peaks(peaks, datasheet)
    return peaks
