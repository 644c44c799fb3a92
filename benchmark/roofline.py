"""Peaks of the chip and the bytes and operations of a bilinear kernel call.

`PEAKS`: NVIDIA's data sheet for the H100 SXM, dense rates: fp32 outside
the tensor cores (the configurations' precision, TF32 off), bf16 on them,
and HBM3 bytes per second. `kernel_cost` is a frozen copy of the port's
cost of one call of its segment kernels as it stood when the benchmark was
defined (its `perf/roofline.py`): each input read once and each output
written once, 2*n*S*M operations for K1 and 4*n*S*M for K2 (three times
that for the split3 mode, K4), the rows read being the real ones.
"""

from __future__ import annotations

PEAKS = {"f32": 67e12, "bf16": 989e12, "hbm": 3.35e12}
BYTES = {"f32": 4, "bf16": 2, "split3": 4}
FLOP_CLASS = {"f32": "f32", "bf16": "bf16", "split3": "bf16"}


def kernel_cost(kernel: str, dtype: str, shape: tuple, real_rows: int | None = None,
                used_segments: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of one call of K1 or K2 at `shape` = (n rows, S,
    M, n_segments), over `real_rows` of the n and `used_segments` of the
    segments' cotangent tiles where given."""
    w = BYTES[dtype]
    n, S, M, n_seg = shape
    n_eff = n if real_rows is None else real_rows
    seg_eff = n_seg if used_segments is None else used_segments
    offsets = 4 * (n_seg + 1)
    passes = 3 if dtype == "split3" else 1
    if kernel == "K1":
        return (w * n_eff * (S + M) + offsets + w * S * n_seg * M,
                passes * 2.0 * n_eff * S * M)
    if kernel == "K2":
        return (w * S * seg_eff * M + w * n_eff * (S + M) + offsets + w * n * (S + M),
                passes * 4.0 * n_eff * S * M)
    raise ValueError(f"no cost for kernel {kernel!r}")


def bound_s(kernel: str, dtype: str, shape: tuple, real_rows=None, used_segments=None) -> float:
    """The least time a call can take: the larger of its operations over the
    peak of its class and its bytes over the HBM rate."""
    nbytes, ops = kernel_cost(kernel, dtype, shape, real_rows, used_segments)
    return max(ops / PEAKS[FLOP_CLASS[dtype]], nbytes / PEAKS["hbm"])


# the C entries of the port's bilinear kernels: (kernel, stream dtype)
ENTRIES = {
    "gemnet_segment_outer_sum_f32": ("K1", "f32"),
    "gemnet_segment_outer_sum_bf16": ("K1", "bf16"),
    "gemnet_segment_outer_sum_split3": ("K1", "split3"),
    "gemnet_segment_gather_contract_f32": ("K2", "f32"),
    "gemnet_segment_gather_contract_bf16": ("K2", "bf16"),
    "gemnet_segment_gather_contract_split3": ("K2", "split3"),
}
