"""Row gathers of a bf16 table: the row-gather probe kernels P1 and P2.

Port of the two Pallas kernels of `scripts/gather_probe.py` (`tal0`,
`tal1`), which asked whether a hand-written kernel beats the framework's own
row gather at the bench quad shape. Nothing on the model's path calls them,
as in the JAX package; `scripts/gather_probe.py` of this package drives them.

    gather_rows(table, idx):      out[r, :] = table[idx[r], :]    (N, M) -> (R, M)
    gather_rows_fm(tableT, idx):  out[:, r] = tableT[:, idx[r]]   (M, N) -> (M, R)

On a CUDA tensor each launches its kernel (`csrc/row_gather.cu`); on a CPU
tensor it runs the plain version (`table[idx]`, `tableT[:, idx]`). The table
is bf16 and 2-D, idx int32 and 1-D, both contiguous; anything else raises.
idx must lie in [0, N): the plain version raises on an index outside, the
kernels write a zero row (column) for it.
"""

from __future__ import annotations

import torch

from . import _cuda


def _gather_rows_plain(table, idx):
    return table[idx.long()]


def _gather_rows_fm_plain(tableT, idx):
    return tableT[:, idx.long()]


def _check(table, idx):
    if table.dtype != torch.bfloat16 or table.ndim != 2:
        raise TypeError(
            f"table is {table.dtype} of {table.ndim} dims; a 2-D bfloat16 table is taken")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"idx is {idx.dtype} of {idx.ndim} dims; 1-D int32 indices are taken")
    if table.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no row gather for device {table.device}")


def gather_rows(table, idx):
    """P1: (R, M) rows table[idx] of an (N, M) bf16 table."""
    _check(table, idx)
    if table.device.type == "cpu":
        return _gather_rows_plain(table, idx)
    _cuda.check_tensor(table, "table", torch.bfloat16, table.device)
    _cuda.check_tensor(idx, "idx", torch.int32, table.device)
    (N, M), R = table.shape, idx.shape[0]
    if M % 8:
        raise ValueError(f"row width {M}: the kernel copies 16-byte vectors, M % 8 == 0")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((R, M), dtype=table.dtype, device=table.device)
    _cuda.launch("gemnet_row_gather", (R, M, N), table.device,
                 table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M, R)
    return out


def gather_rows_fm(tableT, idx):
    """P2: (M, R) columns tableT[:, idx] of a feature-major (M, N) bf16 table."""
    _check(tableT, idx)
    if tableT.device.type == "cpu":
        return _gather_rows_fm_plain(tableT, idx)
    _cuda.check_tensor(tableT, "tableT", torch.bfloat16, tableT.device)
    _cuda.check_tensor(idx, "idx", torch.int32, tableT.device)
    (M, N), R = tableT.shape, idx.shape[0]
    out = torch.empty((M, R), dtype=tableT.dtype, device=tableT.device)
    _cuda.launch("gemnet_row_gather_fm", (R, M, N), tableT.device,
                 tableT.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M, R)
    return out
