"""Probe: can a hand-written kernel beat the library's row gather on the card?

Port of the repository's `scripts/gather_probe.py`, which asked the same of
Pallas on the TPU. At the bench quad shape, a (29184, 32) bf16 table and
192512 int32 indices (seed 0), it times

  - the library gather, `torch.index_select(table, 0, idx)`;
  - P1, `ops.row_gather.gather_rows` (row-major, 16 bytes per thread);
  - P2, `ops.row_gather.gather_rows_fm` on the feature-major table (M, N),
    its output (M, R);

each by device time per launch (20 launches captured in a CUDA graph and
replayed under CUDA events, median of 5 replays, `_cuda.graph_ms`) and, for
P1/P2, by the wrapper-inclusive call time (`_cuda.cuda_ms`), beside the
least time the card could take (the bytes it must move, the indices and the
table read once and the result written once, over 3.35 TB/s), and checks
each result against `table[idx]` bit for bit. The JAX probe chained K
gathers in one dispatch to hide the TPU runtime's per-dispatch cost; the
graph replay leaves the host out in the same way.

    python -m gemnet_pytorch_tpu_torch.scripts.gather_probe

Runs on the card only; exits non-zero without one or when a check fails.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..ops import row_gather
from ..ops._cuda import cuda_ms, graph_ms

N_TAB, M, R = 29184, 32, 192512
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def inputs(device, seed: int = 0):
    """The probe's table, its feature-major copy and the indices."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((N_TAB, M)).astype(np.float32)).to(device)
    table = table.bfloat16()
    idx = torch.from_numpy(rng.integers(0, N_TAB, R).astype(np.int32)).to(device)
    return table, table.t().contiguous(), idx


def bound_ms(r: int = R, m: int = M, n: int = N_TAB) -> float:
    """The r indices and the (n, m) bf16 table read once, the (r, m) result
    written once: a table row that r indices name twice comes from L2, not
    HBM, the second time."""
    return (4 * r + 2 * n * m + 2 * r * m) / PEAK_BYTES_PER_S * 1e3


def main(device="cuda") -> dict:
    """Check and time P1, P2 and the library gather; returns
    {name: {"ms", "library_ms", "bound_ms", "max_abs_err"}}."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the gather probe times kernels on a CUDA device")
    table, tableT, idx = inputs(device)
    ref = table[idx.long()]
    results = {}
    for name, fn, expect, library in (
        ("P1 gather_rows", lambda: row_gather.gather_rows(table, idx), ref,
         lambda: torch.index_select(table, 0, idx)),
        ("P2 gather_rows_fm", lambda: row_gather.gather_rows_fm(tableT, idx), ref.t(),
         lambda: tableT.index_select(1, idx)),
    ):
        out = fn()
        torch.cuda.synchronize()
        err = float((out.float() - expect.float()).abs().max())
        if not torch.equal(out, expect):
            raise AssertionError(f"{name} differs from table[idx] (max abs err {err})")
        results[name] = dict(ms=graph_ms(fn)[0], call_ms=cuda_ms(fn)[0],
                             library_ms=graph_ms(library)[0], bound_ms=bound_ms(),
                             max_abs_err=err)
        r = results[name]
        print(f"{name:18s}: {r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), index_select "
              f"{r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({R * M * 2 / r['ms'] * 1e3 / 1e9:.1f} GB/s out), "
              "bit-equal to table[idx]", flush=True)
    return results


if __name__ == "__main__":
    try:
        print(json.dumps(main()))
    except (RuntimeError, AssertionError) as exc:
        print(f"gather_probe: {exc}", file=sys.stderr)
        sys.exit(1)
