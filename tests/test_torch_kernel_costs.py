"""chip_smoke's bound of each K2/K3 case (`case_cost`: the bytes each input
is read once and each output written once, the operations) at the bench-small
shapes, against the byte counts and bounds PERF.md states for them. Runs on
the CPU: the cost is computed from shapes alone."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# (kernel, dtype, shape) -> (MB, bound ms) as PERF.md's kernel table gives them
BENCH = [
    ("K2", "f32", (192512, 49, 32, 3072), 144.0, 0.0430),
    ("K2", "bf16", (192512, 49, 32, 3072), 72.0, 0.0215),
    ("K2", "f32", (25600, 7, 64, 3072), 20.1, 0.0060),
    ("K2", "bf16", (25600, 7, 64, 3072), 10.0, 0.0030),
    ("K3", "f32", (25600, 64, 3072), 7.5, 0.0022),
    ("K3", "bf16", (25600, 64, 3072), 3.8, 0.0011),
    ("K3", "f32", (29184, 32, 3072), 4.3, 0.0013),
    ("K3", "bf16", (29184, 32, 3072), 2.2, 0.0007),
    ("K3", "f32", (192512, 32, 29184), 29.3, 0.0087),
    ("K3", "bf16", (192512, 32, 29184), 15.1, 0.0045),
    ("K3", "f32", (192512, 3, 29184), 3.5, 0.0011),
    ("K3", "f32", (192512, 4, 29184), 4.4, 0.0013),
]


@pytest.mark.parametrize("kernel,dtype,shape,mb,bound_ms", BENCH)
def test_case_cost_matches_perf_md(kernel, dtype, shape, mb, bound_ms):
    nbytes, flops = chip_smoke.case_cost(dict(kernel=kernel, dtype=dtype, shape=shape))
    assert round(nbytes / 1e6, 1) == mb
    t_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    t_flops = flops / chip_smoke.PEAK_FLOPS[dtype] * 1e3
    assert t_bytes > t_flops  # bytes bound every K2/K3 row
    assert round(t_bytes, 4) == bound_ms


def test_k2_quad_counts_every_operand_once():
    """K2 at the quad shape: cot read once, a and b read once, da and db
    written once, the segment offsets; 4 flops per (row, s, m)."""
    n, S, M, n_seg = 192512, 49, 32, 3072
    nbytes, flops = chip_smoke.case_cost(dict(kernel="K2", dtype="f32", shape=(n, S, M, n_seg)))
    assert nbytes == 4 * (S * n_seg * M + 2 * n * (S + M) + n_seg + 1)
    assert flops == 4.0 * n * S * M
