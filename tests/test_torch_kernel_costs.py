"""chip_smoke's bound of each K1/K2/K3/K4 case (`case_cost`: the bytes each input
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
    ("K1", "f32", (192512, 49, 32, 3072), 81.7, 0.0244),
    ("K1", "bf16", (192512, 49, 32, 3072), 40.8, 0.0122),
    ("K1", "f32", (25600, 7, 64, 3072), 12.8, 0.0038),
    ("K1", "bf16", (25600, 7, 64, 3072), 6.4, 0.0019),
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
    # K4, the split3 mode of K1/K2: K1's and K2's fp32 bytes
    ("K1", "split3", (192512, 49, 32, 3072), 81.7, 0.0244),
    ("K2", "split3", (192512, 49, 32, 3072), 144.0, 0.0430),
    ("K1", "split3", (25600, 7, 64, 3072), 12.8, 0.0038),
    ("K2", "split3", (25600, 7, 64, 3072), 20.1, 0.0060),
]


@pytest.mark.parametrize("kernel,dtype,shape,mb,bound_ms", BENCH)
def test_case_cost_matches_perf_md(kernel, dtype, shape, mb, bound_ms):
    nbytes, flops = chip_smoke.case_cost(dict(kernel=kernel, dtype=dtype, shape=shape))
    assert round(nbytes / 1e6, 1) == mb
    t_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    t_flops = flops / chip_smoke.PEAK_FLOPS[dtype] * 1e3
    assert t_bytes > t_flops  # bytes bound every K1/K2/K3/K4 row
    assert round(t_bytes, 4) == bound_ms


def test_k2_quad_counts_every_operand_once():
    """K2 at the quad shape: cot read once, a and b read once, da and db
    written once, the segment offsets; 4 flops per (row, s, m)."""
    n, S, M, n_seg = 192512, 49, 32, 3072
    nbytes, flops = chip_smoke.case_cost(dict(kernel="K2", dtype="f32", shape=(n, S, M, n_seg)))
    assert nbytes == 4 * (S * n_seg * M + 2 * n * (S + M) + n_seg + 1)
    assert flops == 4.0 * n * S * M


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("shape", [(192512, 49, 32, 3072), (25600, 7, 64, 3072)])
def test_split3_moves_fp32_bytes_for_three_times_the_flops(kernel, shape):
    """K4 reads and writes the fp32 rows and tiles of K1/K2 and does their
    products three times (hi*hi + hi*lo + lo*hi), on the tensor cores."""
    f32 = chip_smoke.case_cost(dict(kernel=kernel, dtype="f32", shape=shape))
    split3 = chip_smoke.case_cost(dict(kernel=kernel, dtype="split3", shape=shape))
    assert split3[0] == f32[0]
    assert split3[1] == 3 * f32[1]
    assert chip_smoke.PEAK_FLOPS["split3"] == chip_smoke.PEAK_FLOPS["bf16"]
