"""The port's bench (`gemnet_pytorch_tpu_torch.bench`) on the CPU: its two
workloads equal the repository's `bench.make_batch` array for array, a CPU
run at a small ModelConfig prints one JSON line with the bench's keys and a
null for every share of a device peak, and K steps per call
(`--steps-per-call`, `--large-scan`) add their windows and keys."""

import json

import numpy as np
import pytest
import torch

from gemnet_pytorch_tpu_torch import bench

torch.set_num_threads(2)

# tests/test_bf16.py's widths, 1 block
SMALL = dict(num_spherical=3, num_radial=3, num_blocks=1, emb_size_atom=16, emb_size_edge=16,
             emb_size_trip=8, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
             emb_size_bil_quad=8, emb_size_bil_trip=8)
# the repository bench's real triplets + quadruplets of each workload (seed 0)
N_REAL = {"small": 206_900, "large": 2_420_646}
# keys of the JAX batch that carry the TPU kernels' segment-block width only
TPU_ONLY_KEYS = {"trip_seg_block", "quad_seg_block"}
# every CPU run's keys; the device shares among them are null on the CPU
KEYS = {"metric", "compute_dtype", "small_n_real", "large_n_real", "value", "unit",
        "best_agg_per_s", "small_ms_median", "small_ms_spread", "fwd_ms_median", "rtt_ms",
        "windows", "steps_per_call", "large_scan", "peaks_source", "device", "small_peak_mib"}
ROOFLINE_KEYS = {"sol_ms_lo", "sol_ms_hi", "sol_band", "sol_fraction", "mfu_bf16peak",
                 "hbm_util", "hbm_util_lo", "below_floor", "kernel_calls", "peaks",
                 "calibrated_peaks"}
SHARES = ("sol_fraction", "mfu_bf16peak", "hbm_util", "hbm_util_lo", "below_floor")


@pytest.mark.parametrize("kind", ["small", "large"])
def test_make_batch_matches_the_repository_bench(kind):
    import bench as jax_bench
    from gemnet_pytorch_tpu.config import ModelConfig as JaxModelConfig
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    batch_np, n_real, g, dims, _ = bench.make_batch(ModelConfig(), kind)
    _, ref_n_real, ref_g, ref_dims, ref_np, _ = jax_bench.make_batch(JaxModelConfig(), kind)
    assert n_real == ref_n_real == N_REAL[kind]
    assert (g.n_edges, g.n_triplets, g.n_quads) == (ref_g.n_edges, ref_g.n_triplets,
                                                    ref_g.n_quads)
    assert (dims.n_edges, dims.n_triplets, dims.n_quads, dims.n_intm, dims.kmax4) == (
        ref_dims.n_edges, ref_dims.n_triplets, ref_dims.n_quads, ref_dims.n_intm, ref_dims.kmax4)
    assert set(ref_np) - set(batch_np) == TPU_ONLY_KEYS & set(ref_np)
    assert set(batch_np) <= set(ref_np)
    for key, value in batch_np.items():
        np.testing.assert_array_equal(value, ref_np[key], err_msg=key)
        assert value.dtype == ref_np[key].dtype, key


def test_molecules_refuses_an_unknown_workload():
    with pytest.raises(ValueError, match="workload"):
        bench.molecules("medium")


def _run(capsys, flags):
    out = bench.run(bench.parse_args(["--device", "cpu", "--skip-large", *flags]), SMALL,
                    windows=1, min_window_s=0.0, max_iters=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    return out


def test_cpu_run_prints_the_json_line(capsys):
    """bf16 headline, fp32 A/B and the roofline on the CPU: every key, the
    kernel census of a 1-block bf16 step (6 K1, 6 K2, 12 bf16 K3 and the
    geometry's 8 fp32 K3), and no device share."""
    out = _run(capsys, [])
    f32_keys = {"f32_small_agg", "f32_small_ms", "f32_small_ms_spread"}
    assert KEYS | ROOFLINE_KEYS | f32_keys <= set(out)
    assert out["metric"] == "triplets+quads aggregated/sec/chip (GemNet-Q train step)"
    assert out["compute_dtype"] == "bfloat16" and out["device"] == "cpu"
    assert out["small_n_real"] == N_REAL["small"] and out["large_n_real"] is None
    assert out["value"] == pytest.approx(N_REAL["small"] / out["small_ms_median"] * 1e3)
    # the defaults: one step per call on small; --large-scan 4, here skipped with large
    assert (bench.parse_args([]).steps_per_call, bench.parse_args([]).large_scan) == (1, 4)
    assert out["large_scan"] is None and out["steps_per_call"] == 1 and out["windows"] == 1
    assert "scan_agg_per_s" not in out
    assert out["kernel_calls"] == 32
    assert 0 < out["sol_ms_lo"] <= out["sol_ms_hi"]
    for key in SHARES:
        assert out[key] is None, key
    assert out["calibrated_peaks"] is None and out["peaks_source"].startswith("datasheet")
    assert out["small_peak_mib"] == {"bfloat16": None, "float32": None}
    assert "vs_baseline" not in out and "large_agg_per_s" not in out


def test_cpu_run_fp32_headline_without_roofline_with_profile(capsys, tmp_path):
    """fp32 headline (no A/B block), no roofline, and --profile: the CPU
    trace is written and read back with no device time in it."""
    out = _run(capsys, ["--compute-dtype", "float32", "--skip-roofline",
                        "--profile", str(tmp_path)])
    assert KEYS <= set(out) and not ROOFLINE_KEYS & set(out)
    assert out["compute_dtype"] == "float32" and out["peaks_source"] == "skipped"
    assert "f32_small_agg" not in out
    assert out["small_peak_mib"] == {"float32": None}
    assert (tmp_path / "small" / "trace.json").exists()
    assert out["profile_step_ms"] is None and out["small_device_busy"] is None
    assert set(out["profile_groups_ms"].values()) == {0.0}


@pytest.mark.parametrize("flag", ["--steps-per-call", "--large-scan"])
def test_k_steps_per_call_waits_for_cuda_graphs(capsys, monkeypatch, flag):
    """K steps per call (Trainer.multi_step_fn) on the CPU at a 1-block
    model: `--steps-per-call 2` adds the small workload's scan window and
    its keys; `--large-scan 2` the large workload's (its molecules cut to
    two of 10 atoms here, to keep the CPU run short) with the single step's
    ms less the scan's. A K below 1 raises."""
    if flag == "--steps-per-call":
        out = _run(capsys, ["--skip-roofline", "--skip-f32", flag, "2"])
        assert out["steps_per_call"] == 2 and out["large_scan"] is None
        assert out["scan_ms"] > 0
        assert out["scan_agg_per_s"] == pytest.approx(N_REAL["small"] / out["scan_ms"] * 1e3)
    else:
        real = bench.molecules
        monkeypatch.setattr(bench, "molecules", lambda kind, seed=0: (
            real(kind, seed) if kind == "small" else
            [bench.random_molecule(np.random.default_rng(i), 10) for i in range(2)]))
        out = bench.run(bench.parse_args(["--device", "cpu", "--skip-roofline", "--skip-f32",
                                          flag, "2"]), SMALL, windows=1, min_window_s=0.0,
                        max_iters=1)
        assert out["steps_per_call"] == 1 and out["large_scan"] == 2
        assert "scan_agg_per_s" not in out and out["large_scan_ms"] > 0
        assert out["large_dispatch_overhead_ms"] == pytest.approx(
            out["large_ms_median"] - out["large_scan_ms"])
        assert out["large_scan_agg_per_s"] == pytest.approx(
            out["large_n_real"] / out["large_scan_ms"] * 1e3)
    with pytest.raises(ValueError):
        bench.run(bench.parse_args(["--device", "cpu", flag, "0" if flag[2] == "s" else "-1"]))


def test_without_a_card_the_bench_fails_at_once():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
