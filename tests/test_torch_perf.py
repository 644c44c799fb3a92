"""The port's measurement modules (`gemnet_pytorch_tpu_torch/perf/`) on the
CPU, as tests/test_roofline.py holds the JAX package's: the value-fetch
windows against a wall clock, the calibration checks, the kernel census of
a train step against the launches the kernels would make, the ordering of
the cost bounds and the below-floor flag, the aten counts of one Dense
layer, and the profiler trace written and read back (a CPU trace, and a
written device trace whose attribution is known)."""

import json
import time

import pytest
import torch

from gemnet_pytorch_tpu_torch.perf import roofline, trace
from gemnet_pytorch_tpu_torch.perf.roofline import H100_DATASHEET, CalibrationError, check_peaks
from gemnet_pytorch_tpu_torch.perf.timing import fetch_scalar, measure_rtt, timed_windows

torch.set_num_threads(2)

# tests/test_roofline.py's widths
TINY = dict(num_spherical=3, num_radial=3, num_blocks=1, emb_size_atom=16, emb_size_edge=16,
            emb_size_trip=8, emb_size_quad=4, emb_size_rbf=4, emb_size_cbf=4, emb_size_sbf=4,
            emb_size_bil_quad=4, emb_size_bil_trip=8)
# launches of one config.yaml (4-block) train step, as chip_smoke.py pins them
TRAIN_LAUNCHES_4 = {
    "float32": {"gemnet_segment_outer_sum_f32": 24, "gemnet_segment_gather_contract_f32": 24,
                "gemnet_sorted_segsum_f32": 50},
    "bfloat16": {"gemnet_segment_outer_sum_bf16": 24, "gemnet_segment_gather_contract_bf16": 24,
                 "gemnet_sorted_segsum_bf16": 42, "gemnet_sorted_segsum_f32": 8},
    "high": {"gemnet_segment_outer_sum_split3": 24,
             "gemnet_segment_gather_contract_split3": 24, "gemnet_sorted_segsum_f32": 50},
}
# of the K3 launches, those that come once a step, whatever the number of
# blocks: the geometry's 8 (fp32 in every mode: the edges' R[id_c], R[id_a]
# twice, the triplet rows' two gathers, the quadruplet angles' two) and the
# embedding's h[id_c], h[id_a] in the loss's backward
ONCE_A_STEP_K3 = {"gemnet_sorted_segsum_f32": 8}
EMBEDDING_K3 = 2


def _launches(mode: str, blocks: int) -> dict:
    """TRAIN_LAUNCHES_4 scaled to `blocks` interaction blocks."""
    once = dict(ONCE_A_STEP_K3)
    h_fn = "gemnet_sorted_segsum_bf16" if mode == "bfloat16" else "gemnet_sorted_segsum_f32"
    once[h_fn] = once.get(h_fn, 0) + EMBEDDING_K3
    out = {}
    for fn, n in TRAIN_LAUNCHES_4[mode].items():
        fixed = once.get(fn, 0)
        out[fn] = (n - fixed) * blocks // 4 + fixed
    return out


def _trainer(mode: str, blocks: int = 1):
    from gemnet_pytorch_tpu_torch import bench
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch

    cfg = ModelConfig(**dict(TINY, num_blocks=blocks),
                      compute_dtype="float32" if mode == "high" else mode,
                      matmul_precision="high" if mode == "high" else "default")
    batch_np, g, dims = bench.padded_batch(cfg, bench.molecules("small")[:4])
    trainer, state = bench.make_trainer(cfg, TrainConfig(warmup_steps=1), "cpu")
    return trainer, state, to_torch(batch_np, "cpu"), g, dims


# ------------------------------------------------------------------ timing


def test_timed_windows_agrees_with_wall_clock():
    """A chained op timed in value-fetch windows reads within 10x of a plain
    wall clock of the same chained calls (test_roofline.py's bound)."""
    rtt = measure_rtt()
    assert rtt >= 0
    w = torch.full((256, 256), 1.0 / 256.0)
    box = {"x": torch.ones(256, 256)}

    def once():
        box["x"] = box["x"] @ w
        return box["x"][0, 0]

    res = timed_windows(once, windows=2, min_window_s=0.05)
    assert res["iters"] >= 10 and res["median_s"] > 0
    assert res["spread_s"] == max(res["windows_s"]) - min(res["windows_s"])
    assert set(res) == {"best_s", "median_s", "spread_s", "windows_s", "iters", "rtt_s",
                        "total_s"}
    n, y = res["iters"], torch.ones(256, 256)
    t0 = time.perf_counter()
    for _ in range(n):
        y = y @ w
    fetch_scalar(y[0, 0])
    wall = (time.perf_counter() - t0) / n
    assert wall / 10 - 1e-3 < res["median_s"] < wall * 10 + 1e-3


def test_timed_windows_takes_at_most_max_iters():
    calls = []

    def once():
        calls.append(1)
        return torch.zeros(())

    res = timed_windows(once, windows=2, min_window_s=10.0, max_iters=3, rtt_s=0.0)
    assert res["iters"] == 3 and len(calls) == 3 + 2 * 3  # pilot, then two windows


# ------------------------------------------------------------- calibration


def test_check_peaks_accepts_the_data_sheet():
    check_peaks(dict(H100_DATASHEET))
    check_peaks({"bf16": 700e12, "f32": 50e12, "hbm": 3.0e12})


@pytest.mark.parametrize("key", ["bf16", "f32", "hbm"])
def test_check_peaks_rejects_over_the_data_sheet(key):
    peaks = dict(H100_DATASHEET, **{key: 1.3 * H100_DATASHEET[key]})
    if key == "f32":  # keep f32 below 0.9x bf16: only the data-sheet check may fire
        peaks["bf16"] = 1.2 * H100_DATASHEET["bf16"]
    with pytest.raises(CalibrationError, match=key):
        check_peaks(peaks)


@pytest.mark.parametrize("ratio", [0.9, 1.0, 1.5])
def test_check_peaks_rejects_f32_near_bf16(ratio):
    """fp32 at or over 0.9x bf16: the probes timed overhead (or TF32)."""
    with pytest.raises(CalibrationError, match="not well below"):
        check_peaks({"bf16": 60e12, "f32": ratio * 60e12, "hbm": 3e12})


def test_calibrate_peaks_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.calibrate_peaks(device="cpu")


# ------------------------------------------------------------------ census


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "high"])
def test_kernel_census_of_a_train_step(mode, blocks):
    """One CPU train step's census: the launches a card step makes
    (chip_smoke.py's TRAIN_LAUNCHES for 4 blocks, scaled), each record's
    kernel, direction, dtype and shape consistent with its C entry; the CPU
    launches nothing."""
    from gemnet_pytorch_tpu_torch.ops import _cuda

    trainer, state, batch, g, dims = _trainer(mode, blocks)
    _cuda.reset_launches()
    census = roofline.kernel_census(trainer.train_step, state, batch, 1.0)
    assert not _cuda.LAUNCHES and not _cuda.CENSUSES
    counts = {}
    for c in census:
        counts[c["fn"]] = counts.get(c["fn"], 0) + 1
    assert counts == _launches(mode, blocks)
    for c in census:
        kernel, direction, dtype, fn, shape = (c[k] for k in ("kernel", "direction", "dtype",
                                                               "fn", "shape"))
        assert fn.endswith("_" + dtype)
        if fn.startswith("gemnet_sorted_segsum"):
            assert (kernel, direction) == ("K3", "backward") and len(shape) == 3
            continue
        forward = fn.startswith("gemnet_segment_outer_sum")
        assert direction == ("forward" if forward else "backward")
        assert kernel == ("K4" if dtype == "split3" else "K1" if forward else "K2")
        n, S, M, n_seg = shape
        assert n in (dims.n_triplets, dims.n_quads) and n_seg == dims.n_edges


def test_kernel_census_closes_on_error():
    from gemnet_pytorch_tpu_torch.ops import _cuda

    def boom():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        roofline.kernel_census(boom)
    assert not _cuda.CENSUSES


# ------------------------------------------------------------------- costs


def test_kernel_costs_lo_is_at_most_hi():
    trainer, state, batch, g, dims = _trainer("bfloat16")
    census = roofline.kernel_census(trainer.train_step, state, batch, 1.0)
    real_rows = {dims.n_triplets: g.n_triplets, dims.n_quads: g.n_quads, dims.n_intm: g.n_intm}
    used = {dims.n_edges: g.n_edges, dims.n_int_edges: g.n_int_edges}
    k = roofline.kernel_costs(census, real_rows, used)
    assert k["n_calls"] == len(census) == 32
    for key in ("bytes", "f32_flops", "bf16_flops"):
        assert 0 <= k[f"{key}_lo"] <= k[f"{key}_hi"]
    assert k["bytes_lo"] < k["bytes_hi"] and k["bf16_flops_lo"] < k["bf16_flops_hi"]
    # the geometry K3s are fp32: the only fp32 operations of a bf16 step
    assert 0 < k["f32_flops_lo"]
    padded = roofline.kernel_costs(census)
    assert padded["bytes_lo"] == padded["bytes_hi"] == k["bytes_hi"]


def test_kernel_costs_price_k4_as_split3_k1_and_k2():
    shape = (192512, 49, 32, 3072)
    census = [dict(kernel="K4", direction="forward", dtype="split3", shape=shape),
              dict(kernel="K4", direction="backward", dtype="split3", shape=shape)]
    k = roofline.kernel_costs(census)
    b1, f1 = roofline.kernel_cost("K1", "f32", shape)
    b2, f2 = roofline.kernel_cost("K2", "f32", shape)
    assert k["bytes_hi"] == b1 + b2
    assert k["bf16_flops_hi"] == 3 * (f1 + f2) and k["f32_flops_hi"] == 0


def test_roofline_bounds_and_below_floor():
    kernels = dict(f32_flops_lo=1e9, f32_flops_hi=2e9, bf16_flops_lo=1e10, bf16_flops_hi=2e10,
                   bytes_lo=1e8, bytes_hi=5e8, n_calls=74)
    rl = roofline.speed_of_light({"flops": 1e11, "bytes": 2e10}, kernels, min_bytes=1e7,
                                 aten_class="f32")
    lo, hi = rl.sol_seconds("lo"), rl.sol_seconds("hi")
    assert 0 < lo <= hi
    assert hi == pytest.approx(max(1e11 / 67e12 + 2e9 / 67e12 + 2e10 / 989e12,
                                   (2e10 + 5e8) / 3.35e12))
    below = rl.report(0.5 * lo)
    assert below["below_floor"] is True and below["kernel_calls"] == 74
    above = rl.report(10 * hi)
    assert above["below_floor"] is False
    assert above["sol_fraction"] == pytest.approx(0.1)
    assert above["sol_ms_lo"] <= above["sol_ms_hi"] and above["sol_band"] >= 1
    cpu = rl.report(10 * hi, on_device=False)
    for key in ("sol_fraction", "mfu_bf16peak", "hbm_util", "hbm_util_lo", "below_floor"):
        assert cpu[key] is None
    assert cpu["sol_ms_lo"] == above["sol_ms_lo"]


def test_aten_costs_of_a_dense_layer():
    """A lone Dense layer: 2*n*in*out FLOPs, and at least its input, weight
    and output bytes."""
    from gemnet_pytorch_tpu_torch.models.layers import Dense

    n, d_in, d_out = 40, 16, 24
    layer = Dense(d_in, d_out, generator=torch.Generator().manual_seed(0))
    x = torch.randn(n, d_in)
    with torch.no_grad():
        costs = roofline.aten_costs(layer, x)
    assert costs["flops"] == 2 * n * d_in * d_out
    assert costs["bytes"] >= 4 * (n * d_in + d_in * d_out + n * d_out)


def test_train_step_min_bytes_counts_state_twice_and_batch_once():
    trainer, state, batch, _, _ = _trainer("float32")
    st = state.opt_state
    state_bytes = sum(t.nbytes for t in (state.step, state.params, state.ema_params,
                                         state.metric_acc, st.count, st.mu, st.nu, st.nu_max,
                                         st.wd_mask, st.shared_scale))
    batch_bytes = 0
    for v in batch.values():
        tensors = [v] if isinstance(v, torch.Tensor) else [t for t in v
                                                            if isinstance(t, torch.Tensor)]
        batch_bytes += sum(t.nbytes for t in tensors)
    assert roofline.train_step_min_bytes(state, batch) == 2 * state_bytes + batch_bytes


# ------------------------------------------------------------------- trace


def test_trace_written_and_read_back_on_the_cpu(tmp_path):
    """A CPU trace: the ranges are found, and the device summary is empty."""
    w = torch.randn(64, 64)
    path = trace.record_trace(lambda: (w @ w).sum(), 3, str(tmp_path), "step", "cpu")
    assert path == str(tmp_path / "trace.json")
    mods = trace.module_times(str(tmp_path))
    assert mods["step"].count == 3 and mods["step"].total_ms == 0.0
    assert trace.step_device_ms(path) is None
    assert trace.op_times(path) == {}
    assert set(trace.op_category_summary(path).values()) == {0.0}
    assert "(no device events in trace)" in trace.summarize(path)


def _device_trace(tmp_path):
    """A trace in torch.profiler's chrome format: two "step" ranges on the
    main thread, launches on it and on the autograd thread, kernels that
    run after their range ended, and a launch outside every range."""
    ev = [
        dict(ph="X", cat="user_annotation", name="step", ts=0, dur=100, tid=1),
        dict(ph="X", cat="user_annotation", name="step", ts=200, dur=100, tid=1),
    ]
    kernels = [  # (launch ts, thread, kernel name, kernel dur in us)
        (10, 1, "void outer_sum_ffma_ring<float>(float const*)", 50.0),
        (20, 2, "void gather_contract_split3_ring(float const*)", 30.0),
        (90, 1, "void at::native::vectorized_elementwise_kernel<4>(int)", 5.0),
        (250, 2, "void at::native::indexing_backward_kernel<float>(long)", 7.0),
        (260, 1, "sm90_xmma_gemm_f32f32_tn", 11.0),
        (400, 1, "void sorted_segsum_kernel<float>(float const*)", 1000.0),
    ]
    for i, (ts, tid, name, dur) in enumerate(kernels):
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=2,
                       tid=tid, args=dict(correlation=i)))
        ev.append(dict(ph="X", cat="kernel", name=name, ts=ts + 80, dur=dur, tid=7,
                       args=dict(correlation=i)))
    ev.append(dict(ph="X", cat="gpu_memset", name="Memset (Device)", ts=270, dur=3.0, tid=7,
                   args=dict(correlation=99)))
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaMemsetAsync", ts=265, dur=1, tid=1,
                   args=dict(correlation=99)))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_trace_attributes_device_time_to_the_ranges(tmp_path):
    path = _device_trace(tmp_path)
    mt = trace.step_device_ms(path, match="step")
    assert mt.count == 2
    assert mt.total_ms == pytest.approx((50 + 30 + 5 + 7 + 11 + 3) / 1e3)
    assert mt.mean_ms == pytest.approx(mt.total_ms / 2)
    cats = trace.op_category_summary(path, n_execs=2)
    assert cats["K1"] == pytest.approx(0.025) and cats["K4_backward"] == pytest.approx(0.015)
    assert cats["K3"] == pytest.approx(0.5) and cats["gemm"] == pytest.approx(0.0055)
    assert cats["other"] == pytest.approx(0.0015)
    assert "K4_backward" in trace.summarize(path, n_execs=2)


def test_trace_attributes_graph_replayed_kernels_to_the_step(tmp_path):
    """A captured step's kernels carry the correlation id of the
    cudaGraphLaunch (runtime; cuGraphLaunch, driver) that replayed the
    graph, and run after its range ended: they count under the "step"
    range holding the replay, each replay's under its own; a replay
    outside every range counts nowhere, and a memcpy into the graph's
    static input inside the range counts."""
    ev = [dict(ph="X", cat="user_annotation", name="step", ts=t, dur=50, tid=1)
          for t in (0, 1000)]
    replays = [(10, "cuda_runtime", "cudaGraphLaunch", 1), (1010, "cuda_driver",
                                                            "cuGraphLaunch", 2),
               (3000, "cuda_runtime", "cudaGraphLaunch", 3)]
    for ts, cat, name, corr in replays:
        ev.append(dict(ph="X", cat=cat, name=name, ts=ts, dur=20, tid=1,
                       args=dict(correlation=corr)))
        for j, (kernel, dur) in enumerate((("void outer_sum_ffma_ring<7>(float const*)", 40.0),
                                           ("void sorted_segsum_kernel<float, 4>(int)", 10.0),
                                           ("void at::native::elementwise_kernel<128>", 2.0))):
            ev.append(dict(ph="X", cat="kernel", name=kernel, ts=ts + 100 + 60 * j, dur=dur,
                           tid=7, args=dict(correlation=corr)))
    ev.append(dict(ph="X", cat="cuda_runtime", name="cudaMemcpyAsync", ts=5, dur=2, tid=1,
                   args=dict(correlation=9)))
    ev.append(dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoD (Device -> Device)", ts=60,
                   dur=4.0, tid=7, args=dict(correlation=9)))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    mt = trace.step_device_ms(str(path), match="step")
    assert mt.count == 2 and mt.total_ms == pytest.approx((2 * 52 + 4) / 1e3)
    assert trace.module_times(str(path))["step"].mean_ms == pytest.approx(0.054)
    cats = trace.op_category_summary(str(path), n_execs=3)
    assert cats["K1"] == pytest.approx(0.04) and cats["K3"] == pytest.approx(0.01)


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::outer_sum_mma_ring<__nv_bfloat16>(...)", "K1"),
    ("void (anonymous namespace)::outer_sum_warp_kernel<float>(...)", "K1"),
    ("void (anonymous namespace)::gather_contract_kernel<float>(...)", "K2"),
    ("void (anonymous namespace)::sorted_segsum_kernel<float>(...)", "K3"),
    ("void (anonymous namespace)::outer_sum_split3_warp(...)", "K4_forward"),
    ("void (anonymous namespace)::gather_contract_split3_warp(...)", "K4_backward"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>(long)", "gather"),
    ("void at::native::(anonymous namespace)::indexing_backward_kernel<float, 4>",
     "gather_backward"),
    ("void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true, "
     "at::native::ReduceAdd>(...)", "gather_backward"),
    ("void at::native::indexSelectLargeIndex<float, long, unsigned int, 2, 2, -2, true>(...)",
     "gather"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm"),
    ("void at::native::reduce_kernel<512, 1>(...)", "other"),
    ("Memcpy HtoD (Pageable -> Device)", "other"),
])
def test_categorize_op(name, group):
    assert trace.categorize_op(name) == group
