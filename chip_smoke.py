#!/usr/bin/env python3
"""Drive the PyTorch port of GemNet (`gemnet_pytorch_tpu_torch`) on one
NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases:
  1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
  2. build the CUDA kernels of `gemnet_pytorch_tpu_torch/csrc/` (one nvcc per
     source, all together) and print their ptxas reports;
  3. hold each kernel (K1 segment_outer_sum, K2 segment_gather_contract,
     K3 sorted segment sum) against its plain PyTorch version on the card, at
     the shapes the serving path gives it on the bench-small batch;
  4. time each kernel, its plain version and, where one PyTorch call computes
     the same function, that call (CUDA events), beside its bound;
  5. serve GemNet-Q at the config.yaml widths (random weights from a seed):
     one predict of the 32-molecule bench-small batch with the launch
     counters read around it (8 / 8 / 14 launches of K1 / K2 / K3), E and F
     against the same model on the CPU (first 8 molecules), then 10 timed
     requests;
  6. the serving calculator on a benzonitrile molecule, 5 perturbed
     geometries, against the same calculator on the CPU.

The last lines are the `{"kernels": [...]}` record, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Any failed check exits non-zero
before those lines. Without a CUDA device it fails at once.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# kernel vs plain version: both sum in fp32, in another order (and the plain
# K3 with atomics); the difference stays at a few ulps of the sums' terms,
# far below this share of the output's magnitude
KERNEL_RTOL = 1e-4
# served E and F on the card vs the CPU: the same fp32 arithmetic through
# four blocks, with other summation orders (atomic index_add on the card)
SERVE_RTOL = 1e-4

# benzonitrile-like C7NH5 geometry (examples/predict.py)
BENZONITRILE_Z = np.array([6, 6, 6, 6, 6, 6, 6, 7, 1, 1, 1, 1, 1])
BENZONITRILE_R = np.array([
    [-1.2131, -0.6884, 0.0], [-1.2028, 0.7064, 0.0001],
    [-0.0103, 1.4246, 0.0001], [1.1939, 0.7196, 0.0], [1.1935, -0.6943, -0.0001],
    [0.0025, -1.4063, -0.0001], [2.4404, -1.4306, -0.0001], [3.4290, -2.0031, 0.0],
    [-2.1577, -1.2205, 0.0], [-2.1393, 1.2535, 0.0001], [-0.0184, 2.5085, 0.0002],
    [2.1301, 1.2735, 0.0], [0.0129, -2.4894, -0.0002],
], dtype=np.float32)

SO_SRC = "gemnet_pytorch_tpu_torch/csrc/segment_outer.cu"
EG_SRC = "gemnet_pytorch_tpu_torch/csrc/expand_gather.cu"


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


# ---------------------------------------------------------------- batches

def bench_molecules(seed: int = 0):
    """bench.py's "small" recipe (bench.py:85-107): 32 molecules of 8-12 atoms."""
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(seed)
    return [random_molecule(rng, int(rng.integers(8, 13))) for _ in range(32)]


def padded_batch(cfg, mols):
    """Padded numpy batch of `mols` with bench.py's dims (5% headroom)."""
    from gemnet_pytorch_tpu_torch.data import PadDims, build_graph, pad_batch, scale_graph_dims

    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    g = build_graph(R, N, cfg.cutoff, cfg.int_cutoff, triplets_only=cfg.triplets_only)
    base = PadDims(n_mol=len(mols), n_atoms=16, n_edges=128, n_triplets=512,
                   kmax3=4, n_int_edges=64, n_intm=512, n_quads=512, kmax4=4)
    dims = base.grow_to(scale_graph_dims(g, 1.05), len(mols), len(Z))
    return pad_batch(g, Z, R, dims, triplets_only=cfg.triplets_only), g


# ---------------------------------------------------------------- kernels

def kernel_cases(cfg, batch, device, seed: int = 0):
    """One case per (kernel, shape) of the serving path: the batch's own id
    columns and sort metadata, random fp32 row data from a seed."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    S3, S4 = cfg.num_spherical, cfg.num_spherical**2
    M3, M4 = cfg.emb_size_trip, cfg.emb_size_quad
    n_e = batch["id_c"].shape[0]
    n_intm = batch["id4_reduce_intm_ca"].shape[0]
    cases = []
    for tag, ids, plan, mask, S, M in (
        ("triplet", "id3_reduce_ca", "id3_reduce_ca_plan", "trip_mask", S3, M3),
        ("quadruplet", "id4_reduce_ca", "id4_reduce_ca_plan", "quad_mask", S4, M4),
    ):
        n = batch[ids].shape[0]
        a, b = rand(n, S), rand(n, M) * batch[mask][:, None]
        cases.append(dict(kernel="K1", tag=tag, a=a, b=b, ids=batch[ids], plan=batch[plan],
                          shape=(n, S, M, n_e)))
        cases.append(dict(kernel="K2", tag=tag, a=a, b=b, ids=batch[ids], plan=batch[plan],
                          cot=rand(S, n_e, M), shape=(n, S, M, n_e)))
    for tag, sort, idx, M, n_src in (
        ("trip_ba", "trip_ba", "id3_expand_ba", M3, n_e),
        ("intm_db", "intm_db", "id4_expand_intm_db", M4, n_e),
        ("quad_abd", "quad_abd", "id4_expand_abd", M4, n_intm),
        ("geometry_abd", "quad_abd", "id4_expand_abd", 3, n_intm),
        ("geometry_cab", "quad_cab", "id4_reduce_cab", 4, n_intm),
    ):
        n = batch[idx].shape[0]
        cases.append(dict(kernel="K3", tag=tag, x=rand(n, M), idx=batch[idx],
                          perm=batch[f"{sort}_perm"], sorted=batch[f"{sort}_sorted"],
                          plan=batch[f"{sort}_plan"], shape=(n, M, n_src)))
    return cases


KERNELS = {
    "K1": dict(name="segment_outer_sum", source=SO_SRC, fn="gemnet_segment_outer_sum_f32",
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:288"),
    "K2": dict(name="segment_gather_contract", source=SO_SRC,
               fn="gemnet_segment_gather_contract_f32",
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:447"),
    "K3": dict(name="sorted_segsum", source=EG_SRC, fn="gemnet_sorted_segsum_f32",
               replaces="gemnet_pytorch_tpu/ops/pallas/expand_gather.py:71"),
}


def case_functions(case):
    """(kernel call, plain call, library call or None) of a case; each
    returns its outputs as a tuple."""
    import torch

    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    k = case["kernel"]
    if k == "K1":
        a, b, ids, plan = case["a"], case["b"], case["ids"], case["plan"]
        n_seg = plan.n_segments
        return ((lambda: (so.outer_sum(a, b, ids, plan),)),
                (lambda: (so._outer_sum_plain(a, b, ids, n_seg),)), None)
    if k == "K2":
        a, b, ids, plan, cot = case["a"], case["b"], case["ids"], case["plan"], case["cot"]
        return ((lambda: so.gather_contract(cot, a, b, ids, plan)),
                (lambda: so._gather_contract_plain(cot, a, b, ids)), None)
    x, idx, perm, srt, plan = case["x"], case["idx"], case["perm"], case["sorted"], case["plan"]
    n_seg = plan.n_segments
    return ((lambda: (eg.sorted_segsum_values(x, perm, srt, plan),)),
            (lambda: (eg._segsum_plain(x[perm.long()], srt, n_seg),)),
            (lambda: (torch.zeros(n_seg, x.shape[1], device=x.device).index_add_(0, idx, x),)))


def case_cost(case) -> tuple[float, float]:
    """(bytes, flops) the function must move and do: each input read once,
    each output written once (fp32 data; the segment structure counted as
    nSeg+1 int32 offsets, K3's permutation as n int32)."""
    k = case["kernel"]
    if k in ("K1", "K2"):
        n, S, M, n_seg = case["shape"]
        rows = 4 * n * (S + M)
        tile = 4 * S * n_seg * M
        offsets = 4 * (n_seg + 1)
        if k == "K1":
            return rows + offsets + tile, 2.0 * n * S * M
        return tile + rows + offsets + rows, 4.0 * n * S * M
    n, M, n_seg = case["shape"]
    return 4 * n * M + 4 * n + 4 * (n_seg + 1) + 4 * n_seg * M, float(n * M)


def cuda_ms(fn, iters: int = 20, windows: int = 5, warmup: int = 3) -> tuple[float, float, float]:
    """(median, min, max) over `windows` CUDA-event windows of `iters` calls
    each, in ms per call, after a warm-up."""
    import torch

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


def compare_kernels(cases):
    """Phase 3: each case's kernel against its plain version."""
    import torch

    results = {}
    for case in cases:
        kernel, plain, _ = case_functions(case)
        outs, refs = kernel(), plain()
        torch.cuda.synchronize()
        err, scale = 0.0, 0.0
        for o, r in zip(outs, refs):
            check(o.shape == r.shape, f"{case['kernel']} {case['tag']}: shape {o.shape} vs {r.shape}")
            check(bool(torch.isfinite(o).all()), f"{case['kernel']} {case['tag']}: non-finite")
            err = max(err, float((o - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
        tol = KERNEL_RTOL * max(scale, 1.0)
        log(f"  {case['kernel']} {case['tag']:13s} shape {case['shape']}: max abs err {err:.3e}"
            f" (rel {err / max(scale, 1e-30):.3e}, tolerance {tol:.3e})")
        check(err <= tol, f"{case['kernel']} {case['tag']} disagrees with its plain version")
        results[(case["kernel"], case["tag"])] = err
    return results


def time_kernels(cases, power: str):
    """Phase 4: ms of kernel, plain version and library call; the bound."""
    rows = {}
    for case in cases:
        kernel, plain, library = case_functions(case)
        nbytes, flops = case_cost(case)
        t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
        ms, ms_lo, ms_hi = cuda_ms(kernel)
        row = dict(
            ms=ms, plain_ms=cuda_ms(plain, iters=5)[0],
            library_ms=cuda_ms(library)[0] if library else None,
            bound_ms=max(t_bytes, t_flops),
            bound_by="bytes" if t_bytes >= t_flops else "operations",
        )
        lib = f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "null"
        log(f"  {case['kernel']} {case['tag']:13s} kernel {ms:.4f} ms ({ms_lo:.4f}-{ms_hi:.4f}), plain "
            f"{row['plain_ms']:.4f} ms, library {lib} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP) [{power}]")
        rows[(case["kernel"], case["tag"])] = row
    return rows


# ---------------------------------------------------------------- serving

def make_model(cfg, device, seed: int = 0):
    import torch

    from gemnet_pytorch_tpu_torch.models import GemNet

    model = GemNet(cfg, generator=torch.Generator().manual_seed(seed), device=device)
    return model.eval().requires_grad_(False)


def predict(model, batch):
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    return energy_and_forces(model, batch)


def close(a, b, rtol: float) -> tuple[bool, float]:
    err = float(np.abs(a - b).max())
    return err <= rtol * max(float(np.abs(b).max()), 1.0), err


def serve(cfg, mols, device, n_compare: int = 8, n_timed: int = 10, warmup: int = 3):
    """Phase 5. Returns the launch census of one predict and the timings."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda

    model = make_model(cfg, device)
    batch_np, g = padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    log(f"  bench-small batch: {len(mols)} molecules, {g.n_edges} edges, {g.n_triplets} "
        f"triplets, {g.n_quads} quadruplets (padded {batch_np['id_c'].shape[0]} / "
        f"{batch_np['id3_reduce_ca'].shape[0]} / {batch_np['id4_reduce_ca'].shape[0]})")

    torch.cuda.synchronize()
    _cuda.reset_launches()
    E, F = predict(model, batch)
    torch.cuda.synchronize()
    census = dict(_cuda.LAUNCHES)
    per_kernel = _cuda.kernel_launches()
    n_mol, n_atoms = len(mols), sum(len(z) for z, _ in mols)
    check(tuple(E.shape) == (batch_np["mol_mask"].shape[0], 1), f"E shape {tuple(E.shape)}")
    check(tuple(F.shape) == (batch_np["R"].shape[0], 1, 3), f"F shape {tuple(F.shape)}")
    check(bool(torch.isfinite(E).all() and torch.isfinite(F).all()), "non-finite E or F")
    log(f"  one predict launched {per_kernel}")

    # the same model on the CPU, where the plain versions run, on the first
    # n_compare molecules (the plain K1/K2 at the full quad space would need
    # (192512, 1568) fp32 temporaries)
    sub_np, _ = padded_batch(cfg, mols[:n_compare])
    E_gpu, F_gpu = predict(model, to_torch(sub_np, device))
    cpu_model = copy.deepcopy(model).to("cpu")
    E_cpu, F_cpu = predict(cpu_model, to_torch(sub_np, "cpu"))
    n_sub = sum(len(z) for z, _ in mols[:n_compare])
    okE, errE = close(E_gpu.cpu().numpy()[:n_compare], E_cpu.numpy()[:n_compare], SERVE_RTOL)
    okF, errF = close(F_gpu.cpu().numpy()[:n_sub], F_cpu.numpy()[:n_sub], SERVE_RTOL)
    log(f"  card vs CPU on the first {n_compare} molecules at full width: max |dE| {errE:.3e},"
        f" max |dF| {errF:.3e} (rtol {SERVE_RTOL})")
    check(okE and okF, "served E/F on the card disagree with the CPU run")

    for _ in range(warmup):
        predict(model, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        predict(model, batch)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / n_timed
    timing = dict(ms_per_request=sec * 1e3, molecules_per_s=n_mol / sec,
                  atoms=n_atoms, max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"  {n_timed} requests of {n_mol} molecules: {timing['ms_per_request']:.3f} ms/request, "
        f"{timing['molecules_per_s']:.1f} molecules/s, max_memory_allocated "
        f"{timing['max_memory_allocated'] / 2**20:.1f} MiB")
    profile_request(model, batch)
    return census, per_kernel, timing


def profile_request(model, batch, top: int = 12) -> None:
    """Where one request's time goes: torch.profiler over one predict, the
    device's busy share of the wall time and the kernels by device time.
    (The profiler slows the host, so its wall time exceeds the timed one.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            predict(model, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
    except (RuntimeError, AttributeError) as exc:  # the profiler is a measurement aid only
        log(f"  profiler breakdown: not measured ({exc})")
        return
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    log(f"  profiled request: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches, "
        f"{n_ops} aten op calls")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def calculator(cfg, device, n_geoms: int = 5, seed: int = 0):
    """Phase 6: the serving calculator on the card against the CPU."""
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator

    model = make_model(cfg, device)
    mol_dev = Molecule(BENZONITRILE_R, BENZONITRILE_Z, cfg.cutoff, cfg.int_cutoff,
                       triplets_only=cfg.triplets_only)
    mol_cpu = copy.deepcopy(mol_dev)
    calc_dev = GemNetCalculator(mol_dev, model, device=device)
    calc_cpu = GemNetCalculator(mol_cpu, copy.deepcopy(model), device="cpu")
    rng = np.random.default_rng(seed)
    for i in range(n_geoms):
        R = BENZONITRILE_R + rng.normal(scale=0.05, size=BENZONITRILE_R.shape).astype(np.float32)
        e_dev, f_dev = calc_dev.calculate(R)
        e_cpu, f_cpu = calc_cpu.calculate(R)
        check(np.isfinite(e_dev) and np.isfinite(f_dev).all(), f"geometry {i}: non-finite")
        okE, errE = close(np.array([e_dev]), np.array([e_cpu]), SERVE_RTOL)
        okF, errF = close(f_dev, f_cpu, SERVE_RTOL)
        log(f"  geometry {i}: E {e_dev:.6f} eV (CPU {e_cpu:.6f}), max |dF| {errF:.3e}")
        check(okE and okF, f"geometry {i}: calculator on the card disagrees with the CPU")


# ---------------------------------------------------------------- main

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    try:
        from gemnet_pytorch_tpu_torch.config import ModelConfig
        from gemnet_pytorch_tpu_torch.data import to_torch
        from gemnet_pytorch_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    power = card_line()

    log("== 1. environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    log("  " + nvcc.stdout.strip().splitlines()[-1])
    log(f"  card: {power}")

    log("== 2. build")
    seconds = _cuda.build()
    log(f"  built {', '.join(_cuda.SOURCES)} in {seconds:.1f} s")
    for source, text in _cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{source}] {line.strip()}")

    cfg = ModelConfig()
    mols = bench_molecules(seed=0)
    batch_np, _ = padded_batch(cfg, mols)
    cases = kernel_cases(cfg, to_torch(batch_np, device), device)

    log("== 3. kernels vs plain versions (bench-small shapes)")
    errors = compare_kernels(cases)

    log(f"== 4. kernel timing [{power}]")
    timings = time_kernels(cases, power)

    log("== 5. serving GemNet-Q (config.yaml widths, random weights, seed 0)")
    census, per_kernel, timing = serve(cfg, mols, device)
    expected = {"K1": 8, "K2": 8, "K3": 14}
    for k, n in expected.items():
        got = per_kernel.get(KERNELS[k]["fn"], 0)
        check(got == n, f"{KERNELS[k]['name']}: {got} launches per predict, expected {n}")

    log("== 6. calculator (benzonitrile, 5 perturbed geometries)")
    calculator(cfg, device)

    kernels = []
    for case in cases:
        key = (case["kernel"], case["tag"])
        info = KERNELS[case["kernel"]]
        kernels.append(dict(
            name=f"{info['name']}[{case['tag']}]", route="cuda", source=info["source"],
            replaces=info["replaces"], launches=census.get((info["fn"], case["shape"]), 0),
            max_abs_err=errors[key], **timings[key]))
    log(f"== kernels on the serving path [{power}]")
    log(f"  {'kernel':36s} {'launches':>8s} {'ms':>8s} {'bound ms':>9s} {'plain ms':>9s} {'library ms':>10s}")
    for row in kernels:
        check(row["launches"] > 0, f"{row['name']} was not launched by the serving path")
        lib = f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "null"
        log(f"  {row['name']:36s} {row['launches']:8d} {row['ms']:8.4f} {row['bound_ms']:9.4f} "
            f"{row['plain_ms']:9.4f} {lib:>10s}")
    log(f"== done in {time.perf_counter() - t_start:.1f} s; serving "
        f"{timing['ms_per_request']:.3f} ms/request, {timing['molecules_per_s']:.1f} molecules/s")
    print(json.dumps({"kernels": kernels}))
    print(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
