#!/usr/bin/env python3
"""Drive the PyTorch port of GemNet (`gemnet_pytorch_tpu_torch`) on one
NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py          # from the root of the repository

Phases:
  1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
  2. build the CUDA kernels of `gemnet_pytorch_tpu_torch/csrc/` (one nvcc per
     source, all together) and print their ptxas reports;
  3. hold each kernel (K1 segment_outer_sum, K2 segment_gather_contract,
     K3 sorted segment sum, on fp32 and on bf16 streams; K4, the split3 mode
     of K1 and K2; the row-gather probe kernels P1 and P2) against its plain
     PyTorch version on the card, at the shapes the serving path, the train
     step and the probe give it (K4 also against the exact fp32 K1/K2; K1
     and K4, forward and backward at both shapes, bit-equal across two
     replays of one captured CUDA graph, their merge trees' counters back
     at zero, the triplet K4 forward's tree among them; K1, K2, K3 and K4
     bit-equal across two launches; the triplet K4 backward, a warp per
     work item with split3 FFMAs, against its plain version and exact
     fp32, across two launches and two graph replays, as every K4);
  4. time each kernel and, where one PyTorch call computes the same
     function, that call, both ways: device time per launch (`ms`,
     `library_ms`: 20 calls captured in a CUDA graph, replayed under CUDA
     events) and the wrapper-inclusive call time (`call_ms`,
     `library_call_ms`: CUDA events around a host loop of 20 calls); and the
     plain version's call time; beside the bound;
  5. serve GemNet-Q at the config.yaml widths (random weights from a seed):
     one predict of the 32-molecule bench-small batch with the launch
     counters read around it (8 / 8 / 14 launches of K1 / K2 / K3), E and F
     against the same model on the CPU (first 8 molecules), then 10 timed
     requests; then one predict in matmul_precision="high" (8 / 8 split3
     K1 / K2, 14 fp32 K3, no exact K1/K2), against the CPU, and profiled;
  6. the serving calculator on a benzonitrile molecule, 5 perturbed
     geometries, against the same calculator on the CPU;
  7. train GemNet-Q at the config.yaml widths (random weights from seed 0) on
     the bench-small batch with toy targets: one fp32 step on the card
     against the same step on the CPU (first 8 molecules); bf16 E/F against
     fp32 on the card (tests/test_bf16.py's contract at its widths; at the
     config.yaml widths, for 5 weight seeds, beside the error of bf16-rounded
     weights alone, and bf16 on the card against bf16 on the CPU);
     one train step per dtype with the launch counters read
     around it (pinned counts, every bf16 kernel launched); 5 bf16 steps with
     falling losses and fp32 master state; an eval on the EMA weights; then
     3 warm-up and 10 timed steps and one profiled step per dtype (its
     device time, and that of K1-K4 summed by kernel name, K4 also split
     into its forward and backward);
  8. the training entry point in matmul_precision="high": one step on the
     card against the CPU, its launch census (24 / 24 split3 K1 / K2, 26 fp32
     K3, no exact K1/K2), `gemnet_pytorch_tpu_torch.train.run` on a synthetic
     dataset (20 steps, eval and checkpoint every 10), resumed from its
     checkpoint with the state equal bit for bit, its reference export loaded
     back, and 10 timed "high" steps;
  9. the row-gather probe (`gemnet_pytorch_tpu_torch.scripts.gather_probe`).

The last lines are the `{"kernels": [...]}` record, the card's name and power
limit, and `{"ok": true, "device": {...}}`. Any failed check exits non-zero
before those lines. Without a CUDA device it fails at once.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s of the tensor cores
PEAK_BYTES_PER_S = 3.35e12
# (split3: fp32 rows in and out, bf16 products on the tensor cores)
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "split3": 989e12}
BYTES = {"f32": 4, "bf16": 2, "split3": 4}
# kernel vs plain version: both sum in fp32, in another order (and the plain
# K3 with atomics); the difference stays at a few ulps of the sums' terms,
# far below this share of the output's magnitude
KERNEL_RTOL = {"f32": 1e-4,
               # bf16 streams: fp32 sums in other orders, rounded once to
               # bf16, may differ by one bf16 ulp (2^-7 relative at most)
               "bf16": 2.0**-7,
               # split3: the same bf16 products, exact in fp32, summed in
               # fp32 in another order (the tensor cores' and the CPU's)
               "split3": 1e-5}
# split3 vs the exact fp32 K1/K2: the JAX package's bound
# (tests/test_segment_outer.py:155-158), share of max |exact|
SPLIT3_EXACT_RTOL = 3e-5
# served E and F on the card vs the CPU: the same fp32 arithmetic through
# four blocks, with other summation orders (atomic index_add on the card)
SERVE_RTOL = 1e-4
# one fp32 train step on the card vs the CPU: the loss, and the relative L2
# error of the whole parameter update (not elementwise: a weight whose
# gradient is ~0 may take either sign of Adam's first ~lr*sign(g) step)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_UPDATE_REL_L2 = 1e-3
# bf16 vs fp32 predictions, share of the fp32 magnitude: tests/test_bf16.py's
# contract, held at that test's widths (TEST_BF16_WIDTHS). At the config.yaml
# widths the random weights' energies are small residuals of the blocks'
# contributions: rounding the fp32 weights alone to bf16 already moves E by
# more than 0.03 of |E| (phase 7 prints it per seed), so there the bound only
# catches a gross fault (a wrong cast or kernel errs by the output's own
# magnitude)
BF16_E_REL, BF16_F_REL = 0.03, 0.05
BF16_FULL_WIDTH_REL = 0.15
# bf16 on the card vs the same bf16 model on the CPU (the plain versions), at
# the config.yaml widths on the first 8 molecules, per weight seed: the same
# roundings, with fp32 sums in other orders, so a sum near a rounding boundary
# may round the other way and carry through four blocks. Share of the CPU's
# magnitude, E and F. On an H100 seeds 0-4 read at most 0.036 (E) and 0.044
# (F), the same in three runs; and each seed's reading stays below that
# seed's bf16 vs fp32 on the same molecules (at most 0.60 of it), which a
# card path that rounds elsewhere than the CPU's would not
BF16_SEEDS = (0, 1, 2, 3, 4)
BF16_CARD_VS_CPU = 0.06
TEST_BF16_WIDTHS = dict(
    num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16, emb_size_edge=16,
    emb_size_trip=8, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=8)
# launches of each kernel entry in one train step, from the autograd graph:
# forward 8 K1 (4 blocks x triplet + quadruplet bilinear); the -dE/dR
# backward 8 K2 and 14 K3 (4 blocks x trip_ba, intm_db, quad_abd + the two
# geometry gathers); the loss backward 8 K2 (the forward K1s), 2 K1 + 1 K2
# for each of the 8 first-backward K2s, and 12 K3 (the forward's 12 network
# gathers; the geometry gathers lead to R only). In bf16 the geometry K3s
# stay fp32.
TRAIN_LAUNCHES = {
    "float32": {"gemnet_segment_outer_sum_f32": 24, "gemnet_segment_gather_contract_f32": 24,
                "gemnet_sorted_segsum_f32": 26},
    "bfloat16": {"gemnet_segment_outer_sum_bf16": 24, "gemnet_segment_gather_contract_bf16": 24,
                 "gemnet_sorted_segsum_bf16": 24, "gemnet_sorted_segsum_f32": 2},
    # matmul_precision="high": every K1/K2 in split3, the K3s exact fp32
    "high": {"gemnet_segment_outer_sum_split3": 24,
             "gemnet_segment_gather_contract_split3": 24, "gemnet_sorted_segsum_f32": 26},
}
SERVE_LAUNCHES = {
    "default": {"gemnet_segment_outer_sum_f32": 8, "gemnet_segment_gather_contract_f32": 8,
                "gemnet_sorted_segsum_f32": 14},
    "high": {"gemnet_segment_outer_sum_split3": 8, "gemnet_segment_gather_contract_split3": 8,
             "gemnet_sorted_segsum_f32": 14},
}
# phase 8's run of the training entry point: a synthetic dataset of 64
# molecules of 4-12 atoms (seed 0), batches of 32, eval and checkpoint every
# 10 steps; the lr at its full 1e-3 from step 0
TRAIN_RUN = dict(batch_size=32, num_steps=20, evaluation_interval=10, save_interval=10,
                 data_seed=0, warmup_steps=1, matmul_precision="high")
TRAIN_RUN_MOLECULES = 64

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
RG_SRC = "gemnet_pytorch_tpu_torch/csrc/row_gather.cu"


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
    """Padded numpy batch of `mols` with bench.py's dims (5% headroom) and
    its toy energy/force targets."""
    from gemnet_pytorch_tpu_torch.data import PadDims, build_graph, pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import toy_energy_forces

    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    g = build_graph(R, N, cfg.cutoff, cfg.int_cutoff, triplets_only=cfg.triplets_only)
    base = PadDims(n_mol=len(mols), n_atoms=16, n_edges=128, n_triplets=512,
                   kmax3=4, n_int_edges=64, n_intm=512, n_quads=512, kmax4=4)
    dims = base.grow_to(scale_graph_dims(g, 1.05), len(mols), len(Z))
    EF = [toy_energy_forces(z, r) for z, r in mols]
    E = np.array([e for e, _ in EF], np.float32)
    F = np.concatenate([f for _, f in EF])
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=cfg.triplets_only), g


# ---------------------------------------------------------------- kernels

def kernel_cases(cfg, batch, device, seed: int = 0):
    """One case per (kernel, shape, stream dtype) of the serving path and
    the train step: the batch's own id columns and sort metadata, random row
    data from a seed (rounded to bf16 for the bf16 cases; the geometry
    streams are fp32 in both modes; fp32 rows for split3, which runs K1 and
    K2 only); and P1/P2 on the gather probe's inputs."""
    import torch

    from gemnet_pytorch_tpu_torch.scripts import gather_probe

    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    S3, S4 = cfg.num_spherical, cfg.num_spherical**2
    M3, M4 = cfg.emb_size_trip, cfg.emb_size_quad
    n_e = batch["id_c"].shape[0]
    n_intm = batch["id4_reduce_intm_ca"].shape[0]
    cases = []
    for dtype in ("f32", "bf16", "split3"):
        cast = (lambda t: t.bfloat16()) if dtype == "bf16" else (lambda t: t)
        for tag, ids, plan, mask, S, M in (
            ("triplet", "id3_reduce_ca", "id3_reduce_ca_plan", "trip_mask", S3, M3),
            ("quadruplet", "id4_reduce_ca", "id4_reduce_ca_plan", "quad_mask", S4, M4),
        ):
            n = batch[ids].shape[0]
            a, b = cast(rand(n, S)), cast(rand(n, M) * batch[mask][:, None])
            common = dict(tag=tag, dtype=dtype, a=a, b=b, ids=batch[ids], plan=batch[plan],
                          shape=(n, S, M, n_e))
            cases.append(dict(kernel="K1", **common))
            cases.append(dict(kernel="K2", cot=cast(rand(S, n_e, M)), **common))
        for tag, sort, idx, M, n_src in (
            ("trip_ba", "trip_ba", "id3_expand_ba", M3, n_e),
            ("intm_db", "intm_db", "id4_expand_intm_db", M4, n_e),
            ("quad_abd", "quad_abd", "id4_expand_abd", M4, n_intm),
            ("geometry_abd", "quad_abd", "id4_expand_abd", 3, n_intm),
            ("geometry_cab", "quad_cab", "id4_reduce_cab", 4, n_intm),
        ):
            if dtype == "split3" or (dtype == "bf16" and tag.startswith("geometry")):
                continue
            n = batch[idx].shape[0]
            cases.append(dict(kernel="K3", tag=tag, dtype=dtype, x=cast(rand(n, M)),
                              idx=batch[idx], perm=batch[f"{sort}_perm"],
                              sorted=batch[f"{sort}_sorted"], plan=batch[f"{sort}_plan"],
                              shape=(n, M, n_src)))
    table, tableT, idx = gather_probe.inputs(device)
    shape = (idx.shape[0], table.shape[1], table.shape[0])  # (R, M, N)
    cases.append(dict(kernel="P1", tag="probe", dtype="bf16", table=table, idx=idx, shape=shape))
    cases.append(dict(kernel="P2", tag="probe", dtype="bf16", table=tableT, idx=idx, shape=shape))
    return cases


KERNELS = {
    "K1": dict(name="segment_outer_sum", source=SO_SRC, fn="gemnet_segment_outer_sum_{}",
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:288"),
    "K2": dict(name="segment_gather_contract", source=SO_SRC,
               fn="gemnet_segment_gather_contract_{}",
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:447"),
    "K3": dict(name="sorted_segsum", source=EG_SRC, fn="gemnet_sorted_segsum_{}",
               replaces="gemnet_pytorch_tpu/ops/pallas/expand_gather.py:71"),
    "P1": dict(name="row_gather", source=RG_SRC, fn="gemnet_row_gather",
               replaces="scripts/gather_probe.py:74"),
    "P2": dict(name="row_gather_fm", source=RG_SRC, fn="gemnet_row_gather_fm",
               replaces="scripts/gather_probe.py:99"),
}
# K4: the split3 branches of K1's and K2's TPU kernels
SPLIT3_KERNELS = {
    "K1": dict(name="segment_outer_sum_split3", source=SO_SRC,
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:355"),
    "K2": dict(name="segment_gather_contract_split3", source=SO_SRC,
               replaces="gemnet_pytorch_tpu/ops/pallas/segment_outer.py:499"),
}


def kernel_info(case) -> dict:
    """name, source and replaces of a case's kernel (K4 for split3 cases)."""
    if case["dtype"] == "split3":
        return SPLIT3_KERNELS[case["kernel"]]
    return KERNELS[case["kernel"]]


def kernel_fn(case) -> str:
    """The C entry a case launches, e.g. gemnet_segment_outer_sum_bf16."""
    return KERNELS[case["kernel"]]["fn"].format(case["dtype"])


def case_functions(case):
    """(kernel call, plain call, library call or None) of a case; each
    returns its outputs as a tuple."""
    import torch

    from gemnet_pytorch_tpu_torch.ops import expand_gather as eg
    from gemnet_pytorch_tpu_torch.ops import row_gather as rg
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    k = case["kernel"]
    split3 = case["dtype"] == "split3"
    precision = "split3" if split3 else "exact"
    if k == "K1":
        a, b, ids, plan = case["a"], case["b"], case["ids"], case["plan"]
        n_seg = plan.n_segments
        plain = so._outer_sum_split3_plain if split3 else so._outer_sum_plain
        return ((lambda: (so.outer_sum(a, b, ids, plan, precision),)),
                (lambda: (plain(a, b, ids, n_seg),)), None)
    if k == "K2":
        a, b, ids, plan, cot = case["a"], case["b"], case["ids"], case["plan"], case["cot"]
        plain = so._gather_contract_split3_plain if split3 else so._gather_contract_plain
        return ((lambda: so.gather_contract(cot, a, b, ids, plan, precision)),
                (lambda: plain(cot, a, b, ids)), None)
    if k in ("P1", "P2"):
        table, idx = case["table"], case["idx"]
        if k == "P1":
            return ((lambda: (rg.gather_rows(table, idx),)),
                    (lambda: (rg._gather_rows_plain(table, idx),)),
                    (lambda: (torch.index_select(table, 0, idx),)))
        return ((lambda: (rg.gather_rows_fm(table, idx),)),
                (lambda: (rg._gather_rows_fm_plain(table, idx),)),
                (lambda: (table.index_select(1, idx),)))
    x, idx, perm, srt, plan = case["x"], case["idx"], case["perm"], case["sorted"], case["plan"]
    n_seg = plan.n_segments
    return ((lambda: (eg.sorted_segsum_values(x, perm, srt, plan),)),
            (lambda: (eg._segsum_plain(x[perm.long()], srt, n_seg),)),
            (lambda: (torch.zeros(n_seg, x.shape[1], device=x.device, dtype=x.dtype)
                      .index_add_(0, idx, x),)))


def case_cost(case) -> tuple[float, float]:
    """(bytes, flops) the function must move and do: each input read once,
    each output written once (row data at the case's dtype; the segment
    structure counted as nSeg+1 int32 offsets, K3's permutation as n int32;
    split3 does three bf16 products per fp32 one; P1/P2 read the indices and
    the N-row table once, since a row read twice comes from L2, write R rows,
    and do no arithmetic)."""
    k, w = case["kernel"], BYTES[case["dtype"]]
    if k in ("P1", "P2"):
        R, M, N = case["shape"]
        return 4 * R + w * N * M + w * R * M, 0.0
    if k in ("K1", "K2"):
        n, S, M, n_seg = case["shape"]
        rows = w * n * (S + M)
        tile = w * S * n_seg * M
        offsets = 4 * (n_seg + 1)
        passes = 3 if case["dtype"] == "split3" else 1
        if k == "K1":
            return rows + offsets + tile, passes * 2.0 * n * S * M
        return tile + rows + offsets + rows, passes * 4.0 * n * S * M
    n, M, n_seg = case["shape"]
    return w * n * M + 4 * n + 4 * (n_seg + 1) + w * n_seg * M, float(n * M)


def case_label(case) -> str:
    return f"{case['kernel']} {case['tag']:12s} {case['dtype']}"


def max_err(case, outs, refs) -> tuple[float, float]:
    """(max abs difference, max |ref|) over a case's outputs."""
    import torch

    err, scale = 0.0, 0.0
    for o, r in zip(outs, refs):
        check(o.shape == r.shape and o.dtype == r.dtype,
              f"{case_label(case)}: {o.shape} {o.dtype} vs {r.shape} {r.dtype}")
        o, r = o.float(), r.float()
        check(bool(torch.isfinite(o).all()), f"{case_label(case)}: non-finite")
        err = max(err, float((o - r).abs().max()))
        scale = max(scale, float(r.abs().max()))
    return err, scale


def compare_kernels(cases):
    """Phase 3: each case's kernel against its plain version (P1/P2 bit for
    bit), K1-K4 bit-equal across two launches; K1 and K4 bit-equal across
    two replays of a captured graph; K4 also against the exact fp32 plain
    K1/K2."""
    import torch

    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    results = {}
    for case in cases:
        kernel, plain, _ = case_functions(case)
        outs, refs = kernel(), plain()
        torch.cuda.synchronize()
        err, scale = max_err(case, outs, refs)
        if case["kernel"] in ("P1", "P2"):
            tol = 0.0
            check(all(torch.equal(o, r) for o, r in zip(outs, refs)),
                  f"{case_label(case)} is not bit-equal to table[idx]")
        else:
            tol = KERNEL_RTOL[case["dtype"]] * max(scale, 1.0)
        log(f"  {case_label(case)} shape {case['shape']}: max abs err {err:.3e}"
            f" (rel {err / max(scale, 1e-30):.3e}, tolerance {tol:.3e})")
        check(err <= tol, f"{case_label(case)} disagrees with its plain version")
        if case["kernel"] in ("K1", "K2", "K3"):
            # no float atomics: a second launch writes the same bits
            again = kernel()
            torch.cuda.synchronize()
            check(all(torch.equal(o, r) for o, r in zip(outs, again)),
                  f"{case_label(case)} differs between two launches")
        if case["kernel"] == "K1" or case["dtype"] == "split3":
            # one captured launch replayed twice: the same bits as the eager
            # launch, so the merge tree's arrival counters return to zero
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = kernel()
            replays = []
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                replays.append([t.clone() for t in captured])
            del graph
            check(all(torch.equal(o, r1) and torch.equal(o, r2)
                      for o, r1, r2 in zip(outs, *replays)),
                  f"{case_label(case)} differs between two replays of its captured graph")
            check(int(case["plan"].tree_arrivals.abs().sum()) == 0,
                  f"{case_label(case)} left its merge tree's arrival counters non-zero")
        if case["dtype"] == "split3":
            a, b, ids = case["a"], case["b"], case["ids"]
            exact = ((so._outer_sum_plain(a, b, ids, case["plan"].n_segments),)
                     if case["kernel"] == "K1" else
                     so._gather_contract_plain(case["cot"], a, b, ids))
            # per output (K2: da and db), as tests/test_segment_outer.py:155-158
            rel = [e / max(x, 1e-30) for e, x in (max_err(case, (o,), (r,))
                                                  for o, r in zip(outs, exact))]
            log(f"    vs the exact fp32 plain version: max abs err / max |exact| "
                f"{', '.join(f'{r:.3e}' for r in rel)} (tolerance {SPLIT3_EXACT_RTOL:.0e})")
            check(max(rel) <= SPLIT3_EXACT_RTOL,
                  f"{case_label(case)} is farther from exact fp32 than split3's bound")
            check(min(rel) > 0, f"{case_label(case)} equals exact fp32: split3 did not run")
        results[(case["kernel"], case["tag"], case["dtype"])] = err
    return results


def time_kernels(cases, power: str):
    """Phase 4: per call, the kernel's and the library call's device time
    (`ms`, `library_ms`: CUDA-graph replay, no host in the window) and their
    wrapper-inclusive time (`call_ms`, `library_call_ms`: CUDA events around
    the host loop of calls); the plain version's call time; the bound."""
    from gemnet_pytorch_tpu_torch.ops._cuda import cuda_ms, graph_ms

    def fmt(x):
        return f"{x:.4f}" if x is not None else "null"

    rows = {}
    for case in cases:
        kernel, plain, library = case_functions(case)
        nbytes, flops = case_cost(case)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_flops = flops / PEAK_FLOPS[case["dtype"]] * 1e3
        ms, ms_lo, ms_hi = graph_ms(kernel)
        row = dict(
            ms=ms, call_ms=cuda_ms(kernel)[0], plain_ms=cuda_ms(plain, iters=5)[0],
            library_ms=graph_ms(library)[0] if library else None,
            library_call_ms=cuda_ms(library)[0] if library else None,
            bound_ms=max(t_bytes, t_flops),
            bound_by="bytes" if t_bytes >= t_flops else "operations",
        )
        log(f"  {case_label(case)} kernel {ms:.4f} ms ({ms_lo:.4f}-{ms_hi:.4f}), call "
            f"{row['call_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{fmt(row['library_ms'])} ms (call {fmt(row['library_call_ms'])}), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP) [{power}]")
        rows[(case["kernel"], case["tag"], case["dtype"])] = row
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
    """Phase 5. Returns the launch census of one predict, the timings and
    its energies."""
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
    profile(lambda: predict(model, batch), "request")
    return census, per_kernel, timing, E.cpu().numpy()


# the hand-written kernels' device functions, by the names the profiler
# shows (K1 is outer_sum_ffma_ring (fp32) / outer_sum_mma_ring (bf16) at the
# quadruplet shape, outer_sum_warp_kernel at the triplet shape and
# outer_sum_kernel at other shapes; K4's backward is
# gather_contract_split3_ring at the quadruplet shape,
# gather_contract_split3_warp (a warp per work item, split3 FFMAs) at the
# triplet shape and gather_contract_split3_kernel at other shapes and on
# unaligned tensors, its forward outer_sum_split3_ring at the quadruplet
# shape, outer_sum_split3_warp (K1's warp kernel with split3 products) at
# the triplet shape and outer_sum_split3_kernel at other shapes. The merge
# kernel of K1's general kernel also serves K4's wmma forward, at shapes the
# model does not give: it counts under K1)
PROFILE_GROUPS = {
    "K1": ("outer_sum_kernel", "outer_sum_merge_kernel", "outer_sum_ffma_ring",
           "outer_sum_mma_ring", "outer_sum_warp_kernel"),
    "K2": ("gather_contract_",),
    "K3": ("sorted_segsum_",),
    "K4": ("outer_sum_split3_", "gather_contract_split3_"),
}
# K4's device functions by direction
K4_DIRECTIONS = dict(zip(("forward", "backward"), PROFILE_GROUPS["K4"]))


def profile_group(key: str) -> str | None:
    """The PROFILE_GROUPS kernel a profiler key names, or None."""
    if "split3" in key:
        return "K4" if any(p in key for p in PROFILE_GROUPS["K4"]) else None
    for group, prefixes in PROFILE_GROUPS.items():
        if any(p in key for p in prefixes):
            return group
    return None


def profile(fn, what: str, top: int = 12) -> dict | None:
    """Where one call's time goes: torch.profiler over one `fn()`, the
    device's busy share of the wall time, the kernels by device time, and
    the device ms of K1-K4 summed by group (PROFILE_GROUPS), which it
    returns. (The profiler slows the host, so its wall time exceeds the
    timed one.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
    except (RuntimeError, AttributeError) as exc:  # the profiler is a measurement aid only
        log(f"  profiler breakdown: not measured ({exc})")
        return None
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    log(f"  profiled {what}: wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in kernels)} kernel launches, "
        f"{n_ops} aten op calls")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    groups = {g: [0.0, 0] for g in PROFILE_GROUPS}
    for e in kernels:
        g = profile_group(e.key)
        if g:
            groups[g][0] += e.self_device_time_total / 1e3
            groups[g][1] += e.count
    k4 = {d: sum(e.self_device_time_total for e in kernels if prefix in e.key) / 1e3
          for d, prefix in K4_DIRECTIONS.items()}
    log(f"  {what}, hand-written kernels' device ms (launches): "
        + ", ".join(f"{g} {ms:.3f} ({n})" for g, (ms, n) in groups.items())
        + f"; K4 forward {k4['forward']:.3f}, backward {k4['backward']:.3f}")
    return dict(device_ms=busy_us / 1e3, **{g: ms for g, (ms, _) in groups.items()},
                **{f"K4_{d}": ms for d, ms in k4.items()})


def serve_high(cfg, mols, device, exact_E):
    """Phase 5, "high": one predict of the bench-small batch in
    matmul_precision="high" with the launch counters read around it, E/F
    against the same "high" model on the CPU (first 8 molecules, the plain
    split3 versions) and E against the exact predict of phase 5 on the card;
    then one profiled "high" predict. Returns the census."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(cfg, matmul_precision="high")
    model = make_model(cfg, device)
    batch_np, _ = padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    E, F = predict(model, batch)
    torch.cuda.synchronize()
    census, per_kernel = dict(_cuda.LAUNCHES), _cuda.kernel_launches()
    log(f"  one 'high' predict launched {per_kernel}")
    check(per_kernel == SERVE_LAUNCHES["high"],
          f"'high' predict launched {per_kernel}, expected {SERVE_LAUNCHES['high']}")
    check(bool(torch.isfinite(E).all() and torch.isfinite(F).all()), "non-finite 'high' E or F")
    n_mol = len(mols)
    _, errE = close(E.cpu().numpy()[:n_mol], exact_E[:n_mol], 1.0)
    log(f"  'high' vs exact on the card: max |dE| {errE:.3e} of max |E| "
        f"{float(np.abs(exact_E[:n_mol]).max()):.3e}")

    sub_np, _ = padded_batch(cfg, mols[:8])
    E_gpu, F_gpu = predict(model, to_torch(sub_np, device))
    E_cpu, F_cpu = predict(copy.deepcopy(model).to("cpu"), to_torch(sub_np, "cpu"))
    n_sub = sum(len(z) for z, _ in mols[:8])
    okE, errE = close(E_gpu.cpu().numpy()[:8], E_cpu.numpy()[:8], SERVE_RTOL)
    okF, errF = close(F_gpu.cpu().numpy()[:n_sub], F_cpu.numpy()[:n_sub], SERVE_RTOL)
    log(f"  'high' card vs CPU on the first 8 molecules: max |dE| {errE:.3e}, max |dF| "
        f"{errF:.3e} (rtol {SERVE_RTOL})")
    check(okE and okF, "'high' E/F on the card disagree with the CPU run")
    profile(lambda: predict(model, batch), "'high' request")
    return census


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


# ---------------------------------------------------------------- training

def make_trainer(cfg, compute_dtype: str, device, seed: int = 0):
    """A Trainer of GemNet(cfg) in `compute_dtype`, weights from `seed` (the
    same in both dtypes), at config.yaml's training hyperparameters with the
    learning rate at its full 1e-3 from step 0 (warmup_steps=1), as
    tests/test_bf16.py's train step."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = GemNet(dataclasses.replace(cfg, compute_dtype=compute_dtype),
                   generator=torch.Generator().manual_seed(seed), device=device)
    trainer = Trainer(model, TrainConfig(warmup_steps=1))
    return trainer, trainer.init_state()


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def step_card_vs_cpu(cfg, mols, device, label: str):
    """One fp32 train step (weights from seed 0) on the card and on the CPU
    on `mols`: the loss within TRAIN_LOSS_RTOL, the whole update within a
    relative L2 error of TRAIN_UPDATE_REL_L2."""
    sub_np, _ = padded_batch(cfg, mols)
    steps = {}
    for dev in (device, "cpu"):
        trainer, state = make_trainer(cfg, "float32", dev)
        p0 = state.params.clone()
        state, loss = trainer.train_on_batch(state, sub_np, 1.0)
        steps[str(dev)] = (float(loss), (state.params - p0).cpu().numpy())
    (loss_gpu, d_gpu), (loss_cpu, d_cpu) = steps[str(device)], steps["cpu"]
    rel = rel_l2(d_gpu, d_cpu)
    log(f"  {label} step, card vs CPU on the first {len(mols)} molecules: loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rtol {TRAIN_LOSS_RTOL}), update rel L2 {rel:.3e} "
        f"(limit {TRAIN_UPDATE_REL_L2})")
    check(abs(loss_gpu - loss_cpu) <= TRAIN_LOSS_RTOL * abs(loss_cpu),
          f"{label} train-step loss on the card disagrees with the CPU")
    check(rel <= TRAIN_UPDATE_REL_L2,
          f"{label} parameter update on the card disagrees with the CPU")


def params_view(model, flat) -> bool:
    """Every parameter of `model` is a view of `flat`, in order."""
    off = 0
    for p in model.parameters():
        if p.data_ptr() != flat.data_ptr() + off * flat.element_size():
            return False
        off += p.numel()
    return off == flat.numel()


def one_step_census(trainer, state, batch, label: str):
    """One train step with the launch counters read around it: (state, loss,
    census by kernel and shape, launches by kernel)."""
    import torch

    from gemnet_pytorch_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    state, loss = trainer.train_on_batch(state, batch, 1.0)
    torch.cuda.synchronize()
    per_kernel = _cuda.kernel_launches()
    log(f"  one {label} train step launched {per_kernel}")
    return state, loss, dict(_cuda.LAUNCHES), per_kernel


def timed_steps(trainer, state, batch, n_agg: int, label: str, n_timed: int = 10,
                warmup: int = 3) -> dict:
    """`warmup` then `n_timed` steps on the host clock, ending in a
    synchronize; then one profiled step."""
    import torch

    for _ in range(warmup):
        trainer.train_on_batch(state, batch, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        trainer.train_on_batch(state, batch, 1.0)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / n_timed
    timing = dict(ms_per_step=sec * 1e3, agg_per_s=n_agg / sec,
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"  {label}: {n_timed} timed steps, {timing['ms_per_step']:.3f} ms/step, "
        f"{timing['agg_per_s']:.4e} triplets+quads/s ({n_agg} real rows), "
        f"max_memory_allocated {timing['max_memory_allocated'] / 2**20:.1f} MiB")
    timing["profile"] = profile(lambda: trainer.train_on_batch(state, batch, 1.0),
                                f"{label} train step")
    return timing


def train(cfg, mols, device, n_compare: int = 8, n_steps: int = 5):
    """Phase 7. Returns the launch census of one train step per dtype and
    the timings."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.training import Metrics

    # fp32 on the card vs the CPU, one step on the first n_compare molecules
    step_card_vs_cpu(cfg, mols[:n_compare], device, "fp32")
    sub_np, _ = padded_batch(cfg, mols[:n_compare])

    batch_np, g = padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    n_mol, n_atoms = len(mols), sum(len(z) for z, _ in mols)
    n_agg = g.n_triplets + g.n_quads
    runs = {dt: make_trainer(cfg, dt, device) for dt in ("float32", "bfloat16")}

    # bf16 vs fp32 predictions of the same weights
    def predictions(trainer, state, batch, n_mol, n_atoms):
        E, _, F, _ = trainer.predict(state, batch)
        check(E.dtype == F.dtype == torch.float32, "predictions are not fp32")
        return E.cpu().numpy()[:n_mol], F.cpu().numpy()[:n_atoms]

    def errors(pred, ref):
        return tuple(float(np.abs(p - r).max() / np.abs(r).max()) for p, r in zip(pred, ref))

    small_cfg = dataclasses.replace(cfg, **TEST_BF16_WIDTHS)
    small = {dt: predictions(*make_trainer(small_cfg, dt, device), batch, n_mol, n_atoms)
             for dt in ("float32", "bfloat16")}
    eE, eF = errors(small["bfloat16"], small["float32"])
    log(f"  bf16 vs fp32 on the card at tests/test_bf16.py's widths: max |dE| {eE:.3e} of |E| "
        f"(limit {BF16_E_REL}), max |dF| {eF:.3e} of |F| (limit {BF16_F_REL})")
    check(eE < BF16_E_REL and eF < BF16_F_REL, "bf16 predictions outside the bf16 contract")

    # at the config.yaml widths, per weight seed: bf16 vs fp32 on the card,
    # fp32 with the weights rounded to bf16 vs fp32, and bf16 on the card vs
    # bf16 on the CPU (first n_compare molecules)
    sub_atoms = sum(len(z) for z, _ in mols[:n_compare])
    readings = {}
    for seed in BF16_SEEDS:
        fp_trainer, fp_state = make_trainer(cfg, "float32", device, seed)
        ref = predictions(fp_trainer, fp_state, batch, n_mol, n_atoms)
        bf_trainer, bf_state = make_trainer(cfg, "bfloat16", device, seed)
        bf16 = predictions(bf_trainer, bf_state, batch, n_mol, n_atoms)
        rounded_trainer, rounded_state = make_trainer(cfg, "float32", device, seed)
        with torch.no_grad():
            rounded_state.params.copy_(rounded_state.params.bfloat16().float())
        rounded = predictions(rounded_trainer, rounded_state, batch, n_mol, n_atoms)
        card = predictions(bf_trainer, bf_state, sub_np, n_compare, sub_atoms)
        cpu = predictions(*make_trainer(cfg, "bfloat16", "cpu", seed), sub_np, n_compare,
                          sub_atoms)
        card_fp32 = predictions(fp_trainer, fp_state, sub_np, n_compare, sub_atoms)
        readings[seed] = (errors(bf16, ref), errors(card, cpu), errors(card, card_fp32))
        (eE, eF), (cE, cF), (sE, sF) = readings[seed]
        wE, wF = errors(rounded, ref)
        log(f"  seed {seed}, config.yaml widths: bf16 vs fp32 on the card E {eE:.3e}, F {eF:.3e} "
            f"(limit {BF16_FULL_WIDTH_REL}); fp32 with bf16-rounded weights vs fp32 E {wE:.3e}, "
            f"F {wF:.3e}; first {n_compare} molecules: bf16 card vs CPU E {cE:.3e}, F {cF:.3e} "
            f"(limit {BF16_CARD_VS_CPU}), bf16 vs fp32 on the card E {sE:.3e}, F {sF:.3e}")
        del fp_trainer, fp_state, bf_trainer, bf_state, rounded_trainer, rounded_state
    for seed, ((eE, eF), (cE, cF), (sE, sF)) in readings.items():
        check(eE < BF16_FULL_WIDTH_REL and eF < BF16_FULL_WIDTH_REL,
              f"seed {seed}: bf16 predictions at the config.yaml widths far from fp32")
        check(cE <= BF16_CARD_VS_CPU and cF <= BF16_CARD_VS_CPU and cE < sE and cF < sF,
              f"seed {seed}: bf16 predictions on the card disagree with the CPU")

    census, per_kernel, timing = {}, {}, {}
    for dt, (trainer, state) in runs.items():
        state, loss, census[dt], per_kernel[dt] = one_step_census(trainer, state, batch, dt)
        losses = [float(loss)]
        for _ in range(n_steps - 1):
            state, loss = trainer.train_on_batch(state, batch, 1.0)
            losses.append(float(loss))
        log(f"  {dt}: {n_steps} steps, losses {', '.join(f'{x:.6f}' for x in losses)}")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
              f"{dt} losses are not finite and falling")
        st = state.opt_state
        check(all(t.dtype == torch.float32 for t in
                  (state.params, state.ema_params, st.mu, st.nu, st.nu_max,
                   *trainer.model.parameters())),
              f"{dt}: parameters, optimizer state or EMA not fp32")
        drained = Metrics("train", trainer.tracked_metrics)
        state = trainer.drain_metrics(state, drained)
        check(all(np.isfinite(v) for v in drained.result().values()),
              f"{dt}: non-finite drained metrics")
        val = Metrics("val", trainer.tracked_metrics)
        val_loss = trainer.test_on_batch(state, batch, val, use_ema=True)
        log(f"  {dt}: eval on the EMA weights, "
            f"{', '.join(f'{k} {v:.6f}' for k, v in val.result(append_tag=False).items())}")
        check(np.isfinite(val_loss), f"{dt}: non-finite EMA eval")
        timing[dt] = timed_steps(trainer, state, batch, n_agg, dt)
    return census, per_kernel, timing


def train_high(cfg, mols, device, workdir: str):
    """Phase 8: the training entry point in matmul_precision="high". Returns
    the launch census of one "high" step and its timing."""
    import dataclasses
    import logging.handlers
    import os
    import shutil

    import torch

    from gemnet_pytorch_tpu_torch import train as train_driver
    from gemnet_pytorch_tpu_torch.compat import strip_reference_aliases
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import PlateauState, restore_checkpoint, restore_params
    from gemnet_pytorch_tpu_torch.training.checkpoint import state_tensors
    from gemnet_pytorch_tpu_torch.training.flat_opt import bind_parameters

    hcfg = dataclasses.replace(cfg, matmul_precision="high")
    step_card_vs_cpu(hcfg, mols[:8], device, "'high'")

    batch_np, g = padded_batch(hcfg, mols)
    batch = to_torch(batch_np, device)
    trainer, state = make_trainer(hcfg, "float32", device)
    state, _, census, per_kernel = one_step_census(trainer, state, batch, "'high'")
    check(per_kernel == TRAIN_LAUNCHES["high"],
          f"'high' train step launched {per_kernel}, expected {TRAIN_LAUNCHES['high']}")

    # the entry point: 20 steps, eval and checkpoint every 10, with export
    run_dir = os.path.join(workdir, "run")
    export = os.path.join(workdir, "export.pth")
    config = dict(dataclasses.asdict(hcfg), **TRAIN_RUN, restart=run_dir, logdir=workdir)
    t0 = time.perf_counter()
    best = train_driver.run(config, device=device, synthetic_molecules=TRAIN_RUN_MOLECULES,
                            export_torch=export)
    log(f"  train.run, {TRAIN_RUN['num_steps']} steps on {TRAIN_RUN_MOLECULES} synthetic "
        f"molecules in {time.perf_counter() - t0:.1f} s: best {best}")
    check(all(np.isfinite(v) for v in best.values()), "train.run: non-finite metrics")
    for rel in ("logs/checkpoint", "logs/checkpoint.plateau.npz", "best/model",
                "best/best_metrics.npz"):
        check(os.path.exists(os.path.join(run_dir, rel)), f"train.run wrote no {rel}")
    ckpt = os.path.join(run_dir, "logs", "checkpoint")
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    with np.load(ckpt + ".plateau.npz", allow_pickle=True) as d:
        saved_plateau = {k: d[k].item() for k in d.files}
    check(int(saved["step"]) == TRAIN_RUN["num_steps"], f"checkpoint at step {int(saved['step'])}")

    # resumed: the run restarts from its step-20 checkpoint (its log says so)
    # and ends at step 30; and the step-20 checkpoint restores into a fresh
    # state (other weights) bit for bit, in the buffer its model's
    # parameters view
    step20 = os.path.join(workdir, "checkpoint-20")
    for suffix in ("", ".plateau.npz"):
        shutil.copyfile(ckpt + suffix, step20 + suffix)
    root = logging.getLogger()
    records, level = logging.handlers.BufferingHandler(1 << 20), root.level
    root.addHandler(records)
    root.setLevel(logging.INFO)
    try:
        train_driver.run(dict(config, num_steps=30), device=device,
                         synthetic_molecules=TRAIN_RUN_MOLECULES)
    finally:
        root.removeHandler(records)
        root.setLevel(level)
    restored_at = [r.args[0] for r in records.buffer
                   if r.msg == "restored checkpoint at step %d"]
    end = int(torch.load(ckpt, map_location="cpu", weights_only=True)["step"])
    fresh_trainer, fresh_state = make_trainer(hcfg, "float32", device, seed=1)
    fresh_state, fresh_plateau = restore_checkpoint(step20, fresh_state, PlateauState())
    tensors = state_tensors(fresh_state)
    equal = all(torch.equal(tensors[k].cpu(), v) for k, v in saved.items())
    plateau_equal = fresh_plateau.state_dict() == saved_plateau
    views = params_view(fresh_trainer.model, fresh_state.params)
    log(f"  resumed run: restored at step {restored_at}, ended at step {end}; the step-20 "
        f"checkpoint in a fresh state: bit-equal {equal}, plateau equal {plateau_equal}, "
        f"parameters views of the state {views}")
    check(restored_at == [TRAIN_RUN["num_steps"]] and end == 30,
          "train.run did not resume from its checkpoint")
    check(equal and plateau_equal and views,
          "the checkpoint does not restore in place bit for bit")

    # the export, aliases dropped, loads strictly and predicts as the final
    # EMA weights (it is them); the best model (the EMA weights at the best
    # eval) loads strictly and predicts finite energies
    ref_sd = torch.load(export, map_location="cpu", weights_only=True)
    exported = GemNet(hcfg, generator=torch.Generator().manual_seed(1), device=device)
    exported.load_state_dict(strip_reference_aliases(ref_sd), strict=True)
    final_ema = GemNet(hcfg, generator=torch.Generator().manual_seed(2), device=device)
    bind_parameters(final_ema, saved["ema_params"].to(device))
    best_model = restore_params(os.path.join(run_dir, "best/model"),
                                GemNet(hcfg, generator=torch.Generator().manual_seed(3),
                                       device=device))
    one = to_torch(padded_batch(hcfg, mols[:8])[0], device)
    preds = [predict(m.requires_grad_(False), one)[0].cpu().numpy()[:8]
             for m in (exported, final_ema, best_model)]
    ok, err = close(preds[0], preds[1], SERVE_RTOL)
    log(f"  export: {len(ref_sd)} keys ({len(strip_reference_aliases(ref_sd))} without the "
        f"aliases); E on 8 molecules vs the final EMA weights: max |dE| {err:.3e}; best model "
        f"(step {int(best['step_best'])}): max |E| {float(np.abs(preds[2]).max()):.3e}")
    check(ok, "the exported weights do not predict as the final EMA weights")
    check(bool(np.isfinite(preds[2]).all()), "the best model predicts non-finite energies")

    timing = timed_steps(trainer, state, batch, g.n_triplets + g.n_quads, "'high'")
    return census, per_kernel, timing


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
        from gemnet_pytorch_tpu_torch.scripts import gather_probe
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    power = card_line()
    # the plain versions' products in the port's precision (bf16 summed in fp32)
    _cuda.set_matmul_precision()

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

    log("== 3. kernels vs plain versions (bench-small shapes: fp32, bf16 and split3 streams; "
        "the gather probe's shape)")
    errors = compare_kernels(cases)

    log(f"== 4. kernel timing [{power}]")
    timings = time_kernels(cases, power)

    log("== 5. serving GemNet-Q (config.yaml widths, random weights, seed 0)")
    serve_census, per_kernel, timing, exact_E = serve(cfg, mols, device)
    check(per_kernel == SERVE_LAUNCHES["default"],
          f"one predict launched {per_kernel}, expected {SERVE_LAUNCHES['default']}")
    serve_high_census = serve_high(cfg, mols, device, exact_E)

    log("== 6. calculator (benzonitrile, 5 perturbed geometries)")
    calculator(cfg, device)

    log(f"== 7. training GemNet-Q (config.yaml widths, random weights, seed 0) [{power}]")
    train_census, train_per_kernel, train_timing = train(cfg, mols, device)
    for dt in ("float32", "bfloat16"):
        check(train_per_kernel[dt] == TRAIN_LAUNCHES[dt],
              f"{dt} train step launched {train_per_kernel[dt]}, expected {TRAIN_LAUNCHES[dt]}")

    log(f"== 8. the training entry point in matmul_precision='high' (GemNet-Q, config.yaml "
        f"widths, random weights, seed 0) [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_train_") as workdir:
        high_census, _, train_timing["high"] = train_high(cfg, mols, device, workdir)

    log(f"== 9. the row-gather probe [{power}]")
    _cuda.reset_launches()
    gather_probe.main(device)
    torch.cuda.synchronize()
    probe_census = dict(_cuda.LAUNCHES)

    paths = {"serve": serve_census, "train_fp32": train_census["float32"],
             "train_bf16": train_census["bfloat16"], "serve_high": serve_high_census,
             "train_high": high_census, "probe": probe_census}
    # each row's own paths, where it must have launched
    own = {"f32": ("serve", "train_fp32"), "bf16": ("train_bf16",),
           "split3": ("serve_high", "train_high")}
    kernels = []
    for case in cases:
        key = (case["kernel"], case["tag"], case["dtype"])
        info = kernel_info(case)
        by_path = {p: c.get((kernel_fn(case), case["shape"]), 0) for p, c in paths.items()}
        kernels.append(dict(
            name=f"{info['name']}[{case['tag']},{case['dtype']}]", route="cuda",
            source=info["source"], replaces=info["replaces"], dtype=case["dtype"],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=errors[key], **timings[key]))
    log(f"== kernels on the serving, training and probe paths [{power}]")
    log(f"  {'kernel':50s} " + " ".join(f"{p:>10s}" for p in paths)
        + f" {'ms':>8s} {'call ms':>8s} {'bound ms':>9s} {'plain ms':>9s} {'library ms':>10s}"
        + f" {'lib call':>9s}")
    for case, row in zip(cases, kernels):
        by_path = row["launches_by_path"]
        for p in ("probe",) if case["kernel"] in ("P1", "P2") else own[row["dtype"]]:
            check(by_path[p] > 0, f"{row['name']} was not launched by the {p} path")
        lib = [f"{row[k]:.4f}" if row[k] is not None else "null"
               for k in ("library_ms", "library_call_ms")]
        log(f"  {row['name']:50s} " + " ".join(f"{by_path[p]:10d}" for p in paths)
            + f" {row['ms']:8.4f} {row['call_ms']:8.4f} {row['bound_ms']:9.4f}"
            + f" {row['plain_ms']:9.4f} {lib[0]:>10s} {lib[1]:>9s}")
    for dt, t in train_timing.items():
        p = t["profile"]
        if p:
            log(f"  profiled {dt} step: device {p['device_ms']:.3f} ms, of which K1 "
                f"{p['K1']:.3f}, K2 {p['K2']:.3f}, K3 {p['K3']:.3f}, K4 {p['K4']:.3f} ms "
                f"(forward {p['K4_forward']:.3f}, backward {p['K4_backward']:.3f})")
    log(f"== done in {time.perf_counter() - t_start:.1f} s; serving "
        f"{timing['ms_per_request']:.3f} ms/request, {timing['molecules_per_s']:.1f} molecules/s; "
        + "; ".join(f"train {dt} {t['ms_per_step']:.3f} ms/step, {t['agg_per_s']:.4e} "
                    f"triplets+quads/s" for dt, t in train_timing.items()))
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
