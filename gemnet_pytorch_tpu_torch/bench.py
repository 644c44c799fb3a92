"""Benchmark of the port: triplets + quadruplets aggregated per second by
the GemNet-Q train step on one card, with a roofline against the H100's
published peaks (the counterpart of the repository's `bench.py`).

    python -m gemnet_pytorch_tpu_torch.bench [--profile DIR] [--compute-dtype float32|bfloat16]
        [--skip-large] [--skip-f32] [--skip-roofline] [--steps-per-call K]
        [--large-scan K] [--device cuda|cpu]

GemNet-Q at the config.yaml widths (`ModelConfig()` and `TrainConfig()`
defaults, which equal config.yaml), -dE/dR forces, random weights from seed
0, the full train step (force loss, grad-of-grad, flat AdamW/Adam, EMA), on
two workloads made from `default_rng(0)`:
- small: 32 molecules of 8-12 atoms (~2.9k edges, ~183k quadruplets), the
  headline;
- large: 4 systems of 32 atoms (~3.3k edges, ~2.3M quadruplets).

Timing (perf/timing.py): chained steps (the step threads its state; the
forward threads a zero scalar) in windows that end in a value fetch of the
last output; the median, best and spread (max - min) of the windows. The
forward timed (`fwd_ms_median`) is the trainer's captured predict
(`predict_fn()`) on the packed batch, on the card. The
step timed is the Trainer's `train_step_fn()`, the counterpart of the jitted
step `bench.py` times: on the card a CUDA graph replay, its packed batch
resident on the device as the JAX bench's batch is. The headline dtype is
bf16 streams; `--compute-dtype float32` makes fp32 the headline, and the
fp32 A/B runs in its own block on both workloads. Peak memory is
`torch.cuda.max_memory_allocated` over the timed windows plus the step
graph's private pool (`graphs.pool_mib`), which a replay uses and the
allocator no longer counts as allocated. `--steps-per-call K` (> 1) adds a window of K steps per call
(`Trainer.multi_step_fn`) on each workload, and `--large-scan K` (default
4, 0 or 1 off) one on the large workload (bench.py:321-366): their ms per
step, agg/s, and the large workload's single-step ms less its scan ms per
step (`large_dispatch_overhead_ms`).

Roofline (perf/roofline.py): the headline eager step's kernel census and
aten counts (the same kernels the graph holds) priced against the published
peaks; the card's peaks are calibrated
and checked first, and a failed calibration fails the run. `--profile DIR`
traces 10 steps of each workload after its timed windows, each inside
record_function("step") (graph replays, as timed), into
DIR/<workload>/trace.json, and reads the trace back (perf/trace.py): the
device ms of a step and by kernel group, and its share of the median step
(`*_device_busy`); a failed readback fails the run.

The last line of stdout is one JSON object. It runs on the card unless
`--device cpu` is given, and fails at once without one. A CPU run prints
"device": "cpu" and null for every share of a device peak. There is no
`vs_baseline`: the repository's anchors are TPU numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from . import graphs
from .config import ModelConfig, TrainConfig
from .data import PadDims, build_graph, pad_batch, scale_graph_dims, to_torch
from .data.synthetic import random_molecule, toy_energy_forces
from .models import GemNet, energy_and_forces
from .ops import _cuda
from .perf import roofline, trace
from .perf.timing import fetch_scalar, measure_rtt, timed_windows
from .training import Trainer

METRIC = "triplets+quads aggregated/sec/chip (GemNet-Q train step)"
KINDS = ("small", "large")
# train steps traced by --profile, per workload
PROFILE_STEPS = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ----------------------------------------------------------------- batches


def molecules(kind: str, seed: int = 0):
    """The workload's molecules: "small" is 32 of 8-12 atoms, "large" 4 of
    32 atoms, from default_rng(seed) (bench.py:81-86)."""
    rng = np.random.default_rng(seed)
    if kind == "small":
        return [random_molecule(rng, int(rng.integers(8, 13))) for _ in range(32)]
    if kind == "large":
        return [random_molecule(rng, 32) for _ in range(4)]
    raise ValueError(f"workload {kind!r}: one of {KINDS}")


def padded_batch(cfg, mols):
    """(padded numpy batch, graph, PadDims) of `mols` with 5% headroom over
    the graph's sizes and the toy energy/force targets (bench.py:87-111)."""
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
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=cfg.triplets_only), g, dims


def make_batch(cfg, kind: str):
    """(numpy batch, real triplets + quadruplets, graph, dims, description)
    of a workload."""
    batch_np, g, dims = padded_batch(cfg, molecules(kind))
    desc = (f"{g.n_edges} edges, {g.n_triplets} triplets, {g.n_quads} quads (padded "
            f"{dims.n_edges}/{dims.n_triplets}/{dims.n_quads}, {dims.n_intm} intermediate "
            f"rows, kmax4={dims.kmax4})")
    return batch_np, g.n_triplets + g.n_quads, g, dims, desc


# ---------------------------------------------------------------- measures


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, power = out.stdout.strip().splitlines()[0].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": power.strip()}


def make_trainer(cfg, tcfg, device):
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
    trainer = Trainer(model, tcfg)
    return trainer, trainer.init_state()


def measure_train_step(trainer, state, words, rtt, tag, device, **windows):
    """Seconds per train step (`train_step_fn()` on the packed batch `words`)
    from chained value-fetch windows (the step threads its state), and the
    peak device memory over them. Returns (timing dict of timed_windows +
    "peak_mib")."""
    on_card = device.type == "cuda"
    step = trainer.train_step_fn()
    t0 = time.perf_counter()
    fetch_scalar(step(state, words, 1.0)[1]["loss"])
    log(f"[{tag}] first step{' (its capture)' if on_card else ''}: "
        f"{time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    def train_once():
        return step(state, words, 1.0)[1]["loss"]

    res = timed_windows(train_once, rtt_s=rtt, **windows)
    res["peak_mib"] = None
    if on_card:
        pool = graphs.pool_mib(trainer._captured[1].graph)
        res["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20 + pool
        log(f"[{tag}] the step's graph pool: {pool:.1f} MiB")
    log(f"[{tag}] train steady: median {res['median_s'] * 1e3:.3f} ms, best "
        f"{res['best_s'] * 1e3:.3f} ms, spread {res['spread_s'] * 1e3:.3f} ms ({res['iters']} "
        f"chained steps/window, rtt {res['rtt_s'] * 1e3:.3f} ms), peak {res['peak_mib']} MiB")
    return res


def measure_forward(trainer, state, batch, words, rtt, tag, **windows):
    """Seconds per forward (E and -dE/dR), each chained onto the last through
    a zero scalar added to R (bench.py:226-260). On the card it is the
    trainer's captured predict (`predict_fn()`) replayed on the packed words
    `words`, as JAX jits its forward on the train step's packed signature; the
    zero is added to R inside `words`. On the CPU it runs eagerly on the
    batch of tensors `batch`."""
    box = {"eps": torch.zeros((), device=trainer.device)}
    if trainer.device.type == "cuda":
        predict = trainer.predict_fn()
        R = trainer.packer.unpack(words)["R"]  # a view of the words

        def fwd_once():
            R.add_(box["eps"])
            box["eps"] = predict(state, words)[0].sum() * 0.0
            return box["eps"]
    else:
        def fwd_once():
            E, _ = energy_and_forces(trainer.model, dict(batch, R=batch["R"] + box["eps"]))
            box["eps"] = E.sum() * 0.0
            return box["eps"]

    t0 = time.perf_counter()
    fetch_scalar(fwd_once())
    log(f"[{tag}] fwd first call{' (its capture)' if trainer.device.type == 'cuda' else ''}: "
        f"{time.perf_counter() - t0:.1f} s")
    res = timed_windows(fwd_once, rtt_s=rtt, **windows)
    log(f"[{tag}] fwd steady: median {res['median_s'] * 1e3:.3f} ms, best "
        f"{res['best_s'] * 1e3:.3f} ms ({res['iters']} chained/window)")
    # the predict's graph and pool go before the train step's peak is read
    trainer.drop_forward_graphs("predict")
    return res


def measure_scan(trainer, state, words, k, n_real, rtt, tag, windows):
    """ms per step of K steps per call (`multi_step_fn` over K copies of the
    packed batch, resident on the device) and the agg/s they give."""
    stack = words.reshape(1, -1).expand(k, -1).contiguous()
    multi = trainer.multi_step_fn()
    t0 = time.perf_counter()
    fetch_scalar(multi(state, stack, 1.0)[1]["loss"])
    log(f"[{tag}] scan{k} first call: {time.perf_counter() - t0:.1f} s")
    res = timed_windows(lambda: multi(state, stack, 1.0)[1]["loss"], rtt_s=rtt,
                        **dict(windows, windows=min(3, windows["windows"])))
    ms = res["median_s"] / k * 1e3
    log(f"[{tag}] train scan{k} steady: {ms:.3f} ms/step -> {n_real / (ms / 1e3):.4e} "
        "trip+quad/s")
    return ms, n_real / (ms / 1e3)


def step_roofline(trainer, state, batch, g, dims, peaks, median_s, on_card):
    """The roofline report of one train step: its kernel census and aten
    counts (one step each) priced against `peaks`."""
    census = roofline.kernel_census(trainer.train_step, state, batch, 1.0)
    aten = roofline.aten_costs(trainer.train_step, state, batch, 1.0)
    real_rows = {dims.n_triplets: g.n_triplets, dims.n_quads: g.n_quads, dims.n_intm: g.n_intm}
    used_segments = {dims.n_edges: g.n_edges, dims.n_int_edges: g.n_int_edges}
    rl = roofline.speed_of_light(
        aten, roofline.kernel_costs(census, real_rows, used_segments), peaks,
        min_bytes=roofline.train_step_min_bytes(state, batch),
        aten_class="bf16" if trainer.model_cfg.compute_dtype == "bfloat16" else "f32")
    return rl.report(median_s, on_device=on_card), census


# --------------------------------------------------------------------- run


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.bench")
    ap.add_argument("--profile", default=None,
                    help="trace 10 train steps of each workload after its timed windows into "
                    "this directory and read back their device time")
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="headline compute dtype (default bfloat16)")
    ap.add_argument("--skip-large", action="store_true", help="the small workload only")
    ap.add_argument("--skip-f32", action="store_true", help="skip the fp32 A/B block")
    ap.add_argument("--skip-roofline", action="store_true",
                    help="skip the peak calibration and the cost model")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="K > 1 adds a window of K train steps per call (multi_step_fn) on "
                    "each workload")
    ap.add_argument("--large-scan", type=int, default=4,
                    help="K for the large workload's window of K steps per call (0 or 1: "
                    "none); its ms per step against the single step's")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, model_overrides: dict | None = None, windows: int = 5,
        min_window_s: float = 0.5, max_iters: int = 2000) -> dict:
    """Run the bench as `args` say, GemNet-Q at ModelConfig() widths with
    `model_overrides` applied; print the JSON line last on stdout and
    return it. `windows`, `min_window_s` and `max_iters` go to every
    timed_windows."""
    if args.steps_per_call < 1 or args.large_scan < 0:
        raise ValueError("--steps-per-call takes K >= 1, --large-scan K >= 0")
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA device and none is available; "
                           "pass --device cpu to run it on the CPU")
    if on_card:
        _cuda.set_matmul_precision()
        _cuda.build()
    dtype = args.compute_dtype or "bfloat16"
    base = dict(model_overrides or {})
    cfg = ModelConfig(**dict(base, compute_dtype=dtype))
    tcfg = TrainConfig()
    where = card() if on_card else "cpu"
    log(f"device {where}, compute_dtype {dtype}")
    win = dict(windows=windows, min_window_s=min_window_s, max_iters=max_iters)
    rtt = measure_rtt(device)
    log(f"host<->device scalar-fetch RTT: {rtt * 1e3:.3f} ms")

    peaks, peaks_source, calibrated = roofline.H100_DATASHEET, "skipped", None
    if not args.skip_roofline:
        if on_card:
            t0 = time.perf_counter()
            calibrated = roofline.calibrate_peaks(strict=True, device=device)
            peaks_source = "datasheet (calibration checked)"
            log(f"calibrated peaks in {time.perf_counter() - t0:.1f} s: bf16 "
                f"{calibrated['bf16'] / 1e12:.1f} TFLOP/s, f32 {calibrated['f32'] / 1e12:.1f} "
                f"TFLOP/s, HBM {calibrated['hbm'] / 1e9:.0f} GB/s; shares use the data sheet's "
                f"{peaks['bf16'] / 1e12:.0f} / {peaks['f32'] / 1e12:.0f} TFLOP/s, "
                f"{peaks['hbm'] / 1e9:.0f} GB/s")
        else:
            peaks_source = "datasheet (not calibrated: cpu)"

    kinds = ("small",) if args.skip_large else KINDS
    res, roof = {}, {}
    for kind in kinds:
        batch_np, n_real, g, dims, desc = make_batch(cfg, kind)
        log(f"[{kind}] batch: {desc}")
        batch = to_torch(batch_np, device)
        trainer, state = make_trainer(cfg, tcfg, device)
        words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
        res[f"{kind}_n_real"] = n_real
        if kind == "small":
            res["fwd"] = measure_forward(trainer, state, batch, words, rtt, kind, **win)
            if on_card:
                torch.cuda.empty_cache()
        t = measure_train_step(trainer, state, words, rtt, kind, device, **win)
        res[kind] = t
        log(f"[{kind}] -> {n_real / t['median_s']:.4e} trip+quad/s (median)")
        k = max(args.steps_per_call, args.large_scan if kind == "large" else 1)
        if k > 1:
            res[f"{kind}_scan"] = (k, *measure_scan(trainer, state, words, k, n_real, rtt, kind,
                                                   win))
        if not args.skip_roofline:
            rep, census = step_roofline(trainer, state, batch, g, dims, peaks, t["median_s"],
                                        on_card)
            roof[kind] = rep
            log(f"[{kind}] kernel census: {len(census)} calls; roofline: SOL "
                f"{rep['sol_ms_lo']:.3f}-{rep['sol_ms_hi']:.3f} ms vs measured "
                f"{rep['measured_ms']:.3f} ms, SOL fraction {rep['sol_fraction']}, "
                f"MFU (bf16 peak) {rep['mfu_bf16peak']}, HBM util lo {rep['hbm_util_lo']} "
                f"(accounting hi {rep['hbm_util']})")
            if rep["below_floor"]:
                log(f"[{kind}] ERROR: the measured step is below the floor "
                    f"{rep['sol_ms_lo']:.3f} ms: a measurement artifact")
        if args.profile:
            step = trainer.train_step_fn()
            path = trace.record_trace(lambda: step(state, words, 1.0)[1]["loss"],
                                      PROFILE_STEPS, os.path.join(args.profile, kind), "step",
                                      device)
            log(f"[{kind}] profiler trace written to {path}\n"
                + trace.summarize(path, n_execs=PROFILE_STEPS))
            mt = trace.step_device_ms(path, match="step")
            if on_card and mt is None:
                raise RuntimeError(f"trace readback: no device time inside the 'step' ranges "
                                   f"of {path}")
            res[f"{kind}_profile"] = (mt.mean_ms if mt else None,
                                      trace.op_category_summary(path, n_execs=PROFILE_STEPS))
        del trainer, state, batch, words
        if on_card:
            torch.cuda.empty_cache()

    f32 = {}
    if not args.skip_f32 and dtype == "bfloat16":
        f32_cfg = ModelConfig(**dict(base, compute_dtype="float32"))
        for kind in kinds:
            batch_np, n_real, _, _, _ = make_batch(f32_cfg, kind)
            trainer, state = make_trainer(f32_cfg, tcfg, device)
            words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
            f32[kind] = measure_train_step(trainer, state, words, rtt, f"{kind}/f32", device,
                                           **win)
            log(f"[{kind}/f32] -> {n_real / f32[kind]['median_s']:.4e} trip+quad/s")
            del trainer, state, words
            if on_card:
                torch.cuda.empty_cache()

    out = report(res, roof, f32, dtype, rtt, peaks_source, peaks, calibrated, where, on_card,
                 args.steps_per_call)
    print(json.dumps(out), flush=True)
    return out


def report(res, roof, f32, dtype, rtt, peaks_source, peaks, calibrated, where, on_card,
           steps_per_call=1) -> dict:
    """The JSON object: bench.py's keys where they mean the same thing, and
    the spreads, peak memory per dtype, the device busy share and the card."""
    small = res["small"]
    out = {
        "metric": METRIC,
        "compute_dtype": dtype,
        "small_n_real": res["small_n_real"],
        "large_n_real": res.get("large_n_real"),
        "value": res["small_n_real"] / small["median_s"],
        "unit": "agg/s/chip",
        "best_agg_per_s": res["small_n_real"] / small["best_s"],
        "small_ms_median": small["median_s"] * 1e3,
        "small_ms_spread": small["spread_s"] * 1e3,
        "fwd_ms_median": res["fwd"]["median_s"] * 1e3,
        "rtt_ms": rtt * 1e3,
        "windows": len(small["windows_s"]),
        "steps_per_call": steps_per_call,
        "large_scan": res["large_scan"][0] if "large_scan" in res else None,
        "peaks_source": peaks_source,
        "device": where,
    }
    if "small_scan" in res:
        out["scan_agg_per_s"] = res["small_scan"][2]
        out["scan_ms"] = res["small_scan"][1]
    if "small" in roof:
        r = roof["small"]
        out.update({k: r[k] for k in ("sol_ms_lo", "sol_ms_hi", "sol_band", "sol_fraction",
                                      "mfu_bf16peak", "hbm_util", "hbm_util_lo", "below_floor",
                                      "kernel_calls")})
        out["peaks"] = dict(peaks)
        out["calibrated_peaks"] = calibrated
    for kind in KINDS:
        if f"{kind}_profile" in res:
            step_ms, groups = res[f"{kind}_profile"]
            prefix = "" if kind == "small" else "large_"
            out[f"{prefix}profile_step_ms"] = step_ms
            out[f"{prefix}profile_groups_ms"] = groups
            out[f"{kind}_device_busy"] = (step_ms / (res[kind]["median_s"] * 1e3)
                                          if on_card and step_ms else None)
    peak = {kind: {dtype: res[kind]["peak_mib"]} for kind in KINDS if kind in res}
    for kind, t in f32.items():
        out[f"f32_{kind}_agg"] = res[f"{kind}_n_real"] / t["median_s"]
        out[f"f32_{kind}_ms"] = t["median_s"] * 1e3
        out[f"f32_{kind}_ms_spread"] = t["spread_s"] * 1e3
        peak[kind]["float32"] = t["peak_mib"]
    if "large" in res:
        large = res["large"]
        out["large_agg_per_s"] = res["large_n_real"] / large["median_s"]
        out["large_ms_median"] = large["median_s"] * 1e3
        out["large_ms_spread"] = large["spread_s"] * 1e3
        if "large_scan" in res:
            _, scan_ms, scan_agg = res["large_scan"]
            out["large_scan_ms"] = scan_ms
            out["large_dispatch_overhead_ms"] = out["large_ms_median"] - scan_ms
            out["large_scan_agg_per_s"] = scan_agg
        if "large" in roof:
            r = roof["large"]
            out.update(large_sol_fraction=r["sol_fraction"], large_below_floor=r["below_floor"],
                       large_sol_band=r["sol_band"], large_sol_ms_lo=r["sol_ms_lo"],
                       large_sol_ms_hi=r["sol_ms_hi"], large_kernel_calls=r["kernel_calls"])
    for kind, by_dtype in peak.items():
        out[f"{kind}_peak_mib"] = by_dtype
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
