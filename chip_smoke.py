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
     Then the same at the bench-large batch's shapes, one case at a time:
     K1, K2 and K4 at the quadruplet shape (2454528 rows x 49 (x) 32 into
     3456 segments; fp32, bf16, split3) and K3 on the quad_abd row space
     (2454528 x 32 into 106496; fp32, bf16);
  4. time each kernel and, where one PyTorch call computes the same
     function, that call, both ways: device time per launch (`ms`,
     `library_ms`: 20 calls captured in a CUDA graph, replayed under CUDA
     events) and the wrapper-inclusive call time (`call_ms`,
     `library_call_ms`: CUDA events around a host loop of 20 calls); and the
     plain version's call time; beside the bound (perf/roofline.kernel_cost
     over the published peaks); at both batches' shapes;
  5. serve GemNet-Q at the config.yaml widths (random weights from a seed):
     one predict of the 32-molecule bench-small batch with the launch
     counters read around it (8 / 8 / 14 launches of K1 / K2 / K3), E and F
     against the same model on the CPU (first 8 molecules), then 10 timed
     requests; then one predict in matmul_precision="high" (8 / 8 split3
     K1 / K2, 14 fp32 K3, no exact K1/K2), against the CPU, and profiled;
     then the bench-large batch's first 32-atom system (~580k quadruplets)
     served on the card against the CPU;
  6. the serving calculator on a benzonitrile molecule, 5 perturbed
     geometries (its predict captured once into a CUDA graph and replayed),
     against the eager predict on the card and the calculator on the CPU;
  7. train GemNet-Q at the config.yaml widths (random weights from seed 0) on
     the bench-small batch with toy targets: one fp32 step on the card (the
     captured step of `train_on_batch`) against the same step on the CPU
     (first 8 molecules); bf16 E/F against
     fp32 on the card (tests/test_bf16.py's contract at its widths; at the
     config.yaml widths, for 5 weight seeds, beside the error of bf16-rounded
     weights alone, and bf16 on the card against bf16 on the CPU);
     one eager train step per dtype with the launch counters read
     around it (pinned counts, every bf16 kernel launched; the roofline's
     kernel census of the step equal to its launches); 5 eager steps with
     falling losses and fp32 master state; a captured eval on the EMA
     weights; then
     3 warm-up and 10 timed eager steps and one profiled step per dtype (its
     device time, and that of K1-K4 summed by kernel name, K4 also split
     into its forward and backward);
  8. the training entry point in matmul_precision="high": one step on the
     card (captured) against the CPU, the eager step's launch census (24 / 24
     split3 K1 / K2, 26 fp32 K3, no exact K1/K2), `gemnet_pytorch_tpu_torch.
     train.run` with 4 steps per call on a synthetic dataset (20 steps, eval
     and checkpoint every 10), resumed from its checkpoint with the state
     equal bit for bit, its reference export loaded back, and 10 timed eager
     "high" steps;
  9. the row-gather probe (`gemnet_pytorch_tpu_torch.scripts.gather_probe`);
 10. the bench, `gemnet_pytorch_tpu_torch.bench` in-process with --profile,
     --steps-per-call 2, --large-scan 4 and 3 windows (bf16 headline and fp32
     A/B on bench-small and bench-large, the captured step): it prints its
     JSON line, which must hold every key (the K-step windows' among them),
     no step below its floor, a kernel census of one step equal to the
     pinned launches and K1-K3 in both workloads' read-back traces;
 11. CUDA graphs: K1-K4 and K3 on capacity plans bit-equal to the exact
     plans at both batches' shapes; per mode (fp32, bf16, "high") 5 eager
     steps twice and 5 captured steps from one state (losses, update and
     accumulators within their gates; bit-equality printed, and where two
     eager runs differ, the ops whose float atomics differ named), the
     capture's launches equal to the eager step's and the graph's
     hand-written kernel nodes (debug dump) equal to the census, 4 steps in
     one call against 4 single replays, the accumulators drained; eager
     against captured ms per step (fp32, bf16) and peak MiB with the graph
     pools; the captured predict against the eager one and the CPU, and ms
     per request both ways; 100 captured Verlet MD steps on a bench
     molecule with the energy drift held to tests/test_md.py's bound;
 12. the rest of training, at the config.yaml widths: MVE (num_targets=2)
     in fp32 and bf16, one captured step on the card against the CPU
     (first 8 molecules); per mode (fp32, bf16, "high") with deterministic
     algorithms 5 captured steps against 5 eager ones (phase 11's gates) and
     the launches of one MVE step (pinned in MVE_LAUNCHES); ms per captured
     MVE step, its device ms and peak MiB with the graph pool, at both
     batches in both dtypes; the per-tensor optimizer and AGC (both
     selections): one captured fp32 step against the CPU and ms per step
     beside the flat optimizer's; the captured eval of the EMA and the
     current weights against the eager eval, and ms per eval batch both
     ways; `fit_scaling.run` (34 factors, 2 batches each) timed on the card,
     and at batches of 8 on the card against the CPU;
 13. the rest of the single-device stack: the native graph builder (built
     on the card's host in phase 2) against the numpy builder at both bench
     batches, array for array, and each one's host ms; a DataProvider's
     batches per second (2 prefetch workers, batches of 32 packed) with each
     builder, beside the captured fp32 step's ms; phase 11's MD run with each
     builder, ms per step split into graph build, pad_batch, plans and pack,
     and the rest; `load_pretrained` of a written directory (GemNet-Q, in
     fp32 and "high") predicting the example molecule on the card against
     the CPU, its launches pinned, and the predict and MD examples; with
     deterministic algorithms 5 captured fp32 remat steps against 5 without
     (the remat step's launches pinned in REMAT_LAUNCHES), and ms, device
     ms and peak MiB of the captured bf16 step with and without remat at
     both batches; bilinear_implementation="xla" (the plain versions)
     refused on the card, with no launch. Phase 10's fwd_ms_median is the
     trainer's captured predict;
 14. data parallelism and the halo edge partition (`parallel/`), with
     deterministic algorithms for the gates: (a) on an NCCL group of one
     (`parallel.initialize_distributed`), the captured dp step against the
     captured single-device step (fp32 and bf16, 5 steps from one state,
     bit-equality printed, phase 11's gates), its all-reduces issued at the
     capture and none at a replay, the captured dp eval of the EMA weights
     (EVAL_RTOL), ms per step both ways; (e) the halo step at one shard,
     captured against eager (bit-equal where two eager runs are) and
     against the single-device step (tests/test_halo.py's gates); then 2
     spawned gloo ranks sharing cuda:0 (collectives through the host): (b)
     dp with bench-small's 32 molecules in two padded halves, one fp32 step
     against the single-device step on all 32 (loss 1e-5, update rel L2
     TRAIN_UPDATE_REL_L2) and each half's predict (SERVE_RTOL); (c) halo on
     bench-small: E/F and one fp32 step at tests/test_halo.py's gates, each
     rank's launches pinned (HALO_LAUNCHES: K1/K2 on its local rows and
     plans, no K3); (d) halo on bench-large: E/F (SERVE_RTOL), each rank's
     peak MiB and ms of an eager fp32 and bf16 step beside the
     single-device step's (one card: not a scaling number); (f) the
     training entry point, `train.run` with dp=1 on the NCCL group and with
     halo=2 on the gloo ranks (4 steps, eval and checkpoint every 2, rank
     0's checkpoint at step 4). Phase 3 also holds K1/K2 at the halo shard's
     shapes against their plain versions;
 15. the rest of the edge partition (`parallel/ep.py`, rung 2a, and
     `parallel/hybrid.py`'s 2-D meshes), with deterministic algorithms for
     the gates: (b) K1, K2 and K4 (fp32, bf16, split3) at the ep shard's
     shapes (rank 0's chunk of bench-small over 2 ranks, global edge ids,
     full-width outputs) against their plain versions with phase 3's
     checks, each K1 output zero outside the chunk's band, timed as phase
     4 times the others; then, the counters at 0, (a) on an NCCL group of
     one, the captured ep step and the captured 1x1 dp x halo step
     (`make_hybrid_mesh(1, 1)`), each against its eager run (bit-equal
     where two eager runs are) and the captured single-device step (phase
     14's 1-shard gates), and their collectives and bytes a step; (c) 2
     gloo ranks on cuda:0: ep E/F in fp32 (tests/test_halo.py's gates),
     bf16 and "high" against the single-device predict, the gradient of
     tests/test_edge_partition.py's loss (1e-4 + 1e-3 max|g|), one step
     (phase 14's halo gates) with its launches pinned (EP_LAUNCHES) and its
     35 all-reduces counted, and one bench-large eager fp32 step's peak MiB
     and ms a rank beside the single device's; (d) 4 gloo ranks as a 2x2
     mesh: each rank's place, the dp x ep loss and gradient over
     bench-small's two halves, 2 dp x halo train steps and the eval of the
     EMA weights against the single device on all of bench-small; (e)
     `train.run(ep=2)` on (c)'s ranks and `train.run(dp_halo=(2, 2))` on
     (d)'s;
 16. pipeline parallelism (`parallel/pp.py`), with deterministic algorithms
     for the gates: (b) K1, K2, K3 and K4 (fp32, bf16, split3) at the
     shapes of a pp microbatch (an eighth of bench-small) against their
     plain versions with phase 3's checks, timed as phase 4 times the
     others; then, the counters at 0, (a) one stage on an NCCL group of
     one, bench-small in 4 microbatches: the captured PPTrainer step against
     its eager run (bit-equal where two eager runs are), its launches
     pinned (pp_launches) and one step against the captured single-device
     step (phase 14's 1-shard gates); (c) 2 gloo ranks on cuda:0, 2 stages,
     bench-small in 8 microbatches: E/F in fp32 (tests/test_halo.py's
     gates), bf16 and "high" against the single-device predicts, the
     gradient of tests/test_pp.py's loss (1e-4 + 1e-3 max|g|), one step
     (phase 14's halo gates) with its launches pinned, every rank's
     collectives in one order, and one bench-large eager fp32 step (one
     system a microbatch): parameters, peak MiB and ms a rank; (d) 4 gloo
     ranks: E/F at 4 stages, and the 2x2 dp x pp loss and gradient against
     the single device; (e) `train.run(pp=2, pp_micro=4)` on (c)'s ranks:
     4 steps, a resume to 6 with the export, rank 0's checkpoint holding
     both stages.

The last lines are the `{"kernels": [...]}` record (every kernel at both
batches' shapes, its launches on each path: serving, training, probe,
bench and graph, the launches the captured graphs of phase 11 hold,
rest, phase 12's, stack, phase 13's, parallel, phase 14's, ep, phase
15's, and pp, phase 16's, their gloo ranks' included), the
card's name and power limit, and `{"ok": true, "device": {...}}`.
Any failed check exits non-zero before those lines. Without a CUDA device
it fails at once.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from gemnet_pytorch_tpu_torch import bench
from gemnet_pytorch_tpu_torch.data.graph import build_graph, build_graph_numpy
from gemnet_pytorch_tpu_torch.perf import roofline, trace

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
# phases 3 and 4 at the bench-large batch: the shapes it gives the
# quadruplet K1/K2/K4 (2454528 rows, 3456 segments) and K3's quad_abd row
# space (2454528 rows into 106496), which no other path reaches
LARGE_TAGS = ("quadruplet", "quad_abd")
# phase 10: the bench's JSON keys that must hold a value (the ports of
# bench.py's keys, and the port's own)
BENCH_KEYS = (
    "metric", "compute_dtype", "small_n_real", "large_n_real", "value", "unit", "best_agg_per_s",
    "small_ms_median", "small_ms_spread", "fwd_ms_median", "rtt_ms", "peaks_source",
    "sol_ms_lo", "sol_ms_hi", "sol_band", "sol_fraction", "mfu_bf16peak", "hbm_util",
    "hbm_util_lo", "below_floor", "kernel_calls", "f32_small_agg", "f32_small_ms",
    "f32_large_agg", "f32_large_ms", "large_agg_per_s", "large_ms_median", "large_ms_spread",
    "large_sol_fraction", "large_below_floor", "profile_step_ms", "large_profile_step_ms",
    "small_peak_mib", "large_peak_mib", "small_device_busy", "large_device_busy", "device",
    # K steps per call (--steps-per-call 2, --large-scan 4)
    "scan_agg_per_s", "scan_ms", "large_scan_ms", "large_dispatch_overhead_ms",
    "large_scan_agg_per_s")
# phase 10's K steps per call
BENCH_ARGS = ("--steps-per-call", "2", "--large-scan", "4")
# phase 8's run of the training entry point: a synthetic dataset of 64
# molecules of 4-12 atoms (seed 0), batches of 32, eval and checkpoint every
# 10 steps; the lr at its full 1e-3 from step 0
TRAIN_RUN = dict(batch_size=32, num_steps=20, evaluation_interval=10, save_interval=10,
                 data_seed=0, warmup_steps=1, matmul_precision="high")
TRAIN_RUN_MOLECULES = 64
# phase 8's runs and phase 11's K-step call: train.py --steps-per-call 4
STEPS_PER_CALL = 4
# phase 11: the captured step against the eager one, from one state, per
# mode: (compute_dtype, matmul_precision)
GRAPH_MODES = {"float32": ("float32", "default"), "bfloat16": ("bfloat16", "default"),
               "high": ("float32", "high")}
CAPTURED_STEPS = 5
# captured vs eager, fp32 and "high": the same kernels in the same order;
# what differs is the order of the float atomics of index_add (and of any
# other op that sums with atomics), run to run
CAPTURED_LOSS_RTOL = 1e-5
CAPTURED_UPDATE_REL_L2 = 1e-4
# phase 12: MVE (num_targets=2). Launches of one MVE step, from the autograd
# graph: forward 8 K1; each of the two -dE/dR backwards 8 K2 and 14 K3; the
# loss backward through both force graphs: 8 K2 (the forward K1s, whose
# cotangents from both graphs sum first), 2 K1 + 1 K2 for each of the 16
# first-backward K2s, and 12 K3 (the forward's network gathers). In bf16 the
# geometry K3s (2 per backward) stay fp32
MVE_TRAIN = dict(mve=True)
MVE_LAUNCHES = {
    "float32": {"gemnet_segment_outer_sum_f32": 40, "gemnet_segment_gather_contract_f32": 40,
                "gemnet_sorted_segsum_f32": 40},
    "bfloat16": {"gemnet_segment_outer_sum_bf16": 40, "gemnet_segment_gather_contract_bf16": 40,
                 "gemnet_sorted_segsum_bf16": 36, "gemnet_sorted_segsum_f32": 4},
    "high": {"gemnet_segment_outer_sum_split3": 40,
             "gemnet_segment_gather_contract_split3": 40, "gemnet_sorted_segsum_f32": 40},
}
# phase 12: the per-tensor optimizer and AGC (config.yaml's clip factor 10)
TREE_MODES = {"tree": dict(flat_optimizer=False), "agc": dict(agc=True),
              "agc_compat": dict(agc=True, agc_compat_reference=True)}
# phase 12: the captured eval against the eager one (deterministic algorithms)
EVAL_RTOL = 1e-5
# phase 12's fitting: batches per factor; the batch size of the card-vs-CPU
# comparison (a CPU forward at the config.yaml widths on 32 molecules takes
# seconds); the factors' tolerance there
FIT_BATCHES = 2
FIT_COMPARE_BATCH = 8
FIT_RTOL = 1e-4
# phase 11's MD run: tests/test_md.py's Verlet settings on a bench molecule
MD_STEPS = 100
MD_SETTINGS = dict(dynamics="verlet", time=0.2, temperature=50, interval=1, traj_path=None,
                   seed=1, logfile=None)

# phase 13: host ms of each graph builder, median of this many builds; the
# provider's batches (train.py's synthetic dataset, 4-12 atoms a molecule)
BUILDER_REPEATS = 5
PROVIDER_MOLECULES = 512
PROVIDER_WARMUP = 4
PROVIDER_BATCHES = 40
# phase 13: a captured fp32 remat step against the unremat'd one: the remat
# test's tolerances (tests/test_torch_remat.py: E/F rtol 1e-6, gradients
# 1e-5). Launches of one remat step: the train step's (TRAIN_LAUNCHES) and
# each block's forward again in the -dE/dR backward and in the loss's
# backward: 2 x 8 more K1
REMAT_RTOL = 1e-6
REMAT_UPDATE_REL_L2 = 1e-5
REMAT_LAUNCHES = dict(TRAIN_LAUNCHES["float32"], gemnet_segment_outer_sum_f32=40)
# phase 14: launches of one fp32 halo train step on each rank, on its local
# rows and plans: TRAIN_LAUNCHES' K1 and K2 (8 forward K1; 8 K2 in -dE/dR;
# 8 K2 for the forward's K1s and 2 K1 + 1 K2 for each first-backward K2 in
# the loss's backward) and no K3: the halo model's expand gathers are plain
# gathers, as the JAX package's (models/interaction.py:64-70)
HALO_LAUNCHES = {"gemnet_segment_outer_sum_f32": 24, "gemnet_segment_gather_contract_f32": 24}
# phase 14: the gloo group's ranks (sharing cuda:0), tests/test_halo.py's
# train-step settings (:241-282: its TrainConfig, whose warm-up is the
# default 3750 steps), the timed bench-large halo steps, and the bound on
# every wait of the spawned group
PARALLEL_RANKS = 2
# phase 14 (f): the training entry point in each mode, `train.run` at the
# config.yaml widths on a synthetic dataset of 48 molecules of 4-12 atoms
# (seed 0), batches of 16, eval and checkpoint every 2 steps
PARALLEL_RUN = dict(batch_size=16, num_steps=4, evaluation_interval=2, save_interval=2,
                    data_seed=0, warmup_steps=1)
PARALLEL_RUN_MOLECULES = 48
HALO_TRAIN = dict(weight_decay=1e-6, loss="mae", rho_force=0.5, learning_rate=3e-3,
                  warmup_steps=3750)
LARGE_HALO_STEPS = 3
PARALLEL_TIMEOUT_S = 400

# phase 15: launches of one fp32 ep train step (rung 2a) on each rank, on
# its chunk of the rows with full-width K1 outputs: the halo step's K1 and
# K2 (HALO_LAUNCHES) and no K3, the chunk carrying no sort metadata
EP_LAUNCHES = HALO_LAUNCHES
# phase 15 (d): the 2-D mesh of gloo ranks on cuda:0 (n_dp, n_ep), its dp
# shards bench-small's two padded halves (padded_parts); dp x halo train
# steps from one state
HYBRID_MESH = (2, 2)
DP_HALO_STEPS = 2
# phase 15 (c): one eager ep step at bench-large a rank, after a warm-up
LARGE_EP_STEPS = 1
# phase 16: the pipeline (`parallel/pp.py`). (a) one stage on the NCCL group
# of one, bench-small in PP_NCCL_MICRO quarters; (c) PP_RANKS gloo ranks,
# bench-small in PP_MICRO eighths (JAX's default M = 4 S), and bench-large
# one system a microbatch; (d) PP_WIDE gloo ranks: S = PP_WIDE (one block a
# stage) and the PP_MESH dp x pp mesh; (e) `train.run(pp=PP_RANKS)` with
# PP_DRIVER_MICRO microbatches a step. A pp step's launches: pp_launches
PP_NCCL_MICRO = 4
PP_RANKS = 2
PP_MICRO = 4 * PP_RANKS
PP_LARGE_MICRO = 4
PP_WIDE = 4
PP_MESH = (2, 2)
PP_DRIVER_MICRO = 4

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


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") with the seconds since the
    script started."""
    if msg.startswith("== "):
        msg += f" (at {time.perf_counter() - _T0:.1f} s)"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi unavailable"


# ---------------------------------------------------------------- kernels

def kernel_cases(cfg, batch, device, seed: int = 0, tags=None):
    """One case per (kernel, shape, stream dtype) of the serving path and
    the train step: the batch's own id columns and sort metadata, random row
    data from a seed (rounded to bf16 for the bf16 cases; the geometry
    streams are fp32 in both modes; fp32 rows for split3, which runs K1 and
    K2 only); and P1/P2 on the gather probe's inputs. `tags`, where given,
    keeps the cases of those shapes only ("probe" for P1/P2)."""
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
            if tags is not None and tag not in tags:
                continue
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
            if (dtype == "split3" or (dtype == "bf16" and tag.startswith("geometry"))
                    or (tags is not None and tag not in tags)):
                continue
            n = batch[idx].shape[0]
            cases.append(dict(kernel="K3", tag=tag, dtype=dtype, x=cast(rand(n, M)),
                              idx=batch[idx], perm=batch[f"{sort}_perm"],
                              sorted=batch[f"{sort}_sorted"], plan=batch[f"{sort}_plan"],
                              shape=(n, M, n_src)))
    if tags is not None and "probe" not in tags:
        return cases
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
        nbytes, flops = roofline.kernel_cost(case["kernel"], case["dtype"], case["shape"])
        t_bytes = nbytes / roofline.H100_DATASHEET["hbm"] * 1e3
        t_flops = flops / roofline.peak_flops(case["dtype"]) * 1e3
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
    batch_np, g, _ = bench.padded_batch(cfg, mols)
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
    sub_np, _, _ = bench.padded_batch(cfg, mols[:n_compare])
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
    trace.profile(lambda: predict(model, batch), "request", log)
    return census, per_kernel, timing, E.cpu().numpy()


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
    batch_np, _, _ = bench.padded_batch(cfg, mols)
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

    sub_np, _, _ = bench.padded_batch(cfg, mols[:8])
    E_gpu, F_gpu = predict(model, to_torch(sub_np, device))
    E_cpu, F_cpu = predict(copy.deepcopy(model).to("cpu"), to_torch(sub_np, "cpu"))
    n_sub = sum(len(z) for z, _ in mols[:8])
    okE, errE = close(E_gpu.cpu().numpy()[:8], E_cpu.numpy()[:8], SERVE_RTOL)
    okF, errF = close(F_gpu.cpu().numpy()[:n_sub], F_cpu.numpy()[:n_sub], SERVE_RTOL)
    log(f"  'high' card vs CPU on the first 8 molecules: max |dE| {errE:.3e}, max |dF| "
        f"{errF:.3e} (rtol {SERVE_RTOL})")
    check(okE and okF, "'high' E/F on the card disagree with the CPU run")
    trace.profile(lambda: predict(model, batch), "'high' request", log)
    return census


def calculator(cfg, device, n_geoms: int = 5, seed: int = 0):
    """Phase 6: the serving calculator on the card (its captured predict)
    against the eager predict on the card and the calculator on the CPU;
    one capture for all the geometries."""
    from gemnet_pytorch_tpu_torch.data import Molecule, to_torch
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
        E_eager, F_eager = predict(calc_dev.model, to_torch(mol_dev.get(), device))
        e_eager = float(E_eager[0, 0])
        f_eager = F_eager[:len(BENZONITRILE_Z), 0, :].cpu().numpy()
        check(np.isfinite(e_dev) and np.isfinite(f_dev).all(), f"geometry {i}: non-finite")
        okE, errE = close(np.array([e_dev]), np.array([e_cpu]), SERVE_RTOL)
        okF, errF = close(f_dev, f_cpu, SERVE_RTOL)
        okEe, errEe = close(np.array([e_dev]), np.array([e_eager]), SERVE_RTOL)
        okFe, errFe = close(f_dev, f_eager, SERVE_RTOL)
        log(f"  geometry {i}: E {e_dev:.6f} eV (CPU {e_cpu:.6f}, eager on the card "
            f"{e_eager:.6f}), max |dF| {errF:.3e} vs the CPU, {errFe:.3e} vs eager")
        check(okE and okF, f"geometry {i}: calculator on the card disagrees with the CPU")
        check(okEe and okFe, f"geometry {i}: the captured predict disagrees with the eager one")
    log(f"  the calculator captured its predict {calc_dev.captured.captures} time(s)")
    check(calc_dev.captured.captures == 1, "the calculator captured more than once")


def serve_large_system(cfg, device):
    """Phase 5, large: the bench-large batch's first 32-atom system (~580k
    quadruplets) served on the card against the same model on the CPU."""
    from gemnet_pytorch_tpu_torch.data import to_torch

    model = make_model(cfg, device)
    mols = bench.molecules("large")[:1]
    sub_np, g, _ = bench.padded_batch(cfg, mols)
    t0 = time.perf_counter()
    E_gpu, F_gpu = predict(model, to_torch(sub_np, device))
    E_cpu, F_cpu = predict(copy.deepcopy(model).to("cpu"), to_torch(sub_np, "cpu"))
    n = len(mols[0][0])
    E_cpu, F_cpu = E_cpu.numpy()[:1], F_cpu.numpy()[:n]
    okE, errE = close(E_gpu.cpu().numpy()[:1], E_cpu, SERVE_RTOL)
    okF, errF = close(F_gpu.cpu().numpy()[:n], F_cpu, SERVE_RTOL)
    log(f"  the large batch's first system ({n} atoms, {g.n_edges} edges, {g.n_triplets} "
        f"triplets, {g.n_quads} quadruplets), card vs CPU: max |dE| {errE:.3e} of |E| "
        f"{float(np.abs(E_cpu).max()):.3e}, max |dF| {errF:.3e} of max |F| "
        f"{float(np.abs(F_cpu).max()):.3e} (rtol {SERVE_RTOL} of max(that, 1); "
        f"{time.perf_counter() - t0:.1f} s)")
    check(bool(np.isfinite(E_gpu.cpu().numpy()).all() and np.isfinite(F_gpu.cpu().numpy()).all()),
          "non-finite E or F on the large system")
    check(okE and okF, "served E/F of the large system on the card disagree with the CPU run")


# ---------------------------------------------------------------- training

def make_trainer(cfg, compute_dtype: str, device, seed: int = 0, train_kw=None):
    """A Trainer of GemNet(cfg) in `compute_dtype`, weights from `seed` (the
    same in both dtypes), at config.yaml's training hyperparameters with the
    learning rate at its full 1e-3 from step 0 (warmup_steps=1), as
    tests/test_bf16.py's train step; `train_kw` sets other TrainConfig
    fields (the Trainer's modes, or another warm-up)."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = GemNet(dataclasses.replace(cfg, compute_dtype=compute_dtype),
                   generator=torch.Generator().manual_seed(seed), device=device)
    trainer = Trainer(model, TrainConfig(**{"warmup_steps": 1, **(train_kw or {})}))
    return trainer, trainer.init_state()


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def eager_step(trainer, state, batch):
    """One eager train step (`Trainer.train_step`) on a batch of tensors:
    (state, loss on the device)."""
    state, metrics, _ = trainer.train_step(state, batch, 1.0)
    return state, metrics["loss"].detach()


def step_card_vs_cpu(cfg, mols, device, label: str, compute_dtype: str = "float32",
                     train_kw=None, loss_rtol: float = TRAIN_LOSS_RTOL,
                     update_rel: float | None = TRAIN_UPDATE_REL_L2):
    """One train step (weights from seed 0) on the card, the captured step
    of `train_on_batch`, and on the CPU on `mols`: the loss within
    `loss_rtol`, the whole update within a relative L2 error of
    `update_rel` (printed only where it is None)."""
    sub_np, _, _ = bench.padded_batch(cfg, mols)
    steps = {}
    for dev in (device, "cpu"):
        trainer, state = make_trainer(cfg, compute_dtype, dev, train_kw=train_kw)
        p0 = state.params.clone()
        state, loss = trainer.train_on_batch(state, sub_np, 1.0)
        steps[str(dev)] = (float(loss), (state.params - p0).cpu().numpy())
    (loss_gpu, d_gpu), (loss_cpu, d_cpu) = steps[str(device)], steps["cpu"]
    rel = rel_l2(d_gpu, d_cpu)
    log(f"  {label} step, card vs CPU on the first {len(mols)} molecules: loss {loss_gpu:.6f} vs "
        f"{loss_cpu:.6f} (rtol {loss_rtol}), update rel L2 {rel:.3e} (limit {update_rel})")
    check(abs(loss_gpu - loss_cpu) <= loss_rtol * abs(loss_cpu),
          f"{label} train-step loss on the card disagrees with the CPU")
    check(update_rel is None or rel <= update_rel,
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
    """One eager train step with the launch counters read around it, inside
    the roofline's kernel census, which must record every launch: (state,
    loss, census by kernel and shape, launches by kernel)."""
    import collections

    import torch

    from gemnet_pytorch_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    result = []
    census = roofline.kernel_census(
        lambda: result.append(eager_step(trainer, state, batch)))
    state, loss = result[0]
    torch.cuda.synchronize()
    per_kernel = _cuda.kernel_launches()
    log(f"  one {label} train step launched {per_kernel}; kernel census {len(census)} calls")
    recorded = collections.Counter((c["fn"], c["shape"]) for c in census)
    check(recorded == _cuda.LAUNCHES,
          f"{label} step: the kernel census {dict(recorded)} differs from the launches "
          f"{dict(_cuda.LAUNCHES)}")
    return state, loss, dict(_cuda.LAUNCHES), per_kernel


def timed_steps(trainer, state, batch, n_agg: int, label: str, n_timed: int = 10,
                warmup: int = 3) -> dict:
    """`warmup` then `n_timed` eager steps on the host clock, ending in a
    synchronize; then one profiled step."""
    import torch

    for _ in range(warmup):
        eager_step(trainer, state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        eager_step(trainer, state, batch)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / n_timed
    timing = dict(ms_per_step=sec * 1e3, agg_per_s=n_agg / sec,
                  max_memory_allocated=torch.cuda.max_memory_allocated())
    log(f"  {label}: {n_timed} timed steps, {timing['ms_per_step']:.3f} ms/step, "
        f"{timing['agg_per_s']:.4e} triplets+quads/s ({n_agg} real rows), "
        f"max_memory_allocated {timing['max_memory_allocated'] / 2**20:.1f} MiB")
    timing["profile"] = trace.profile(lambda: eager_step(trainer, state, batch),
                                      f"{label} train step", log)
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
    sub_np, _, _ = bench.padded_batch(cfg, mols[:n_compare])

    batch_np, g, _ = bench.padded_batch(cfg, mols)
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
            state, loss = eager_step(trainer, state, batch)
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
        val_loss = trainer.test_on_batch(state, batch_np, val, use_ema=True)
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

    batch_np, g, _ = bench.padded_batch(hcfg, mols)
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
                            export_torch=export, steps_per_call=STEPS_PER_CALL)
    log(f"  train.run, {TRAIN_RUN['num_steps']} steps ({STEPS_PER_CALL} per call, captured) on "
        f"{TRAIN_RUN_MOLECULES} synthetic molecules in {time.perf_counter() - t0:.1f} s: best "
        f"{best}")
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
                         synthetic_molecules=TRAIN_RUN_MOLECULES, steps_per_call=STEPS_PER_CALL)
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
    one = to_torch(bench.padded_batch(hcfg, mols[:8])[0], device)
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


# ---------------------------------------------------------------- graphs

def capacity_plans(cfg, device):
    """Phase 11: every kernel case of phase 3 (but the probe's) at the
    bench-small shapes, and the quadruplet and quad_abd cases at the
    bench-large shapes, on the batch's capacity plans and on its exact
    plans: the same bits, the counters back at zero."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch

    small_tags = ("triplet", "quadruplet", "trip_ba", "intm_db", "quad_abd", "geometry_abd",
                  "geometry_cab")
    n_cases = 0
    for kind, tags in (("small", small_tags), ("large", LARGE_TAGS)):
        batch_np, _, _ = bench.padded_batch(cfg, bench.molecules(kind))
        exact = kernel_cases(cfg, to_torch(batch_np, device, capacity=False), device, tags=tags)
        cap = kernel_cases(cfg, to_torch(batch_np, device), device, tags=tags)
        for ce, cc in zip(exact, cap):
            out_e, out_c = case_functions(ce)[0](), case_functions(cc)[0]()
            torch.cuda.synchronize()
            pe, pc = ce["plan"], cc["plan"]
            equal = all(torch.equal(a, b) for a, b in zip(out_e, out_c))
            log(f"  {case_label(cc)} @{kind}: items {pe.items.shape[0]} exact, "
                f"{pc.items.shape[0]} at capacity; bit-equal {equal}")
            check(equal, f"{case_label(cc)} @{kind}: the capacity plan's output differs from "
                  "the exact plan's")
            check(int(pc.arrivals.abs().sum()) + int(pc.tree_arrivals.abs().sum()) == 0,
                  f"{case_label(cc)} @{kind} left a counter of its capacity plan non-zero")
            n_cases += 1
        del exact, cap
        torch.cuda.empty_cache()
    return n_cases


def nondeterministic_ops(batch, device) -> list[str]:
    """The ops of the step that sum with float atomics, each run twice on
    the same inputs at the batch's shapes: the names of those whose two
    results differ in their bits."""
    import torch

    from gemnet_pytorch_tpu_torch.ops.segment import masked_segment_sum

    gen = torch.Generator(device=device).manual_seed(0)
    n_atoms = batch["Z"].shape[0]
    x = torch.randn(batch["id_a"].shape[0], 128, generator=gen, device=device)
    idx = batch["id4_expand_abd"]
    rows = torch.randn(idx.shape[0], 32, generator=gen, device=device)
    n_src = batch["id4_reduce_intm_ca"].shape[0]
    probes = {
        "index_add (ops/segment.py masked_segment_sum, edges -> atoms)":
            lambda: masked_segment_sum(x, batch["id_a"], n_atoms),
        "index_put_ accumulate (the backward of the plain gathers h[idx])":
            lambda: torch.zeros(n_src, 32, device=device).index_put_((idx,), rows,
                                                                     accumulate=True),
    }
    out = []
    for name, fn in probes.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            out.append(name)
    return out


def op_order(trainer, state, batch, start, runs: int = 2):
    """The aten ops of `runs` eager steps from `start`, in the order they
    ran: (whether every run ran them in one order, the first place where
    two differ as "i: op | op")."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[-1].append(str(func))
            return func(*args, **(kwargs or {}))

    for _ in range(runs):
        state_restore(state, start)
        seen.append([])
        with Record():
            trainer.train_step(state, batch, 1.0)
    first = next(((i, x, y) for i, (x, y) in enumerate(zip(seen[0], seen[-1])) if x != y),
                 None)
    return first is None, (f"{first[0]}: {first[1]} | {first[2]}" if first else "")


def state_copy(state):
    from gemnet_pytorch_tpu_torch.training.trainer import _state_tensors

    return [t.clone() for t in _state_tensors(state)]


def state_restore(state, saved):
    from gemnet_pytorch_tpu_torch.training.trainer import _state_tensors

    for t, v in zip(_state_tensors(state), saved):
        t.copy_(v)


def five_steps(trainer, state, start, p0, step):
    """CAPTURED_STEPS calls of `step()` from the state `start`: (losses,
    parameters, accumulators) after them."""
    import torch

    state_restore(state, start)
    losses = []
    for _ in range(CAPTURED_STEPS):
        losses.append(step()["loss"].detach().clone())
    torch.cuda.synchronize()
    return (torch.stack(losses).cpu().numpy(), state.params.clone(), state.metric_acc.clone())


def run_diffs(run, ref, p0):
    """(max loss rel, update rel L2, max accumulator rel) of `run` against
    `ref`, both from five_steps, and whether they are bit-equal."""
    import torch

    (l1, p1, m1), (l0, pr, m0) = run, ref
    diffs = (float(np.max(np.abs(l1 - l0) / np.abs(l0))),
             rel_l2((p1 - p0).cpu().numpy(), (pr - p0).cpu().numpy()),
             float(((m1 - m0).abs() / m0.abs().clamp_min(1e-30)).max()))
    return diffs, bool(np.array_equal(l1, l0) and torch.equal(p1, pr) and torch.equal(m1, m0))


def captured_steps(cfg, mols, device, mode: str, workdir: str):
    """Phase 11, one mode. With torch.use_deterministic_algorithms (index_add
    then sums without float atomics): CAPTURED_STEPS eager steps twice and
    captured steps once from one state, held to the gates; 4 steps in one
    call against 4 single replays; the accumulators drained after the
    replays against the eager ones. Without it (as every other phase runs):
    a fresh trainer's captured step against its eager one, printed with
    the ops whose float atomics make two eager runs differ; the capture's
    launches and the graph's hand-written kernel nodes against the eager
    step's; eager and captured ms per step. Returns (the capture's launches,
    the timing dict)."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch import graphs
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.training import Metrics

    dtype, precision = GRAPH_MODES[mode]
    mcfg = dataclasses.replace(cfg, matmul_precision=precision)
    batch_np, g, _ = bench.padded_batch(mcfg, mols)
    if dtype == "bfloat16":
        loss_tol = update_tol = acc_tol = BF16_CARD_VS_CPU
    else:
        loss_tol, update_tol, acc_tol = CAPTURED_LOSS_RTOL, CAPTURED_UPDATE_REL_L2, 1e-5

    def setup(debug=False):
        trainer, state = make_trainer(mcfg, dtype, device)
        trainer.graph_debug = debug
        batch = to_torch(batch_np, device)
        words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
        return (trainer, state, batch, words, trainer.train_step_fn(), state_copy(state),
                state.params.clone())

    # warn_only: an op without a deterministic implementation warns (and two
    # eager runs then differ, which the log shows) instead of raising
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer, state, batch, words, step_fn, start, p0 = setup()
        eager = lambda: trainer.train_step(state, batch, 1.0)[1]  # noqa: E731
        captured = lambda: step_fn(state, words, 1.0)[1]  # noqa: E731
        a, b, c = (five_steps(trainer, state, start, p0, fn) for fn in (eager, eager, captured))
        (ab, ab_equal), (ca, ca_equal) = run_diffs(b, a, p0), run_diffs(c, a, p0)
        log(f"  {mode}, deterministic algorithms: {CAPTURED_STEPS} steps, losses eager "
            f"{', '.join(f'{x:.6f}' for x in a[0])}; two eager runs bit-equal {ab_equal} "
            f"({', '.join(f'{x:.3e}' for x in ab)}); captured vs eager bit-equal {ca_equal}: "
            f"max loss rel {ca[0]:.3e}, update rel L2 {ca[1]:.3e}, accumulators rel "
            f"{ca[2]:.3e}")
        if ab_equal:
            check(ca_equal, f"{mode}: two eager runs are bit-equal and the captured run is not")
        else:
            # the autograd engine orders the second backward by sequence
            # numbers that the forward's thread and the first backward's
            # device thread count apart, so where they interleave can move
            # from step to step, and with it the order gradients are summed
            same, where = op_order(trainer, state, batch, start)
            log(f"    two eager steps ran their ops in one order: {same}"
                + ("" if same else f"; they part at op {where} (the autograd engine's order "
                   "of the backward, and so of its gradient sums)"))
        check(ca[0] <= loss_tol and ca[1] <= update_tol and ca[2] <= acc_tol,
              f"{mode}: the captured step disagrees with the eager one")

        # K steps per call against K single replays, from the same start
        rows = words.reshape(1, -1).expand(STEPS_PER_CALL, -1).contiguous()
        outs = []
        for call in ("single", "multi"):
            state_restore(state, start)
            if call == "single":
                for _ in range(STEPS_PER_CALL):
                    metrics = step_fn(state, words, 1.0)[1]
            else:
                metrics = trainer.multi_step_fn()(state, rows, 1.0)[1]
            outs.append((np.array([float(metrics["loss"])]), state.params.clone(),
                         state.metric_acc.clone()))
        kd, k_equal = run_diffs(outs[1], outs[0], p0)
        log(f"  {mode}: {STEPS_PER_CALL} steps in one call vs {STEPS_PER_CALL} single replays: "
            f"bit-equal {k_equal}, last loss rel {kd[0]:.3e}, update rel L2 {kd[1]:.3e}")
        check(kd[0] <= loss_tol and kd[1] <= update_tol and kd[2] <= acc_tol,
              f"{mode}: the K-step call disagrees with K single replays")

        # the accumulators drained after replays, as the eager ones
        expected = Metrics("eager", trainer.tracked_metrics)
        for key, (wsum, w) in zip(trainer.tracked_metrics, a[2].cpu().numpy()):
            expected.update_state(float(w), **{key: wsum / w})
        five_steps(trainer, state, start, p0, captured)
        drained = Metrics("train", trainer.tracked_metrics)
        trainer.drain_metrics(state, drained)
        got, want = drained.result(append_tag=False), expected.result(append_tag=False)
        rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
        log(f"  {mode}: drained after {CAPTURED_STEPS} replays, vs the eager accumulators rel "
            f"{rel:.3e}")
        check(rel <= acc_tol and float(state.metric_acc.abs().sum()) == 0.0,
              f"{mode}: drained metrics disagree with the eager accumulators")
        del trainer, state, batch, words, step_fn, rows
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()

    # as every other phase runs: index_add with its float atomics
    trainer, state, batch, words, step_fn, start, p0 = setup(debug=True)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    trainer.train_step(state, batch, 1.0)
    torch.cuda.synchronize()
    eager_launches = collections.Counter(_cuda.LAUNCHES)
    eager = lambda: trainer.train_step(state, batch, 1.0)[1]  # noqa: E731
    captured = lambda: step_fn(state, words, 1.0)[1]  # noqa: E731
    a, b, c = (five_steps(trainer, state, start, p0, fn) for fn in (eager, eager, captured))
    (ab, ab_equal), (ca, ca_equal) = run_diffs(b, a, p0), run_diffs(c, a, p0)
    ops = [] if ab_equal else nondeterministic_ops(batch, device)
    log(f"  {mode}, default algorithms: two eager runs bit-equal {ab_equal} (max loss rel, "
        f"update rel L2, accumulators rel: {', '.join(f'{x:.3e}' for x in ab)}); captured vs "
        f"eager bit-equal {ca_equal} ({', '.join(f'{x:.3e}' for x in ca)}); ops whose two "
        f"runs differ in their bits: {ops}")
    cap = trainer._captured[1]
    n_calls = sum(TRAIN_LAUNCHES[mode].values())
    nodes, handwritten = graphs.kernel_nodes(cap.graph, os.path.join(workdir, f"{mode}.dot"))
    log(f"  {mode}: captured in {cap.seconds:.2f} s (warm-up included); the capture recorded "
        f"{sum(cap.launches.values())} hand-written kernel launches (eager step: "
        f"{sum(eager_launches.values())}, pinned {n_calls}); the graph holds {nodes} kernel "
        f"nodes, {handwritten} of them hand-written")
    check(cap.launches == eager_launches and sum(cap.launches.values()) == n_calls,
          f"{mode}: the capture's launches {dict(cap.launches)} are not the eager step's")
    check(handwritten == n_calls, f"{mode}: the graph holds {handwritten} hand-written kernel "
          f"nodes, the step launches {n_calls}")
    timing = {}
    if mode != "high":
        timing = time_eager_and_captured(lambda: eager()["loss"], lambda: captured()["loss"],
                                         cap.graph, f"{mode} step")
        timing["agg_per_s"] = (g.n_triplets + g.n_quads) / timing["captured_ms"] * 1e3
    del trainer, state, batch, words, step_fn, cap
    torch.cuda.empty_cache()
    return eager_launches, timing


def time_eager_and_captured(eager, captured, graph, what: str, n: int = 20,
                            warmup: int = 3) -> dict:
    """ms per call of `eager()` and of `captured()` (a replay of `graph`):
    host clock around `n` calls ending in torch.cuda.synchronize(), after
    `warmup`; the peak device memory over each's calls, the captured one's
    with the graph's private pool (`graphs.pool_mib`) added."""
    import torch

    from gemnet_pytorch_tpu_torch import graphs

    out = {}
    for name, fn in (("eager", eager), ("captured", captured)):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) / n * 1e3
        out[f"{name}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["pool_mib"] = graphs.pool_mib(graph)
    out["captured_peak_mib"] += out["pool_mib"]
    log(f"  {what}: eager {out['eager_ms']:.3f} ms, captured {out['captured_ms']:.3f} ms "
        f"({n} calls each); peak {out['eager_peak_mib']:.1f} / {out['captured_peak_mib']:.1f} "
        f"MiB, the graph pool {out['pool_mib']:.1f} MiB of it")
    return out


def captured_predict(cfg, mols, device):
    """Phase 11: the captured predict (md.CapturedPredict) of the first 8
    bench-small molecules against the eager predict on the card and the
    CPU (rtol SERVE_RTOL on E and F); ms per request of the bench-small
    batch, eager and captured. Returns (the capture's launches, timing)."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.md import CapturedPredict

    model = make_model(cfg, device)
    sub_np, _, _ = bench.padded_batch(cfg, mols[:8])
    cap = CapturedPredict(model, device)
    E, F = (t.cpu().numpy() for t in cap(sub_np))
    E_eager, F_eager = (t.cpu().numpy() for t in predict(model, to_torch(sub_np, device)))
    E_cpu, F_cpu = (t.numpy() for t in predict(copy.deepcopy(model).to("cpu"),
                                                to_torch(sub_np, "cpu")))
    n_sub = sum(len(z) for z, _ in mols[:8])
    errs = [close(a[:k], b[:k], SERVE_RTOL) for a, b, k in
            ((E, E_eager, 8), (F, F_eager, n_sub), (E, E_cpu, 8), (F, F_cpu, n_sub))]
    log(f"  captured predict, first 8 molecules: max |dE| {errs[0][1]:.3e}, |dF| "
        f"{errs[1][1]:.3e} vs eager on the card; |dE| {errs[2][1]:.3e}, |dF| {errs[3][1]:.3e} "
        f"vs the CPU (rtol {SERVE_RTOL})")
    check(all(ok for ok, _ in errs), "the captured predict disagrees with the eager one or "
          "the CPU")
    launches = cap._captured[1].launches
    # a request of the bench-small batch, its tensors (eager) or its packed
    # words (captured) already on the card, as phase 5 times it
    batch_np, _, _ = bench.padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    full = CapturedPredict(model, device)
    t0 = time.perf_counter()
    row = full.packer.pack(batch_np)
    pack_ms = (time.perf_counter() - t0) * 1e3
    words = full.packer.to_device(row, device)
    full(words)  # the capture
    timing = time_eager_and_captured(lambda: predict(model, batch), lambda: full(words),
                                     full._captured[1].graph, "request (bench-small batch)")
    timing["molecules_per_s"] = len(mols) / timing["captured_ms"] * 1e3
    timing["pack_ms"] = pack_ms
    log(f"  packing the bench-small batch on the host: {pack_ms:.1f} ms ({row.nbytes / 2**20:.1f} "
        "MiB)")
    return launches, timing


def md_run(cfg, mols, device):
    """Phase 11: MD_STEPS captured Velocity Verlet steps on the first
    bench-small molecule: the energy drift against tests/test_md.py's bound
    (5 x max(1e-3, std of E)); the predict captured once."""
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    Z, R = mols[0]
    mol = Molecule(R, Z, cfg.cutoff, cfg.int_cutoff, triplets_only=cfg.triplets_only)
    sim = MDSimulator(mol, make_model(cfg, device), max_steps=MD_STEPS, device=device,
                      **MD_SETTINGS)
    t0 = time.perf_counter()
    traj = sim.run()
    sec = time.perf_counter() - t0
    etot = [traj.frames_E[i] + 0.5 * float((sim.masses * traj.frames_v[i] ** 2).sum())
            for i in range(len(traj))]
    drift = abs(etot[-1] - etot[0])
    bound = 5 * max(1e-3, float(np.std(traj.frames_E)))
    log(f"  MD: {MD_STEPS} Verlet steps of {MD_SETTINGS['time']} fs on a {len(Z)}-atom bench "
        f"molecule in {sec:.2f} s ({sec / MD_STEPS * 1e3:.2f} ms a step, graph build included), "
        f"{sim.calc.captured.captures} capture(s); E_tot {etot[0]:.6f} -> {etot[-1]:.6f} eV, "
        f"drift {drift:.3e} eV (bound {bound:.3e})")
    check(len(traj) == MD_STEPS and np.isfinite(etot).all(), "MD: non-finite trajectory")
    check(drift < bound, "MD: the total energy drifts past the bound")
    return dict(md_ms_per_step=sec / MD_STEPS * 1e3, md_drift=drift)


def graphs_phase(cfg, mols, device, workdir: str):
    """Phase 11. Returns (the launches its graphs hold, by kernel and shape;
    the timings)."""
    n = capacity_plans(cfg, device)
    log(f"  {n} kernel cases bit-equal on capacity and exact plans")
    census, timing = collections.Counter(), {}
    for mode in GRAPH_MODES:
        launches, timing[mode] = captured_steps(cfg, mols, device, mode, workdir)
        census.update(launches)
    launches, timing["request"] = captured_predict(cfg, mols, device)
    census.update(launches)
    timing["md"] = md_run(cfg, mols, device)
    return census, timing


# ---------------------------------------------------------------- the rest of training

def time_captured(fn, graph, what: str, base: int, n: int = 10, warmup: int = 2) -> dict:
    """ms per call of `fn()` (a replay of `graph`; host clock around `n`
    calls ending in torch.cuda.synchronize(), after `warmup`), the peak
    device memory over them above `base` (what the process held before the
    trainer was built) with the graph's private pool added, and the device
    ms of one call from a profiled call (`trace.profile`)."""
    import torch

    from gemnet_pytorch_tpu_torch import graphs

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    out = dict(ms=(time.perf_counter() - t0) / n * 1e3, pool_mib=graphs.pool_mib(graph))
    out["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20 + out["pool_mib"]
    prof = trace.profile(fn, what, log, top=6)
    out["device_ms"] = prof["device_ms"] if prof else None
    log(f"  {what}: {out['ms']:.3f} ms ({n} replays), device "
        + (f"{out['device_ms']:.3f} ms" if prof else "not measured")
        + f", peak {out['peak_mib']:.1f} MiB (graph pool {out['pool_mib']:.1f})")
    return out


def mve_steps(cfg, mols, device, mode: str):
    """Phase 12, MVE in one mode of GRAPH_MODES: with deterministic
    algorithms, CAPTURED_STEPS captured steps against as many eager ones
    from one state, held to phase 11's gates; the launches of one eager
    MVE step against MVE_LAUNCHES and the capture's against them. Returns
    the capture's launches."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda

    def launches():
        torch.cuda.synchronize()
        return collections.Counter(_cuda.LAUNCHES)

    dtype, precision = GRAPH_MODES[mode]
    mcfg = dataclasses.replace(cfg, matmul_precision=precision, num_targets=2)
    batch_np, _, _ = bench.padded_batch(mcfg, mols)
    if dtype == "bfloat16":
        loss_tol = update_tol = acc_tol = BF16_CARD_VS_CPU
    else:
        loss_tol, update_tol, acc_tol = CAPTURED_LOSS_RTOL, CAPTURED_UPDATE_REL_L2, 1e-5
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer, state = make_trainer(mcfg, dtype, device, train_kw=MVE_TRAIN)
        batch = to_torch(batch_np, device)
        words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
        step_fn, start, p0 = trainer.train_step_fn(), state_copy(state), state.params.clone()
        before = launches()
        trainer.train_step(state, batch, 1.0)
        eager_launches = launches()
        eager_launches.subtract(before)
        eager_launches = +eager_launches
        per_kernel = collections.Counter()
        for (name, _), n in eager_launches.items():
            per_kernel[name] += n
        eager = lambda: trainer.train_step(state, batch, 1.0)[1]  # noqa: E731
        captured = lambda: step_fn(state, words, 1.0)[1]  # noqa: E731
        a, c = (five_steps(trainer, state, start, p0, fn) for fn in (eager, captured))
        (ca, ca_equal) = run_diffs(c, a, p0)
    finally:
        torch.use_deterministic_algorithms(False)
    cap = trainer._captured[1]
    log(f"  MVE {mode}, deterministic algorithms: {CAPTURED_STEPS} steps, losses eager "
        f"{', '.join(f'{x:.6f}' for x in a[0])}; captured vs eager bit-equal {ca_equal}: max "
        f"loss rel {ca[0]:.3e}, update rel L2 {ca[1]:.3e}, accumulators rel {ca[2]:.3e}; "
        f"one MVE step launched {dict(per_kernel)} (captured {sum(cap.launches.values())})")
    check(bool(np.isfinite(a[0]).all()) and a[2].shape[0] == 8, f"MVE {mode}: non-finite losses "
          "or not the 8 MVE metrics")
    check(ca[0] <= loss_tol and ca[1] <= update_tol and ca[2] <= acc_tol,
          f"MVE {mode}: the captured step disagrees with the eager one")
    check(dict(per_kernel) == MVE_LAUNCHES[mode],
          f"MVE {mode} step launched {per_kernel}, expected {MVE_LAUNCHES[mode]}")
    check(cap.launches == eager_launches, f"MVE {mode}: the capture's launches are not the "
          "eager step's")
    del trainer, state, batch, words, step_fn, cap
    torch.cuda.empty_cache()


def captured_trainer(cfg, kind: str, device, compute_dtype="float32", train_kw=None):
    """(trainer, state, its captured step fn() -> loss, seconds of the first
    call (the capture), real rows, device bytes held before the trainer)
    on a bench batch."""
    import torch

    base = torch.cuda.memory_allocated()
    batch_np, g, _ = bench.padded_batch(cfg, bench.molecules(kind))
    trainer, state = make_trainer(cfg, compute_dtype, device, train_kw=train_kw)
    words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
    step_fn = trainer.train_step_fn()

    def fn():
        return step_fn(state, words, 1.0)[1]["loss"]

    t0 = time.perf_counter()
    float(fn())
    return trainer, state, fn, time.perf_counter() - t0, g.n_triplets + g.n_quads, base


def mve_timing(cfg, kind: str, device, compute_dtype: str) -> dict:
    """Phase 12: the captured MVE step on a bench batch (`time_captured`)."""
    import torch

    trainer, state, fn, capture_s, n_real, base = captured_trainer(
        cfg, kind, device, compute_dtype, MVE_TRAIN)
    out = time_captured(fn, trainer._captured[1].graph,
                        f"MVE {compute_dtype} captured step, bench-{kind}", base)
    out.update(capture_s=capture_s, agg_per_s=n_real / out["ms"] * 1e3)
    del trainer, state, fn
    torch.cuda.empty_cache()
    return out


def optimizer_timing(cfg, device, rounds: int = 3, n: int = 10) -> dict:
    """Phase 12: the captured fp32 step of bench-small with the flat
    optimizer and each of TREE_MODES, every trainer captured first, then
    timed in turns (n replays each, the order reversed every other round);
    per mode the median ms of the rounds, and one profiled call's device
    ms."""
    import torch

    modes = {"flat": {}, **TREE_MODES}
    runs = {m: captured_trainer(cfg, "small", device, train_kw=kw) for m, kw in modes.items()}
    times = {m: [] for m in modes}
    for r in range(rounds):
        for m in (list(modes) if r % 2 == 0 else list(modes)[::-1]):
            fn = runs[m][2]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            times[m].append((time.perf_counter() - t0) / n * 1e3)
    out = {}
    for m in modes:
        prof = trace.profile(runs[m][2], f"{m} fp32 captured step, bench-small", log, top=3)
        out[m] = dict(ms=float(np.median(times[m])), rounds_ms=times[m],
                      device_ms=prof["device_ms"] if prof else None)
        log(f"  {m} fp32 captured step, bench-small, in turns: "
            f"{', '.join(f'{t:.3f}' for t in times[m])} ms (median {out[m]['ms']:.3f}), device "
            + (f"{out[m]['device_ms']:.3f} ms" if prof else "not measured"))
    del runs
    torch.cuda.empty_cache()
    return out


def captured_eval(cfg, mols, device) -> dict:
    """Phase 12: after 2 captured steps, the captured eval of the EMA
    weights and of the current ones against the eager eval with
    deterministic algorithms (metrics rtol EVAL_RTOL); ms per eval batch of
    the bench-small batch, eager and captured."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch

    batch_np, _, _ = bench.padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    trainer, state = make_trainer(cfg, "float32", device)
    for _ in range(2):
        state, _ = trainer.train_on_batch(state, batch_np, 1.0)
    eval_fn = trainer.eval_step_fn()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        errs = {}
        for use_ema in (True, False):
            got = {k: float(v) for k, v in eval_fn(state, batch_np, use_ema)[0].items()}
            want = {k: float(v) for k, v in trainer.eval_step(state, batch, use_ema)[0].items()}
            errs[use_ema] = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    finally:
        torch.use_deterministic_algorithms(False)
    graphs_of = trainer._forward_captured["eval"]
    log(f"  captured eval vs eager, deterministic algorithms: EMA weights max rel "
        f"{errs[True]:.3e}, current weights {errs[False]:.3e} (rtol {EVAL_RTOL}); "
        f"{len(graphs_of)} eval graphs, the parameters bound to the trained buffer after: "
        f"{params_view(trainer.model, state.params)}")
    check(max(errs.values()) <= EVAL_RTOL, "the captured eval disagrees with the eager one")
    check(len(graphs_of) == 2 and params_view(trainer.model, state.params),
          "the captured eval is not keyed on the bound weights")
    words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
    graph = graphs_of[(trainer.packer.version, state.ema_params.data_ptr())][0].graph
    timing = time_eager_and_captured(
        lambda: trainer.eval_step(state, batch, True)[0]["loss"],
        lambda: eval_fn(state, words, True)[0]["loss"], graph,
        "eval batch on the EMA weights (bench-small)")
    del trainer, state, batch, words
    torch.cuda.empty_cache()
    return timing


def fitting(device, workdir: str) -> dict:
    """Phase 12: `fit_scaling.run` (config.yaml's GemNet-Q, direct forces
    forced: 34 factors) on the card, FIT_BATCHES batches of 32 per factor,
    timed; then at batches of FIT_COMPARE_BATCH on the card and on the CPU:
    the factors within FIT_RTOL."""
    import os

    from gemnet_pytorch_tpu_torch import fit_scaling

    def run(tag, dev, batch_size):
        os.makedirs(os.path.join(workdir, tag))
        t0 = time.perf_counter()
        fitted = fit_scaling.run({}, device=dev, n_batches=FIT_BATCHES, batch_size=batch_size,
                                 scale_file=os.path.join(workdir, tag, "scaling_factors.json"))
        return fitted, time.perf_counter() - t0

    fitted, wall = run("card32", device, 32)
    check(len(fitted) == 34 and all(np.isfinite(v) and v > 0 for v in fitted.values()),
          f"fitting on the card: {len(fitted)} factors, or a non-finite one")
    card, card_s = run("card8", device, FIT_COMPARE_BATCH)
    cpu, cpu_s = run("cpu8", "cpu", FIT_COMPARE_BATCH)
    rel = max(abs(card[k] - cpu[k]) / abs(cpu[k]) for k in cpu)
    log(f"  fit_scaling.run, 34 factors x {FIT_BATCHES} batches of 32 on the card: {wall:.1f} s "
        f"(factors {min(fitted.values()):.4f}-{max(fitted.values()):.4f}); at batches of "
        f"{FIT_COMPARE_BATCH}: card {card_s:.1f} s, CPU {cpu_s:.1f} s, max rel {rel:.3e} "
        f"(rtol {FIT_RTOL})")
    check(sorted(card) == sorted(cpu) and rel <= FIT_RTOL,
          "the factors fitted on the card disagree with the CPU's")
    return dict(fit_s=wall, fit8_card_s=card_s, fit8_cpu_s=cpu_s, fit_rel=rel)


def rest_phase(cfg, mols, device, workdir: str) -> dict:
    """Phase 12. Returns the timings."""
    import dataclasses

    timing = {}
    mve_cfg = dataclasses.replace(cfg, num_targets=2)
    for dtype in ("float32", "bfloat16"):
        # bf16: the loss to the bf16 contract, the update printed only, as
        # tests/test_torch_cuda.py's bf16 step (the card's kernels and the
        # CPU's plain versions round apart, and Adam's first update,
        # ~lr·sign(g), flips with the sign of every near-zero gradient)
        tol = (dict(loss_rtol=BF16_CARD_VS_CPU, update_rel=None)
               if dtype == "bfloat16" else {})
        step_card_vs_cpu(mve_cfg, mols[:8], device, f"MVE {dtype}", dtype, MVE_TRAIN, **tol)
    for mode in GRAPH_MODES:
        mve_steps(cfg, mols, device, mode)
    for kind in bench.KINDS:
        for dtype in ("bfloat16", "float32"):
            timing[f"mve_{kind}_{dtype}"] = mve_timing(mve_cfg, kind, device, dtype)
    for mode, kw in TREE_MODES.items():
        step_card_vs_cpu(cfg, mols[:8], device, mode, train_kw=kw)
    timing["optimizer"] = optimizer_timing(cfg, device)
    timing["eval"] = captured_eval(cfg, mols, device)
    timing.update(fitting(device, workdir))
    return timing


# ---------------------------------------------------------------- the rest of the single-device stack

# phase 13's graph builders: the native one and the numpy reference
BUILDERS = {"native": build_graph, "numpy": build_graph_numpy}

def graph_fields_equal(a, b) -> bool:
    import dataclasses

    return all(getattr(a, f.name).dtype == getattr(b, f.name).dtype
               and np.array_equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


def host_ms(fn, n: int = BUILDER_REPEATS) -> float:
    """Median host ms of `n` calls of fn()."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def builders(cfg) -> dict:
    """Phase 13 (a): the native graph builder, built on this host, against
    the numpy builder at both bench batches, array for array; each
    builder's host ms (median of BUILDER_REPEATS)."""
    from gemnet_pytorch_tpu_torch.data import native

    log(f"  native builder: {native.build()}")
    out = {}
    for kind in bench.KINDS:
        mols = bench.molecules(kind)
        N = np.array([len(z) for z, _ in mols])
        R = np.concatenate([r for _, r in mols])

        def run(backend):
            return BUILDERS[backend](R, N, cfg.cutoff, cfg.int_cutoff,
                                     triplets_only=cfg.triplets_only)

        g_native, g_numpy = run("native"), run("numpy")
        check(graph_fields_equal(g_native, g_numpy),
              f"bench-{kind}: the native graph builder disagrees with the numpy one")
        ms = {backend: host_ms(lambda: run(backend)) for backend in ("numpy", "native")}
        out[kind] = ms
        log(f"  bench-{kind} ({g_native.n_edges} edges, {g_native.n_triplets} triplets, "
            f"{g_native.n_quads} quads): native equals numpy array for array; host ms "
            f"(median of {BUILDER_REPEATS}): numpy {ms['numpy']:.2f}, native {ms['native']:.2f} "
            f"({ms['numpy'] / ms['native']:.1f}x)")
    return out


def provider_rates(cfg, workdir: str, step_ms=None) -> dict:
    """Phase 13 (b): padded, packed batches per second out of a
    DataProvider with two prefetch workers (train.py's provider: batches
    of 32, the packer's `pack` in the workers), on train.py's synthetic
    dataset, with the numpy and the native builder; beside the captured
    fp32 small step's ms (phase 11), where given."""
    from unittest import mock

    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider, containers
    from gemnet_pytorch_tpu_torch.data import make_dataset
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker

    path = os.path.join(workdir, "provider.npz")
    make_dataset(path, n_molecules=PROVIDER_MOLECULES, seed=0)
    out = {}
    for backend in ("numpy", "native"):
        with mock.patch.object(containers, "build_graph", BUILDERS[backend]):
            provider = DataProvider(DataContainer(path, cfg.cutoff, cfg.int_cutoff),
                                    ntrain=PROVIDER_MOLECULES, nval=0, batch_size=32, seed=0)
            batches = provider.get_dataset("train", prefetch_workers=2,
                                           transform=BatchPacker().pack)
            for _ in range(PROVIDER_WARMUP):
                next(batches)
            t0 = time.perf_counter()
            for _ in range(PROVIDER_BATCHES):
                next(batches)
            out[backend] = PROVIDER_BATCHES / (time.perf_counter() - t0)
            batches.close()
    beside = (f"; the captured fp32 small step takes {step_ms:.3f} ms ({1e3 / step_ms:.1f} "
              "steps/s)" if step_ms else "")
    log(f"  DataProvider, batches of 32 packed in 2 prefetch workers ({PROVIDER_BATCHES} "
        f"batches): numpy {out['numpy']:.1f} batches/s ({1e3 / out['numpy']:.2f} ms a batch), "
        f"native {out['native']:.1f} batches/s ({1e3 / out['native']:.2f} ms){beside}")
    return out


def md_parts(cfg, mols, device) -> dict:
    """Phase 13 (c): phase 11's MD run (MD_STEPS Verlet steps on the first
    bench-small molecule, the predict captured once, before the timed run)
    with the numpy and the native builder; ms per step, split into the
    graph build, pad_batch, the plans and packing, and the rest (the copy
    to the card, the replay, the fetch of E and F, the integrator)."""
    from unittest import mock

    from gemnet_pytorch_tpu_torch.data import Molecule, containers
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    Z, R = mols[0]
    model = make_model(cfg, device)
    out = {}
    for backend in ("numpy", "native"):
        spent = collections.Counter()

        def timed(part, fn):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[part] += time.perf_counter() - t0
            return run

        mol = Molecule(R, Z, cfg.cutoff, cfg.int_cutoff, triplets_only=cfg.triplets_only)
        sim = MDSimulator(mol, model, max_steps=MD_STEPS, device=device, **MD_SETTINGS)
        sim.calc.calculate()  # the capture, outside the timed run
        capture_s = sim.calc.captured._captured[1].seconds
        with mock.patch.object(containers, "build_graph",
                               timed("graph build", BUILDERS[backend])), \
                mock.patch.object(containers, "pad_batch", timed("pad_batch",
                                                                 containers.pad_batch)), \
                mock.patch.object(BatchPacker, "pack", timed("plans and pack",
                                                             BatchPacker.pack)):
            t0 = time.perf_counter()
            traj = sim.run()
            sec = time.perf_counter() - t0
        check(len(traj) == MD_STEPS and np.isfinite(traj.frames_E).all(),
              f"MD ({backend} builder): non-finite trajectory")
        check(sim.calc.captured.captures == 1, f"MD ({backend}): captured more than once")
        parts = {k: v / MD_STEPS * 1e3 for k, v in spent.items()}
        parts["rest"] = sec / MD_STEPS * 1e3 - sum(parts.values())
        out[backend] = dict(ms_per_step=sec / MD_STEPS * 1e3, capture_s=capture_s, **parts)
        log(f"  MD, {backend} builder: {out[backend]['ms_per_step']:.2f} ms a step over "
            f"{MD_STEPS} steps (the capture before them, {capture_s:.2f} s): graph build "
            f"{parts['graph build']:.2f}, pad_batch {parts['pad_batch']:.2f}, plans and pack "
            f"{parts['plans and pack']:.2f}, copy + replay + fetch + integrator "
            f"{parts['rest']:.2f} ms")
    return out


def write_pretrained(directory: str, cfg, seed: int = 0):
    """A pretrained directory of `cfg`: model_kwargs.json, a
    scaling_factors.json with factors from default_rng(seed) in [0.5, 2),
    and model.pth (the reference state dict of weights from `seed`, the
    factors in it). Returns the weights' path."""
    import dataclasses

    from gemnet_pytorch_tpu_torch.compat import save_reference_checkpoint
    from gemnet_pytorch_tpu_torch.models.scaling import (
        load_scales_from_json, scale_names_in_creation_order,
    )
    from gemnet_pytorch_tpu_torch.utils.jsonio import write_json

    os.makedirs(directory, exist_ok=True)
    write_json(os.path.join(directory, "model_kwargs.json"), dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed)
    scale_file = os.path.join(directory, "scaling_factors.json")
    write_json(scale_file, {name: float(rng.uniform(0.5, 2.0))
                            for name in scale_names_in_creation_order(cfg)})
    model = make_model(cfg, "cpu", seed)
    load_scales_from_json(model, scale_file)
    weights = os.path.join(directory, "model.pth")
    save_reference_checkpoint(weights, model, cfg)
    return weights


def pretrained(cfg, device, workdir: str) -> dict:
    """Phase 13 (d): `load_pretrained` of a written directory on the card
    (GemNet-Q at the config.yaml widths; and in matmul_precision="high"),
    the example molecule predicted by the calculator (captured) against the
    same load on the CPU (rtol SERVE_RTOL), its capture's launches those of
    a predict (SERVE_LAUNCHES); then `examples.predict` and
    `examples.md_simulation` on the card."""
    import dataclasses

    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.examples import md_simulation
    from gemnet_pytorch_tpu_torch.examples import predict as example
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.pretrained import load_pretrained

    out = {}
    for mode in ("default", "high"):
        mcfg = dataclasses.replace(cfg, matmul_precision=mode)
        directory = os.path.join(workdir, f"GemNet-Q-{mode}")
        weights = write_pretrained(directory, mcfg)
        results = {}
        for dev in (device, "cpu"):
            model = load_pretrained(directory, weights_path=weights, device=dev)
            calc = GemNetCalculator(Molecule(example.R, example.Z, mcfg.cutoff,
                                             mcfg.int_cutoff), model, device=dev)
            results[str(dev)] = calc.calculate()
            if dev != "cpu":
                launches = collections.Counter()
                for (name, _), n in calc.captured._captured[1].launches.items():
                    launches[name] += n
        (E, F), (E_cpu, F_cpu) = results[str(device)], results["cpu"]
        errs = [close(np.array([E]), np.array([E_cpu]), SERVE_RTOL), close(F, F_cpu, SERVE_RTOL)]
        log(f"  load_pretrained ({mode}) on the card: E {E:.6f} eV (CPU {E_cpu:.6f}), |dE| "
            f"{errs[0][1]:.3e}, |dF| {errs[1][1]:.3e} (rtol {SERVE_RTOL}); the predict's "
            f"capture launched {dict(launches)}")
        check(all(ok for ok, _ in errs), f"the loaded model ({mode}) on the card disagrees with "
              "the CPU")
        check(dict(launches) == SERVE_LAUNCHES[mode],
              f"the loaded model's predict ({mode}) launched {dict(launches)}, expected "
              f"{SERVE_LAUNCHES[mode]}")
        out[mode] = dict(E=E, dE=errs[0][1], dF=errs[1][1])
    energy, forces = example.main([os.path.join(workdir, "GemNet-Q-default")])
    check(np.isfinite(energy) and np.isfinite(forces).all(), "examples.predict: non-finite")
    traj = md_simulation.main(["--traj", os.path.join(workdir, "md.npz"), "--steps", "20"])
    check(len(traj) == 2 and np.isfinite(traj.frames_E).all(), "examples.md_simulation failed")
    log(f"  examples.predict and examples.md_simulation (20 Langevin steps) ran on the card")
    return out


def remat(cfg, mols, device) -> dict:
    """Phase 13 (e): with deterministic algorithms, CAPTURED_STEPS captured
    fp32 steps with remat_blocks against as many without, from one state
    (loss rtol REMAT_RTOL, update relative L2 REMAT_UPDATE_REL_L2: the remat
    test's E/F and gradient tolerances); the remat step's launches, eager
    and captured (REMAT_LAUNCHES); then ms, device ms and peak MiB (graph
    pool included) of the captured bf16 step with and without remat at both
    bench batches (`time_captured`)."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda

    batch_np, _, _ = bench.padded_batch(cfg, mols)
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for on in (False, True):
            trainer, state = make_trainer(dataclasses.replace(cfg, remat_blocks=on),
                                          "float32", device)
            start, p0 = state_copy(state), state.params.clone()
            if on:
                before = collections.Counter(_cuda.kernel_launches())
                trainer.train_step(state, to_torch(batch_np, device), 1.0)
                torch.cuda.synchronize()
                eager = collections.Counter(_cuda.kernel_launches())
                eager.subtract(before)
                eager = dict(+eager)
            words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
            step_fn = trainer.train_step_fn()
            runs[on] = five_steps(trainer, state, start, p0,
                                  lambda: step_fn(state, words, 1.0)[1])
            if on:
                captured = collections.Counter()
                for (name, _), n in trainer._captured[1].launches.items():
                    captured[name] += n
            del trainer, state, step_fn, words
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    diffs, equal = run_diffs(runs[True], runs[False], p0)
    log(f"  remat_blocks, fp32, deterministic algorithms: {CAPTURED_STEPS} captured steps "
        f"against the unremat'd ones: bit-equal {equal}, max loss rel {diffs[0]:.3e}, update "
        f"rel L2 {diffs[1]:.3e}; launches of a remat step: eager {eager}, captured "
        f"{dict(captured)}")
    check(diffs[0] <= REMAT_RTOL and diffs[1] <= REMAT_UPDATE_REL_L2,
          "the captured remat step disagrees with the unremat'd one")
    check(eager == REMAT_LAUNCHES and dict(captured) == REMAT_LAUNCHES,
          f"a remat step launched {eager} (captured {dict(captured)}), expected {REMAT_LAUNCHES}")
    out = dict(bit_equal=equal, loss_rel=diffs[0], update_rel=diffs[1])
    for kind in bench.KINDS:
        for on in (False, True):
            mcfg = dataclasses.replace(cfg, remat_blocks=on)
            trainer, state, fn, capture_s, n_real, base = captured_trainer(
                mcfg, kind, device, "bfloat16")
            tag = "remat" if on else "plain"
            out[f"{kind}_{tag}"] = time_captured(
                fn, trainer._captured[1].graph,
                f"bf16 captured step{' with remat' if on else ''}, bench-{kind}", base)
            del trainer, state, fn
            torch.cuda.empty_cache()
    return out


def xla(cfg, mols, device) -> None:
    """Phase 13 (f): bilinear_implementation="xla" (the plain versions) on
    the card: the bench-small predict raises, with no kernel launched."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda

    batch = to_torch(bench.padded_batch(cfg, mols)[0], device)
    model = make_model(dataclasses.replace(cfg, bilinear_implementation="xla"), device)
    torch.cuda.synchronize()
    before = collections.Counter(_cuda.kernel_launches())
    try:
        predict(model, batch)
        message = None
    except ValueError as err:
        message = str(err)
    torch.cuda.synchronize()
    count = collections.Counter(_cuda.kernel_launches())
    count.subtract(before)
    log(f"  bilinear_implementation='xla' on the card, bench-small predict: {message!r}; "
        f"launches {dict(+count)}")
    check(message is not None and "'xla'" in message,
          "bilinear_implementation='xla' ran on the card: no plain version may run there")
    check(not +count, f"'xla' on the card launched {dict(+count)} before it raised")


def stack_phase(cfg, mols, device, workdir: str, step_ms=None, fwd_ms=None) -> dict:
    """Phase 13. `step_ms`: the captured fp32 small step's ms (phase 11);
    `fwd_ms`: the bench's fwd_ms_median (phase 10), where known. Returns the
    timings."""
    timing = dict(builders=builders(cfg), provider=provider_rates(cfg, workdir, step_ms),
                  md=md_parts(cfg, mols, device), pretrained=pretrained(cfg, device, workdir),
                  remat=remat(cfg, mols, device))
    xla(cfg, mols, device)
    if fwd_ms is not None:
        log(f"  the bench's fwd_ms_median (phase 10), now the captured predict: {fwd_ms:.3f} ms")
    return timing


# ---------------------------------------------------------------- parallel

def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def allclose(a, b, rtol: float, atol: float) -> tuple[bool, float]:
    """numpy's allclose, and the largest |a - b| over its bound atol + rtol·|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    excess = np.abs(a - b) / (atol + rtol * np.abs(b))
    return bool(np.all(excess <= 1.0)), float(excess.max())


def collectives_of(fn) -> dict:
    """The collectives `fn()` issued, by (kind, backend)."""
    from gemnet_pytorch_tpu_torch.parallel.collectives import CALLS

    before = collections.Counter(CALLS)
    fn()
    after = collections.Counter(CALLS)
    after.subtract(before)
    return dict(+after)


def padded_parts(cfg, mols, n_parts: int = PARALLEL_RANKS):
    """`mols` in `n_parts` equal parts padded to one PadDims (the largest
    part's sizes and 5% headroom, as bench.padded_batch pads): a dp shard
    or a pp microbatch each."""
    from gemnet_pytorch_tpu_torch.data import pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import toy_energy_forces

    size = len(mols) // n_parts
    parts = [mols[i * size:(i + 1) * size] for i in range(n_parts)]
    raws, dims = [], None
    for part in parts:
        _, g, d = bench.padded_batch(cfg, part)
        raws.append((part, g))
        dims = d if dims is None else dims.grow_to(scale_graph_dims(g, 1.05), len(part),
                                                   d.n_atoms)
    out = []
    for part, g in raws:
        Z = np.concatenate([z for z, _ in part])
        R = np.concatenate([r for _, r in part])
        EF = [toy_energy_forces(z, r) for z, r in part]
        out.append(pad_batch(g, Z, R, dims, E=np.array([e for e, _ in EF], np.float32),
                             F=np.concatenate([f for _, f in EF]),
                             triplets_only=cfg.triplets_only))
    return out


def halo_batches(cfg, mols, n_shards: int):
    """(the single-device padded batch of `mols`, its halo partition over
    `n_shards` at the same molecule and atom padding)."""
    from gemnet_pytorch_tpu_torch.data.synthetic import toy_energy_forces
    from gemnet_pytorch_tpu_torch.parallel import build_halo_partition

    batch_np, g, dims = bench.padded_batch(cfg, mols)
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    EF = [toy_energy_forces(z, r) for z, r in mols]
    part = build_halo_partition(g, Z, R, n_shards, E=np.array([e for e, _ in EF], np.float32),
                                F=np.concatenate([f for _, f in EF]),
                                triplets_only=cfg.triplets_only, n_mol_pad=dims.n_mol,
                                n_atoms_pad=dims.n_atoms)
    return batch_np, part


def halo_step_gates(label: str, got, ref, p0) -> None:
    """One halo train step against the single-device one: tests/test_halo.py
    :241-282's gates (loss rtol 1e-4 atol 1e-6; parameters and EMA rtol 1e-3
    atol 2e-5; accumulators rtol 1e-4 atol 1e-6) and the update's relative
    L2 error within TRAIN_UPDATE_REL_L2."""
    (loss, params, ema, acc), (rloss, rparams, rema, racc) = got, ref
    ok_l, ex_l = allclose(loss, rloss, 1e-4, 1e-6)
    ok_p, ex_p = allclose(params, rparams, 1e-3, 2e-5)
    ok_e, ex_e = allclose(ema, rema, 1e-3, 2e-5)
    ok_a, ex_a = allclose(acc, racc, 1e-4, 1e-6)
    rel = rel_l2(params - p0, rparams - p0)
    log(f"  {label}: loss {loss:.6f} vs {rloss:.6f}; largest share of the test_halo bound: loss "
        f"{ex_l:.3f}, params {ex_p:.3f}, EMA {ex_e:.3f}, accumulators {ex_a:.3f}; update rel L2 "
        f"{rel:.3e} (limit {TRAIN_UPDATE_REL_L2})")
    check(ok_l and ok_p and ok_e and ok_a and rel <= TRAIN_UPDATE_REL_L2,
          f"{label}: the halo step disagrees with the single-device step")


def ef_gates(label: str, E, F, E_ref, F_ref) -> None:
    """E and F against the single-device predict at tests/test_halo.py's
    gates (E rtol 1e-5 atol 1e-5, F rtol 1e-4 atol 1e-5)."""
    ok_e, ex_e = allclose(E, E_ref, 1e-5, 1e-5)
    ok_f, ex_f = allclose(F, F_ref, 1e-4, 1e-5)
    log(f"  {label}: E max |diff| {np.abs(E - E_ref).max():.3e} (share of the bound {ex_e:.3f}), "
        f"F {np.abs(F - F_ref).max():.3e} ({ex_f:.3f}); max |E| {np.abs(E_ref).max():.3e}, "
        f"|F| {np.abs(F_ref).max():.3e}")
    check(ok_e and ok_f, f"{label}: E/F disagree with the single-device predict")


def host(t):
    """A numpy copy of a tensor."""
    return t.detach().cpu().clone().numpy()


def step_outputs(state, metrics):
    """(loss, parameters, EMA, accumulators) after a step, on the host."""
    return (float(metrics["loss"]), host(state.params), host(state.ema_params),
            host(state.metric_acc))


def dp_nccl(cfg, mols, device, group) -> dict:
    """Phase 14 (a): the captured dp step under NCCL at world size 1 against
    the captured single-device step, fp32 and bf16, from one state
    (bit-equality printed; the gates of phase 11), its all-reduces issued at
    the capture and none at a replay (they replay inside the graph); the
    captured dp eval of the EMA weights against the single-device one
    (EVAL_RTOL); ms per step both ways."""
    import torch

    from gemnet_pytorch_tpu_torch import graphs
    from gemnet_pytorch_tpu_torch.parallel import dp

    batch_np, _, _ = bench.padded_batch(cfg, mols)
    timing = {}
    for dt in ("float32", "bfloat16"):
        runs, fns = {}, {}
        for kind in ("single", "dp"):
            trainer, state = make_trainer(cfg, dt, device)
            start, p0 = state_copy(state), state.params.clone()
            words = trainer.packer.to_device(trainer.packer.pack(batch_np), device)
            step_fn = (trainer.train_step_fn() if kind == "single"
                       else dp.make_dp_train_step(trainer, group))
            if kind == "dp":
                eager = collectives_of(lambda: trainer.train_step(
                    state, trainer._device_batch(batch_np), 1.0, group))
                capture = collectives_of(lambda: step_fn(state, words, 1.0))
                replay = collectives_of(lambda: step_fn(state, words, 1.0))
            runs[kind] = five_steps(trainer, state, start, p0,
                                    lambda: step_fn(state, words, 1.0)[1])
            fns[kind] = (trainer, state, step_fn, words)
        diffs, equal = run_diffs(runs["dp"], runs["single"], p0)
        trainer, state, step_fn, words = fns["dp"]
        log(f"  (a) {dt}: {CAPTURED_STEPS} captured dp steps (NCCL, world size 1) vs as many "
            f"captured single-device steps: bit-equal {equal}; max loss rel {diffs[0]:.3e}, "
            f"update rel L2 {diffs[1]:.3e}, accumulators rel {diffs[2]:.3e}; collectives of an "
            f"eager dp step {eager}, of the first call ({graphs.WARMUP_CALLS} warm-up steps and "
            f"the capture) {capture}, of a replay {replay} (at one rank NCCL sums in place "
            "without a kernel)"
            + ("" if equal else " (not bit-equal: the autograd engine orders the double "
               "backward's gradient sums by sequence numbers its two threads count apart, "
               "phase 11; the dp step adds the all-reduces of the loss's denominators)"))
        tol = (CAPTURED_LOSS_RTOL, CAPTURED_UPDATE_REL_L2) if dt == "float32" else (0.06, 0.06)
        check(diffs[0] <= tol[0] and diffs[1] <= tol[1] and diffs[2] <= tol[0],
              f"(a) {dt}: the captured dp step disagrees with the single-device step")
        n_step = sum(eager.values())
        check(n_step > 0 and set(eager) == {("all_reduce", "nccl")} and not replay
              and sum(capture.values()) == (graphs.WARMUP_CALLS + 1) * n_step,
              f"(a) {dt}: the dp step's all-reduces were not captured into its graph")
        if dt == "float32":
            strainer, sstate = fns["single"][:2]
            sstate.ema_params.mul_(1.01)
            state.ema_params.copy_(sstate.ema_params)
            state.params.copy_(sstate.params)
            ref, _ = strainer.eval_step_fn()(sstate, fns["single"][3], use_ema=True)
            got, _ = dp.make_dp_eval_step(trainer, group)(state, words, use_ema=True)
            rel = max(abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in ref)
            log(f"  (a) captured dp eval of the EMA weights vs single-device: max rel {rel:.3e}")
            check(rel <= EVAL_RTOL, "(a) the captured dp eval disagrees with the single-device")
        for kind in ("single", "dp"):
            tr, st, fn, wd = fns[kind]
            timing[f"{kind}_{dt}"] = time_captured(
                lambda: fn(st, wd, 1.0)[1]["loss"], tr._captured[1].graph,
                f"(a) {dt} captured {kind} step, bench-small, deterministic algorithms", 0)
        del fns, trainer, state, step_fn, words
        torch.cuda.empty_cache()
    return timing


def halo_nccl(cfg, mols, device, group) -> None:
    """Phase 14 (e): the halo step at one shard under NCCL, captured (the
    all-to-alls and psums inside the graph), against its eager run from one
    state (bit-equal where two eager runs are, else phase 11's gates) and
    against the captured single-device step (test_halo.py's gates), fp32,
    tests/test_halo.py's optimizer settings."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import halo

    batch_np, part = halo_batches(cfg, mols, 1)
    # train.py's agreement on the pads before each step, on the card's group
    check(halo.agree_halo_pads(part["halo_pads"], group) == part["halo_pads"],
          "(e) the pads agreed over the NCCL group are not the rank's own")
    local = halo.local_halo_batch(part, 0)
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    start, p0 = state_copy(state), state.params.clone()
    hm = halo.halo_model(trainer.model, group)
    tensors = to_torch(local, device)
    eager = lambda: trainer.train_step(state, tensors, 1.0, model=hm)[1]  # noqa: E731
    captured_fn = halo.make_halo_train_step(trainer, group)
    words = trainer.packer.to_device(trainer.packer.pack(local), device)
    captured = lambda: captured_fn(state, words, 1.0)[1]  # noqa: E731
    a, b, c = (five_steps(trainer, state, start, p0, fn) for fn in (eager, eager, captured))
    (ab, ab_equal), (ca, ca_equal) = run_diffs(b, a, p0), run_diffs(c, a, p0)
    log(f"  (e) halo at 1 shard, NCCL: {CAPTURED_STEPS} captured steps vs eager: bit-equal "
        f"{ca_equal} (two eager runs bit-equal {ab_equal}); max loss rel {ca[0]:.3e}, update "
        f"rel L2 {ca[1]:.3e}; captured in {trainer._captured[1].seconds:.2f} s")
    if ab_equal:
        check(ca_equal, "(e) two eager halo runs are bit-equal and the captured one is not")
    check(ca[0] <= CAPTURED_LOSS_RTOL and ca[1] <= CAPTURED_UPDATE_REL_L2,
          "(e) the captured halo step disagrees with its eager run")
    # one step of each from the start, against the single-device captured step
    state_restore(state, start)
    metrics = captured()
    got = step_outputs(state, metrics)
    strainer, sstate = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    smetrics = strainer.train_step_fn()(sstate, batch_np, 1.0)[1]
    ref = step_outputs(sstate, smetrics)
    halo_step_gates("(e) captured halo step (1 shard) vs the captured single-device step",
                    got, ref, host(p0))
    del trainer, state, strainer, sstate, captured_fn, words, tensors
    torch.cuda.empty_cache()


def driver_run(device, workdir: str, group, **mode) -> dict:
    """Phase 14 (f): `train.run` in a parallel mode (dp=N or halo=N over
    `group`) for PARALLEL_RUN's steps: the best metrics, finite, and rank
    0's checkpoint at the last step."""
    from gemnet_pytorch_tpu_torch import train as train_driver
    from gemnet_pytorch_tpu_torch.parallel import mesh

    run_dir = os.path.join(workdir, "run_" + "_".join(mode))
    config = dict(PARALLEL_RUN, restart=run_dir, logdir=workdir)
    best = train_driver.run(config, device=device, synthetic_molecules=PARALLEL_RUN_MOLECULES,
                            group=group, **mode)
    check(all(np.isfinite(v) for v in best.values()), f"train.run({mode}): non-finite metrics")
    if mesh.is_main(group):
        import torch

        ckpt = torch.load(os.path.join(run_dir, "logs", "checkpoint"), map_location="cpu",
                          weights_only=True)
        check(int(ckpt["step"]) == PARALLEL_RUN["num_steps"],
              f"train.run({mode}): rank 0's checkpoint at step {int(ckpt['step'])}")
    return best


def parallel_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 14 (b)-(d) on one rank of a gloo group whose ranks share
    cuda:0 (a spawned process), on the model and molecules of
    workdir/spec.pt: the results go to workdir/rank<r>.pt for the parent to
    hold against the single-device card."""
    import datetime

    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import dp, halo, mesh

    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    device = torch.device(spec["device"])
    # gloo on the card, named: NCCL cannot put two ranks on one GPU
    group = mesh.initialize_distributed(
        f"file://{workdir}/store", world, rank, "gloo", device=device,
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    cfg = ModelConfig(**spec["cfg"])
    mols = spec["mols"]
    out = {}
    _cuda.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    # (b) dp: a half each
    half = padded_parts(cfg, mols)[rank]
    trainer, state = make_trainer(cfg, "float32", device)
    p0 = state.params.clone()
    state, metrics, _ = dp.make_dp_train_step(trainer, group)(state, half, 1.0)
    out["dp_step"] = (float(metrics["loss"]), host(state.params - p0))
    E, F = dp.make_dp_predict_fn(make_model(cfg, device), group)(to_torch(half, device))
    out["dp_predict"] = (host(E), host(F))
    del trainer, state
    # (c) halo, bench-small: predict, one step and its launches
    _, part = halo_batches(cfg, mols, world)
    E, F = halo.make_halo_apply(make_model(cfg, device), group)(
        halo.shard_halo_batch(part, group, device))
    out["halo_small"] = (host(E), host(F))
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    local = halo.local_halo_batch(part, rank)
    torch.cuda.synchronize()
    before = collections.Counter(_cuda.kernel_launches())
    state, metrics = halo.make_halo_train_step(trainer, group)(state, local, 1.0)
    torch.cuda.synchronize()
    census = collections.Counter(_cuda.kernel_launches())
    census.subtract(before)
    out["halo_census"] = dict(+census)
    out["halo_step"] = step_outputs(state, metrics)
    out["shapes"] = {k: tuple(v.shape) for k, v in local.items()
                     if k in ("id_c", "id3_reduce_ca", "id4_reduce_ca", "edge_halo_send_idx",
                              "intm_halo_send_idx")}
    del trainer, state
    torch.use_deterministic_algorithms(False)
    # (d) halo, bench-large: predict; per dtype peak MiB and ms of a step
    _, part = halo_batches(cfg, spec["large_mols"], world)
    E, F = halo.make_halo_apply(make_model(cfg, device), group)(
        halo.shard_halo_batch(part, group, device))
    out["halo_large"] = (host(E), host(F))
    local = halo.local_halo_batch(part, rank)
    for dt in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        trainer, state = make_trainer(cfg, dt, device)
        step = halo.make_halo_train_step(trainer, group)
        batch = to_torch(local, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batch, 1.0)  # warm-up
        dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LARGE_HALO_STEPS):
            state, metrics = step(state, batch, 1.0)
        torch.cuda.synchronize()
        out[f"large_{dt}"] = dict(
            ms=(time.perf_counter() - t0) / LARGE_HALO_STEPS * 1e3,
            peak_mib=torch.cuda.max_memory_allocated() / 2**20, loss=float(metrics["loss"]))
        del trainer, state, step, batch
    torch.cuda.empty_cache()
    # (f) the training entry point, halo over the group
    t0 = time.perf_counter()
    out["halo_run"] = (driver_run(device, workdir, group, halo=world),
                       time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["launches"] = collections.Counter(_cuda.LAUNCHES)  # (b)-(d), (f)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def spawn_ranks(workdir: str, spec: dict, target=None, world: int = PARALLEL_RANKS) -> list:
    """Phase 14's gloo group (phase 15's too): `world` spawned processes on
    cuda:0 running `target` (default `parallel_rank`) on `spec`; a rank
    that fails stops the others; every wait is bounded by
    PARALLEL_TIMEOUT_S."""
    import multiprocessing

    import torch

    os.makedirs(workdir, exist_ok=True)
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target or parallel_rank, args=(r, world, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(30)
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"the gloo ranks of {workdir} exited {codes}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def single_device_references(cfg, mols, large_mols, device) -> dict:
    """Phase 14's single-device card runs for (b)-(d): the captured step on
    all of bench-small and the predict of each half (b); the predict of
    bench-small and one step at test_halo.py's settings (c); the predict of
    bench-large and the peak MiB and ms of an eager step per dtype (d)."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch

    ref = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        batch_np, _, _ = bench.padded_batch(cfg, mols)
        trainer, state = make_trainer(cfg, "float32", device)
        p0 = state.params.clone()
        metrics = trainer.train_step_fn()(state, batch_np, 1.0)[1]
        ref["dp_step"] = (float(metrics["loss"]), host(state.params - p0))
        model = make_model(cfg, device)
        ref["dp_predict"] = [tuple(host(t) for t in predict(model, to_torch(h, device)))
                             for h in padded_parts(cfg, mols)]
        ref["halo_small"] = tuple(host(t) for t in predict(model, to_torch(batch_np,
                                                                                   device)))
        trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
        ref["p0"] = host(state.params)
        metrics = trainer.train_step_fn()(state, batch_np, 1.0)[1]
        ref["halo_step"] = step_outputs(state, metrics)
        del trainer, state
    finally:
        torch.use_deterministic_algorithms(False)
    large_np, _, _ = bench.padded_batch(cfg, large_mols)
    large = to_torch(large_np, device)
    ref["halo_large"] = tuple(host(t) for t in predict(model, large))
    del model
    for dt in ("float32", "bfloat16"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        trainer, state = make_trainer(cfg, dt, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train_step(state, large, 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LARGE_HALO_STEPS):
            trainer.train_step(state, large, 1.0)
        torch.cuda.synchronize()
        ref[f"large_{dt}"] = dict(ms=(time.perf_counter() - t0) / LARGE_HALO_STEPS * 1e3,
                                  peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
        del trainer, state
    torch.cuda.empty_cache()
    return ref


def gloo_ranks(cfg, mols, large_mols, device, workdir: str, power: str):
    """Phase 14 (b)-(d): the spawned gloo ranks against the single-device
    card, bench-small `mols`, bench-large `large_mols`. Returns (the ranks'
    launches, by kernel and shape, summed; the bench-large numbers)."""
    import dataclasses

    ref = single_device_references(cfg, mols, large_mols, device)
    t0 = time.perf_counter()
    results = spawn_ranks(workdir, dict(device=str(device), cfg=dataclasses.asdict(cfg),
                                        mols=mols, large_mols=large_mols))
    log(f"  {PARALLEL_RANKS} gloo ranks on cuda:0 ran (b)-(d) in {time.perf_counter() - t0:.1f} s "
        f"(spawn and CUDA start included)")
    # (b)
    losses = [r["dp_step"][0] for r in results]
    rel = rel_l2(results[0]["dp_step"][1], ref["dp_step"][1])
    log(f"  (b) dp, 2 halves of 16 molecules, one fp32 step: loss {losses} vs single-device on "
        f"all 32 {ref['dp_step'][0]:.6f}; update rel L2 {rel:.3e} (limit {TRAIN_UPDATE_REL_L2})")
    check(all(abs(x - ref["dp_step"][0]) <= 1e-5 * abs(ref["dp_step"][0]) for x in losses)
          and rel <= TRAIN_UPDATE_REL_L2,
          "(b) the dp step over 2 gloo ranks disagrees with the single-device step")
    check(np.array_equal(results[0]["dp_step"][1], results[1]["dp_step"][1]),
          "(b) the ranks' dp updates differ")
    for r, res in enumerate(results):
        for name, got, want in zip("EF", res["dp_predict"], ref["dp_predict"][r]):
            ok, err = close(got, want, SERVE_RTOL)
            log(f"  (b) dp predict, rank {r}'s half, {name}: max |diff| {err:.3e}")
            check(ok, f"(b) rank {r}'s dp predict {name} disagrees with the single-device one")
    # (c)
    for r, res in enumerate(results):
        ef_gates(f"(c) halo predict, bench-small, rank {r}", *res["halo_small"], *ref["halo_small"])
        halo_step_gates(f"(c) halo fp32 step, bench-small, rank {r}", res["halo_step"],
                        ref["halo_step"], ref["p0"])
        log(f"  (c) rank {r}'s shard: {res['shapes']}; one step launched {res['halo_census']}")
        check(res["halo_census"] == HALO_LAUNCHES,
              f"(c) rank {r}'s halo step launched {res['halo_census']}, expected {HALO_LAUNCHES}")
    # (d): SERVE_RTOL of the largest |E|, |F|, as every card-vs-card predict
    # here (tests/test_halo.py's elementwise gates are sized for its 4 small
    # molecules; at bench-large |F| reaches ~70 and a near-zero component
    # carries the summation-order error of its sums)
    for r, res in enumerate(results):
        for name, got, want in zip("EF", res["halo_large"], ref["halo_large"]):
            ok, err = close(got, want, SERVE_RTOL)
            log(f"  (d) halo predict, bench-large, rank {r}, {name}: max |diff| {err:.3e}, max "
                f"|{name}| {np.abs(want).max():.3e} (rtol {SERVE_RTOL} of it)")
            check(ok, f"(d) rank {r}'s halo {name} at bench-large disagrees with the "
                  "single-device predict")
    large = {}
    for dt in ("float32", "bfloat16"):
        ranks = [res[f"large_{dt}"] for res in results]
        large[dt] = dict(single=ref[f"large_{dt}"], ranks=ranks)
        peaks = ", ".join(f"{x['peak_mib']:.1f}" for x in ranks)
        ms = ", ".join(f"{x['ms']:.1f}" for x in ranks)
        one = ref[f"large_{dt}"]
        log(f"  (d) bench-large {dt} eager train step [{power}]: peak MiB per rank {peaks} vs "
            f"single-device {one['peak_mib']:.1f}; ms per step {ms} (gloo through the host, "
            f"2 ranks sharing one card: not a scaling number) vs single-device eager "
            f"{one['ms']:.1f}")
    best = [res["halo_run"][0] for res in results]
    log(f"  (f) train.run(halo={PARALLEL_RANKS}) over the gloo ranks, "
        f"{PARALLEL_RUN['num_steps']} steps on {PARALLEL_RUN_MOLECULES} synthetic molecules in "
        f"{max(res['halo_run'][1] for res in results):.1f} s: best {best[0]}")
    check(all(b == best[0] for b in best), "(f) the ranks' train.run(halo) disagree")
    launches = collections.Counter()
    for res in results:
        launches.update(res["launches"])
    return launches, large


def parallel_phase(cfg, mols, device, workdir: str, power: str, large_mols=None) -> dict:
    """Phase 14: (a) and (e) in this process on an NCCL group of one, with
    deterministic algorithms, and (f)'s dp run; (b)-(d) and (f)'s halo run
    on a spawned gloo group of 2 ranks sharing cuda:0. Returns the timings
    and the gloo ranks' launches."""
    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.parallel import mesh

    group = mesh.initialize_distributed(f"localhost:{free_port()}", 1, 0, device=device)
    check(mesh.backend(group) == "nccl", f"phase 14's group is {mesh.backend(group)}, not NCCL")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        timing = dict(dp=dp_nccl(cfg, mols, device, group))
        halo_nccl(cfg, mols, device, group)
    finally:
        torch.use_deterministic_algorithms(False)
    try:
        t0 = time.perf_counter()
        best = driver_run(device, workdir, group, dp=1)
        log(f"  (f) train.run(dp=1) on the NCCL group (captured steps and eval), "
            f"{PARALLEL_RUN['num_steps']} steps on {PARALLEL_RUN_MOLECULES} synthetic molecules "
            f"in {time.perf_counter() - t0:.1f} s: best {best}")
    finally:
        dist.destroy_process_group()
    launches, timing["large"] = gloo_ranks(cfg, mols, large_mols or bench.molecules("large"),
                                           device, workdir, power)
    return timing, launches


# ---------------------------------------------------------------- phase 15

def ef_parts(E, F, batch):
    """tests/test_edge_partition.py's and tests/test_hybrid.py's loss as
    (numerator, denominator): |E - E_t| over the molecules plus |F - F_t|
    over the atoms, each masked."""
    import torch

    m = batch["mol_mask"].float()[:, None]
    am = batch["atom_mask"].float()[:, None]
    num = torch.sum(torch.abs(E - batch["E"]) * m) + torch.sum(
        torch.abs(F[:, 0, :] - batch["F"]) * am)
    return num, torch.sum(m) + torch.sum(am)


def ef_loss(E, F, batch):
    return ef_parts(E, F, batch)[0]


def graph_tuple(cfg, mols):
    """(g, Z, R, E, F) of `mols`, the toy targets included, as the halo
    partitioner takes them."""
    from gemnet_pytorch_tpu_torch.data.synthetic import toy_energy_forces

    _, g, _ = bench.padded_batch(cfg, mols)
    EF = [toy_energy_forces(z, r) for z, r in mols]
    return (g, np.concatenate([z for z, _ in mols]), np.concatenate([r for _, r in mols]),
            np.array([e for e, _ in EF], np.float32), np.concatenate([f for _, f in EF]))


def half_molecules(mols):
    half = len(mols) // HYBRID_MESH[0]
    return [mols[i * half:(i + 1) * half] for i in range(HYBRID_MESH[0])]


def collectives_and_bytes(fn) -> tuple:
    """(result of fn(), the collectives it issued, their bytes), by (kind,
    backend)."""
    from gemnet_pytorch_tpu_torch.parallel.collectives import BYTES, CALLS

    calls, nbytes = collections.Counter(CALLS), collections.Counter(BYTES)
    out = fn()
    c, b = collections.Counter(CALLS), collections.Counter(BYTES)
    c.subtract(calls)
    b.subtract(nbytes)
    return out, dict(+c), dict(+b)


def flat_grad(model, loss):
    import torch

    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    return torch.cat([g.reshape(-1) for g in grads])


def grad_gates(label: str, got, ref, model) -> None:
    """Each parameter's gradient within 1e-4 + 1e-3 max|g| of the reference
    (tests/test_edge_partition.py:101-168, tests/test_hybrid.py:27-90); `got`
    and `ref` are flat, in `model.parameters()` order."""
    worst, off = 0.0, 0
    for p in model.parameters():
        a, b = got[off:off + p.numel()], ref[off:off + p.numel()]
        off += p.numel()
        worst = max(worst, float(np.abs(a - b).max() / (1e-4 + 1e-3 * np.abs(b).max())))
    log(f"  {label}: largest share of the 1e-4 + 1e-3 max|g| bound {worst:.3f}, rel L2 "
        f"{rel_l2(got, ref):.3e}")
    check(worst <= 1.0, f"{label}: the gradients disagree with the single device")


def one_shard_step(label: str, trainer, state, local, eager, captured_fn, batch_np, device):
    """Phase 15 (a): CAPTURED_STEPS captured steps of a partitioned model at
    one shard under NCCL against its eager steps from one state (bit-equal
    where two eager runs are, else phase 11's gates) and one against the
    captured single-device step (phase 14's 1-shard gates). Returns the
    collectives and bytes of one eager step."""
    import torch

    start, p0 = state_copy(state), state.params.clone()
    words = trainer.packer.to_device(trainer.packer.pack(local), device)
    captured = lambda: captured_fn(state, words, 1.0)[1]  # noqa: E731
    a, b, c = (five_steps(trainer, state, start, p0, fn) for fn in (eager, eager, captured))
    (ab, ab_equal), (ca, ca_equal) = run_diffs(b, a, p0), run_diffs(c, a, p0)
    check(trainer._captured is not None, f"(a) the {label} step was not captured")
    log(f"  (a) {label} at 1 shard, NCCL: {CAPTURED_STEPS} captured steps vs eager: bit-equal "
        f"{ca_equal} (two eager runs bit-equal {ab_equal}); max loss rel {ca[0]:.3e}, update "
        f"rel L2 {ca[1]:.3e} (the second eager run vs the first: {ab[0]:.3e}, {ab[1]:.3e}; the "
        f"captured vs the second: bit-equal {run_diffs(c, b, p0)[1]})"
        + (f"; captured in {trainer._captured[1].seconds:.2f} s" if trainer._captured else ""))
    if ab_equal:
        check(ca_equal, f"(a) two eager {label} runs are bit-equal and the captured one is not")
    check(ca[0] <= CAPTURED_LOSS_RTOL and ca[1] <= CAPTURED_UPDATE_REL_L2,
          f"(a) the captured {label} step disagrees with its eager run")
    state_restore(state, start)
    _, calls, nbytes = collectives_and_bytes(eager)
    state_restore(state, start)
    got = step_outputs(state, captured())
    strainer, sstate = make_trainer(trainer.model.cfg, "float32", device, train_kw=HALO_TRAIN)
    ref = step_outputs(sstate, strainer.train_step_fn()(sstate, batch_np, 1.0)[1])
    halo_step_gates(f"(a) captured {label} step (1 shard) vs the captured single-device step",
                    got, ref, host(p0))
    del strainer, sstate, words
    torch.cuda.empty_cache()
    return calls, nbytes


def ep_nccl(cfg, mols, device, group) -> dict:
    """Phase 15 (a): the ep step (rung 2a) at one shard and the 1x1 dp x
    halo step (`make_hybrid_mesh(1, 1)` of the NCCL group), each captured
    against its eager run and against the single-device step, fp32,
    tests/test_halo.py's optimizer settings. Returns each one's collectives
    and bytes a step."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import ep, halo, hybrid, mesh

    batch_np, _, _ = bench.padded_batch(cfg, mols)
    out = {}
    local = ep.local_ep_batch(ep.partition_batch(batch_np, 1), 0)
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    em, tensors = ep.ep_model(trainer.model, group), to_torch(local, device)
    out["ep"] = one_shard_step(
        "ep", trainer, state, local,
        lambda: trainer.train_step(state, tensors, 1.0, model=em)[1],
        ep.make_ep_train_step(trainer, group), batch_np, device)
    del trainer, state, em, tensors
    hmesh = mesh.make_hybrid_mesh(1, 1, group)
    check(mesh.backend(hmesh.dp) == "nccl" and mesh.backend(hmesh.ep) == "nccl",
          "(a) the 1x1 mesh's sub-groups are not NCCL")
    stacked, _ = hybrid.build_dp_halo_batch([graph_tuple(cfg, mols)], 1)
    local = hybrid.local_dp_halo_batch(stacked, 0, 0)
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    hm, tensors = halo.halo_model(trainer.model, hmesh.ep), to_torch(local, device)
    out["dp_halo"] = one_shard_step(
        "1x1 dp x halo", trainer, state, local,
        lambda: trainer.train_step(state, tensors, 1.0, group=hmesh.dp, model=hm,
                                   grad_group=hmesh.world)[1],
        hybrid.make_dp_halo_train_step(trainer, hmesh), batch_np, device)
    for kind, (calls, nbytes) in out.items():
        log(f"  (a) collectives of one eager {kind} step at 1 shard: {calls}, "
            f"{sum(nbytes.values()) / 1e6:.2f} MB")
    return out


def ep_kernel_cases(cfg, mols, device, power: str):
    """Phase 15 (b): K1, K2 and K4 (fp32, bf16, split3) at the ep shard's
    shapes: rank 0's chunk of bench-small over PARALLEL_RANKS, its global
    edge ids and plans over every edge; each against its plain version with
    phase 3's checks, each K1 output's segments without a row of the chunk
    (the other rank's band) exactly zero, and each timed as phase 4 times
    the others. Returns (the cases without their tensors, the errors, the
    timings)."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import ep

    batch_np, _, _ = bench.padded_batch(cfg, mols)
    shard = to_torch(ep.local_ep_batch(ep.partition_batch(batch_np, PARALLEL_RANKS), 0), device)
    cases = kernel_cases(cfg, shard, device, tags=("triplet", "quadruplet"))
    for case in cases:
        case["tag"] += "@ep"
    errors = compare_kernels(cases)
    for case in cases:
        if case["kernel"] != "K1":
            continue
        (out,) = case_functions(case)[0]()
        n_seg = case["plan"].n_segments
        empty = torch.bincount(case["ids"], minlength=n_seg) == 0
        band = out[:, empty, :]
        log(f"  {case_label(case)}: {int(empty.sum())} of {n_seg} segments hold no row of the "
            f"chunk; max |out| there {float(band.abs().max()):.1e}")
        check(int(empty.sum()) > n_seg // 3 and bool((band == 0).all()),
              f"{case_label(case)}: the full-width output is not zero outside the chunk's band")
    timings = time_kernels(cases, power)
    for case in cases:  # keep what the kernels line needs, free the rest
        for key in [k for k in case if k not in ("kernel", "tag", "dtype", "shape")]:
            del case[key]
    torch.cuda.empty_cache()
    return cases, errors, timings


def ep_references(cfg, mols, large_mols, device) -> dict:
    """Phase 15 (c)'s single-device card runs: the predict of bench-small
    in fp32, bf16 and "high", the gradient of `ef_loss`, one step at
    test_halo.py's settings; the peak MiB and ms of an eager fp32 step at
    bench-large."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    ref = {}
    batch_np, _, _ = bench.padded_batch(cfg, mols)
    batch = to_torch(batch_np, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, c in (("float32", cfg), ("bfloat16", dataclasses.replace(
                cfg, compute_dtype="bfloat16")), ("high", dataclasses.replace(
                cfg, matmul_precision="high"))):
            ref[f"predict_{name}"] = tuple(host(t) for t in predict(make_model(c, device), batch))
        trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
        ref["p0"] = host(state.params)
        metrics = trainer.train_step_fn()(state, batch_np, 1.0)[1]
        ref["step"] = step_outputs(state, metrics)
        del trainer, state
        # the gradient on a model of its own, after the capture: an eager
        # grad-of-grad on the trainer's model before its capture made the
        # capture's backward touch the legacy stream (first chip call)
        model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
        E, F = energy_and_forces(model, batch, create_graph=True)
        ref["grad"] = host(flat_grad(model, ef_loss(E, F, batch)))
        del model, E, F
    finally:
        torch.use_deterministic_algorithms(False)
    large = to_torch(bench.padded_batch(cfg, large_mols)[0], device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    trainer, state = make_trainer(cfg, "float32", device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, large, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LARGE_EP_STEPS):
        trainer.train_step(state, large, 1.0)
    torch.cuda.synchronize()
    ref["large"] = dict(ms=(time.perf_counter() - t0) / LARGE_EP_STEPS * 1e3,
                        peak_mib=(torch.cuda.max_memory_allocated() - base) / 2**20)
    del trainer, state, large
    torch.cuda.empty_cache()
    return ref


def _gloo_rank(workdir: str, world: int, rank: int):
    """(spec, device, group, cfg) of a spawned phase-15 rank: gloo on the
    card, named (NCCL cannot put two ranks on one GPU)."""
    import datetime

    import torch

    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.parallel import mesh

    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    device = torch.device(spec["device"])
    group = mesh.initialize_distributed(
        f"file://{workdir}/store", world, rank, "gloo", device=device,
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S))
    return spec, device, group, ModelConfig(**spec["cfg"])


def ep_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 15 (c) and (e) on one rank of a gloo group whose ranks share
    cuda:0: ep at bench-small (E/F in fp32, bf16 and "high", the gradient
    of `ef_loss`, one step with its launches, collectives and bytes), one
    eager step at bench-large (peak MiB, ms), and `train.run(ep=world)`."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import ep

    spec, device, group, cfg = _gloo_rank(workdir, world, rank)
    out = {}
    _cuda.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    batch_np, _, _ = bench.padded_batch(cfg, spec["mols"])
    local = ep.local_ep_batch(ep.partition_batch(batch_np, world), rank)
    tensors = to_torch(local, device)
    for name, c in (("float32", cfg), ("bfloat16", dataclasses.replace(
            cfg, compute_dtype="bfloat16")), ("high", dataclasses.replace(
            cfg, matmul_precision="high"))):
        out[f"predict_{name}"] = tuple(host(t) for t in ep.make_ep_apply(
            make_model(c, device), group)(tensors))
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
    _, grads = ep.make_ep_loss_and_grad(model, group, ef_loss)(tensors)
    out["grad"] = host(torch.cat([g.reshape(-1) for g in grads]))
    del model, grads
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    step = ep.make_ep_train_step(trainer, group)
    torch.cuda.synchronize()
    before = collections.Counter(_cuda.kernel_launches())
    (state, metrics), calls, nbytes = collectives_and_bytes(lambda: step(state, local, 1.0))
    torch.cuda.synchronize()
    census = collections.Counter(_cuda.kernel_launches())
    census.subtract(before)
    out["census"], out["collectives"] = dict(+census), (calls, nbytes)
    out["step"] = step_outputs(state, metrics)
    out["shapes"] = {k: tuple(v.shape) for k, v in local.items()
                     if k in ("id_c", "id3_reduce_ca", "id4_reduce_ca")}
    del trainer, state, step, tensors
    torch.use_deterministic_algorithms(False)
    # bench-large: one eager fp32 step's peak and ms
    local = ep.local_ep_batch(ep.partition_batch(
        bench.padded_batch(cfg, spec["large_mols"])[0], world), rank)
    torch.cuda.empty_cache()
    trainer, state = make_trainer(cfg, "float32", device)
    step = ep.make_ep_train_step(trainer, group)
    batch = to_torch(local, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch, 1.0)  # warm-up
    dist.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LARGE_EP_STEPS):
        state, metrics = step(state, batch, 1.0)
    torch.cuda.synchronize()
    out["large"] = dict(ms=(time.perf_counter() - t0) / LARGE_EP_STEPS * 1e3,
                        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                        loss=float(metrics["loss"]), chunks=(local["id3_reduce_ca"].shape[0],
                                                             local["id4_reduce_ca"].shape[0]))
    del trainer, state, step, batch
    torch.cuda.empty_cache()
    # (e) the training entry point
    t0 = time.perf_counter()
    out["run"] = (driver_run(device, workdir, group, ep=world), time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["launches"] = collections.Counter(_cuda.LAUNCHES)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def hybrid_references(cfg, mols, device) -> dict:
    """Phase 15 (d)'s single-device card runs: the gradient of the global
    `ef_parts` loss over bench-small's two halves (each its own batch, as
    the dp x ep rows hold them), and DP_HALO_STEPS steps at test_halo.py's
    settings on all of bench-small."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    ref = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
        ref["p0"] = host(state.params)
        batch_np, _, _ = bench.padded_batch(cfg, mols)
        step = trainer.train_step_fn()
        for _ in range(DP_HALO_STEPS):
            state, metrics, _ = step(state, batch_np, 1.0)
        ref["step"] = step_outputs(state, metrics)
        del trainer, state, step
        # the gradient on a model of its own, after the capture (ep_references)
        model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
        num = den = 0.0
        for half in padded_parts(cfg, mols):
            b = to_torch(half, device)
            E, F = energy_and_forces(model, b, create_graph=True)
            n, d = ef_parts(E, F, b)
            num, den = num + n, den + d
        ref["grad"] = host(flat_grad(model, num / den))
        del model, E, F, num
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return ref


def hybrid_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 15 (d) and (e) on one rank of a gloo group of HYBRID_MESH's
    ranks sharing cuda:0, as a 2-D mesh: the dp x ep loss and gradient on
    bench-small's halves, DP_HALO_STEPS dp x halo steps and an eval of the
    EMA weights, then `train.run(dp_halo=HYBRID_MESH)`."""
    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import hybrid, mesh

    spec, device, group, cfg = _gloo_rank(workdir, world, rank)
    out = {}
    _cuda.reset_launches()
    hmesh = mesh.make_hybrid_mesh(*HYBRID_MESH, group)
    out["place"] = (hmesh.dp_index, hmesh.ep_index, dist.get_process_group_ranks(hmesh.dp),
                    dist.get_process_group_ranks(hmesh.ep))
    torch.use_deterministic_algorithms(True, warn_only=True)
    mols = spec["mols"]
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
    local = hybrid.shard_hybrid_batch(
        hybrid.build_hybrid_batch(padded_parts(cfg, mols), hmesh.n_ep), hmesh, device)
    (loss, grads), calls, nbytes = collectives_and_bytes(
        lambda: hybrid.make_hybrid_loss_and_grad(model, hmesh, ef_parts)(local))
    out["dp_ep"] = (float(loss), host(torch.cat([g.reshape(-1) for g in grads])), calls, nbytes)
    del model, local, grads
    stacked, pads = hybrid.build_dp_halo_batch([graph_tuple(cfg, m) for m in half_molecules(mols)],
                                               hmesh.n_ep)
    host_batch = hybrid.local_dp_halo_batch(stacked, hmesh.dp_index, hmesh.ep_index)
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    step = hybrid.make_dp_halo_train_step(trainer, hmesh)
    for _ in range(DP_HALO_STEPS):
        (state, metrics), calls, nbytes = collectives_and_bytes(
            lambda: step(state, host_batch, 1.0))
    out["dp_halo"] = (step_outputs(state, metrics), calls, nbytes)
    metrics, counts = hybrid.make_dp_halo_eval_step(trainer, hmesh)(state, host_batch,
                                                                    use_ema=True)
    out["eval"] = ({k: float(v) for k, v in metrics.items()},
                   {k: float(v) for k, v in counts.items()})
    del trainer, state, step
    torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["run"] = (driver_run(device, workdir, group, dp_halo=HYBRID_MESH),
                  time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["launches"] = collections.Counter(_cuda.LAUNCHES)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def ep_gloo(cfg, mols, large_mols, device, workdir: str, power: str) -> tuple:
    """Phase 15 (c) and (e): PARALLEL_RANKS gloo ranks running `ep_rank`,
    held against the single-device card. Returns (their launches, the
    bench-large numbers, the collectives of a step)."""
    import dataclasses

    from gemnet_pytorch_tpu_torch.models import GemNet

    ref = ep_references(cfg, mols, large_mols, device)
    t0 = time.perf_counter()
    results = spawn_ranks(os.path.join(workdir, "ep"), dict(
        device=str(device), cfg=dataclasses.asdict(cfg), mols=mols, large_mols=large_mols),
        target=ep_rank)
    log(f"  {PARALLEL_RANKS} gloo ranks on cuda:0 ran (c) and (e) in "
        f"{time.perf_counter() - t0:.1f} s (spawn and CUDA start included)")
    import torch

    names = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for r, res in enumerate(results):
        ef_gates(f"(c) ep predict, bench-small, rank {r}", *res["predict_float32"],
                 *ref["predict_float32"])
        for name, (rel_e, rel_f) in (("bfloat16", (BF16_E_REL, BF16_F_REL)),
                                     ("high", (SERVE_RTOL, SERVE_RTOL))):
            for t, got, want, rel in zip("EF", res[f"predict_{name}"], ref[f"predict_{name}"],
                                         (rel_e, rel_f)):
                ok, err = close(got, want, rel)
                log(f"  (c) ep predict {name}, rank {r}, {t}: max |diff| {err:.3e} vs the "
                    f"single-device {name} predict (rtol {rel} of max |{t}|)")
                check(ok, f"(c) rank {r}'s {name} ep predict {t} disagrees with the single device")
        grad_gates(f"(c) ep gradient of the E/F loss, rank {r}", res["grad"], ref["grad"], names)
        check(np.array_equal(res["grad"], results[0]["grad"]), "(c) the ranks' ep gradients differ")
        halo_step_gates(f"(c) ep fp32 step, bench-small, rank {r}", res["step"], ref["step"],
                        ref["p0"])
        calls, nbytes = res["collectives"]
        log(f"  (c) rank {r}'s chunk: {res['shapes']}; one step launched {res['census']}, "
            f"issued {calls} ({sum(nbytes.values()) / 1e6:.2f} MB)")
        check(res["census"] == EP_LAUNCHES,
              f"(c) rank {r}'s ep step launched {res['census']}, expected {EP_LAUNCHES}")
    n_psum = 8 * cfg.num_blocks + 3
    check(results[0]["collectives"][0] == {("all_reduce", "gloo"): n_psum},
          f"(c) an ep step issued {results[0]['collectives'][0]}, expected {n_psum} all-reduces")
    large = dict(single=ref["large"], ranks=[res["large"] for res in results])
    log(f"  (c) bench-large eager fp32 ep step [{power}]: chunks {results[0]['large']['chunks']} "
        f"rows a rank; peak MiB a rank " + ", ".join(
            f"{x['peak_mib']:.1f}" for x in large["ranks"]) + f" vs single-device "
        f"{ref['large']['peak_mib']:.1f}; ms " + ", ".join(
            f"{x['ms']:.1f}" for x in large["ranks"]) + f" (gloo through the host, 2 ranks "
        f"sharing one card: not a scaling number) vs single-device eager "
        f"{ref['large']['ms']:.1f}")
    best = [res["run"][0] for res in results]
    log(f"  (e) train.run(ep={PARALLEL_RANKS}) over the gloo ranks, {PARALLEL_RUN['num_steps']} "
        f"steps in {max(res['run'][1] for res in results):.1f} s: best {best[0]}")
    check(all(b == best[0] for b in best), "(e) the ranks' train.run(ep) disagree")
    launches = collections.Counter()
    for res in results:
        launches.update(res["launches"])
    return launches, large, results[0]["collectives"]


def hybrid_gloo(cfg, mols, device, workdir: str) -> tuple:
    """Phase 15 (d) and (e): a 2x2 mesh of gloo ranks running `hybrid_rank`,
    held against the single-device card. Returns (their launches, the
    collectives of the dp x ep loss-and-grad and of a dp x halo step)."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.models import GemNet

    ref = hybrid_references(cfg, mols, device)
    world = HYBRID_MESH[0] * HYBRID_MESH[1]
    t0 = time.perf_counter()
    results = spawn_ranks(os.path.join(workdir, "hybrid"), dict(
        device=str(device), cfg=dataclasses.asdict(cfg), mols=mols), target=hybrid_rank,
        world=world)
    log(f"  {world} gloo ranks on cuda:0 ran (d) and (e) in {time.perf_counter() - t0:.1f} s")
    names = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for r, res in enumerate(results):
        d, e, dp_ranks, ep_ranks = res["place"]
        check((d, e) == divmod(r, HYBRID_MESH[1]) and ep_ranks == [d * HYBRID_MESH[1] + x for x in
                                                                 range(HYBRID_MESH[1])]
              and dp_ranks == [x * HYBRID_MESH[1] + e for x in range(HYBRID_MESH[0])],
              f"(d) rank {r}'s place in the mesh: {res['place']}")
        grad_gates(f"(d) dp x ep gradient over the two halves, rank {r}", res["dp_ep"][1],
                   ref["grad"], names)
        check(np.array_equal(res["dp_ep"][1], results[0]["dp_ep"][1]),
              "(d) the ranks' dp x ep gradients differ")
        halo_step_gates(f"(d) {DP_HALO_STEPS} dp x halo fp32 steps, rank {r}", res["dp_halo"][0],
                        ref["step"], ref["p0"])
        check(all(np.array_equal(a, b) for a, b in zip(res["dp_halo"][0][1:],
                                                       results[0]["dp_halo"][0][1:])),
              "(d) the ranks' dp x halo states differ")
        check(res["eval"] == results[0]["eval"], "(d) the ranks' dp x halo evals differ")
    # the eval against the single-device eval of the same (rank 0's) weights
    (loss, params, ema, _), _, _ = results[0]["dp_halo"]
    trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    state.params.copy_(torch.from_numpy(params))
    state.ema_params.copy_(torch.from_numpy(ema))
    batch_np, _, _ = bench.padded_batch(cfg, mols)
    want, counts = trainer.eval_step_fn()(state, batch_np, use_ema=True)
    got, got_counts = results[0]["eval"]
    rel = max(abs(got[k] - float(want[k])) / abs(float(want[k])) for k in want)
    log(f"  (d) dp x halo eval of the EMA weights vs the single-device eval of them: max rel "
        f"{rel:.3e} (limit {SERVE_RTOL}); counts {got_counts}")
    check(rel <= SERVE_RTOL and got_counts == {k: float(v) for k, v in counts.items()},
          "(d) the dp x halo eval disagrees with the single-device eval")
    del trainer, state
    for key, label in (("dp_ep", "dp x ep loss and gradient"), ("dp_halo", "dp x halo step")):
        calls, nbytes = results[0][key][-2:]
        log(f"  (d) collectives of one {label} on a rank: {calls}, "
            f"{sum(nbytes.values()) / 1e6:.2f} MB")
    best = [res["run"][0] for res in results]
    log(f"  (e) train.run(dp_halo={HYBRID_MESH}) over the gloo ranks, "
        f"{PARALLEL_RUN['num_steps']} steps in {max(res['run'][1] for res in results):.1f} s: "
        f"best {best[0]}")
    check(all(b == best[0] for b in best), "(e) the ranks' train.run(dp_halo) disagree")
    launches = collections.Counter()
    for res in results:
        launches.update(res["launches"])
    return launches, {k: results[0][k][-2:] for k in ("dp_ep", "dp_halo")}


def ep_hybrid_phase(cfg, mols, device, workdir: str, power: str, large_mols=None) -> dict:
    """Phase 15: (b) the ep kernels against their plain versions; then, the
    launch counters set to 0, (a) on an NCCL group of one with
    deterministic algorithms, (c) and (e) on PARALLEL_RANKS gloo ranks, (d)
    and (e) on a 2x2 mesh of gloo ranks. Returns the ep kernel cases, their
    errors and timings, and the numbers and launches of the phase (this
    process's and its ranks')."""
    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import mesh

    out = {}
    log("  (b) K1, K2 and K4 at the ep shard's shapes")
    out["cases"], out["errors"], out["timings"] = ep_kernel_cases(cfg, mols, device, power)
    _cuda.reset_launches()
    group = mesh.initialize_distributed(f"localhost:{free_port()}", 1, 0, device=device)
    check(mesh.backend(group) == "nccl", f"phase 15's group is {mesh.backend(group)}, not NCCL")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["one_shard"] = ep_nccl(cfg, mols, device, group)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    launches, out["large"], out["ep_collectives"] = ep_gloo(
        cfg, mols, large_mols or bench.molecules("large"), device, workdir, power)
    hybrid_launches, out["hybrid_collectives"] = hybrid_gloo(cfg, mols, device, workdir)
    launches.update(hybrid_launches)
    torch.cuda.synchronize()
    launches.update(_cuda.LAUNCHES)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- phase 16

def pp_launches(cfg, n_stages: int, n_micro: int) -> dict:
    """Launches of one fp32 pp train step on each rank (PP_LAUNCHES): its
    stage runs on every one of the T = M + S - 1 ticks (`parallel/pp.py`),
    and each block of each tick launches what a block of the single-device
    step does (TRAIN_LAUNCHES / 4 blocks: 6 K1, 6 K2, 6 K3); the preamble
    adds each microbatch's 2 geometry K3s of -dE/dR."""
    per = 6 * (cfg.num_blocks // n_stages) * (n_micro + n_stages - 1)
    return {"gemnet_segment_outer_sum_f32": per, "gemnet_segment_gather_contract_f32": per,
            "gemnet_sorted_segsum_f32": per + 2 * n_micro}


def pp_ef_loss(E, F, batch):
    """`ef_loss` over stacked (M, ...) outputs and targets."""
    import torch

    m = batch["mol_mask"].float()[..., None]
    am = batch["atom_mask"].float()[..., None]
    return torch.sum(torch.abs(E - batch["E"]) * m) + torch.sum(
        torch.abs(F[..., 0, :] - batch["F"]) * am)


def pp_trainer(cfg, device, group, n_micro: int, train_kw=None):
    """(PPTrainer, its state) of this rank's PipelineStage of GemNet(cfg),
    weights from seed 0 (those of `make_trainer`), at `make_trainer`'s
    TrainConfig."""
    import torch

    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import mesh, pp
    from gemnet_pytorch_tpu_torch.training import Trainer

    stage, n = (0, 1) if group is None else (mesh.rank(group), mesh.world_size(group))
    model = pp.PipelineStage(cfg, stage, n, generator=torch.Generator().manual_seed(0),
                             device=device)
    trainer = Trainer(model, TrainConfig(**{"warmup_steps": 1, **(train_kw or {})}))
    ppt = pp.PPTrainer(trainer, group, n_micro)
    return ppt, ppt.init_state()


def monolithic_names(cfg) -> list:
    """GemNet(cfg)'s parameter names in `parameters()` order (the single
    device's flat buffer)."""
    import torch

    from gemnet_pytorch_tpu_torch.models import GemNet

    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return [n for n, _ in model.named_parameters()]


def pp_flat(named: dict, names) -> np.ndarray:
    """Tensors by name as one flat vector in the single device's order."""
    return np.concatenate([np.asarray(named[n], np.float32).reshape(-1) for n in names])


def pp_step_outputs(ppt, state, metrics, names):
    """(loss, parameters, EMA, accumulators) after a pp step, the parameters
    and EMA merged (collective) into the single device's order."""
    params = ppt.merged_state_dict(state)
    ema = ppt.merged_state_dict(state, ema=True)
    return (float(metrics["loss"]), pp_flat({n: params[n].numpy() for n in names}, names),
            pp_flat({n: ema[n].numpy() for n in names}, names), host(state.metric_acc))


def pp_nccl(cfg, mols, device, group, names) -> tuple:
    """Phase 16 (a): one stage on the NCCL group of one, bench-small in
    PP_NCCL_MICRO quarters: CAPTURED_STEPS captured PPTrainer steps against
    its eager steps from one state (bit-equal where two eager runs are, else
    phase 11's gates), the collectives and launches of one eager step, and
    one captured step against the captured single-device step on all of
    bench-small (phase 14's 1-shard gates). Returns (the collectives and
    bytes of a step, its launches)."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import pp

    quarters = padded_parts(cfg, mols, PP_NCCL_MICRO)
    ppt, state = pp_trainer(cfg, device, group, PP_NCCL_MICRO, train_kw=HALO_TRAIN)
    tensors = [to_torch(q, device) for q in quarters]
    rows = np.stack([ppt.trainer.packer.pack(q) for q in quarters])
    snapshot = list(pp.state_tensors(state).values())
    start = [t.clone() for t in snapshot]

    def restore():
        for t, v in zip(snapshot, start):
            t.copy_(v)

    def flat_params():
        return torch.cat([state.params["pre"], state.params["stage"]])

    p0 = flat_params().clone()
    step_fn = ppt.train_step_fn()

    def five(step):
        restore()
        losses = [step()["loss"].detach().clone() for _ in range(CAPTURED_STEPS)]
        torch.cuda.synchronize()
        return torch.stack(losses).cpu().numpy(), flat_params().clone(), state.metric_acc.clone()

    eager = lambda: ppt.train_step(state, tensors, 1.0)[1]  # noqa: E731
    captured = lambda: step_fn(state, rows, 1.0)[1]  # noqa: E731
    a, b, c = five(eager), five(eager), five(captured)
    (ab, ab_equal), (ca, ca_equal) = run_diffs(b, a, p0), run_diffs(c, a, p0)
    check(ppt._captured is not None, "(a) the pp step was not captured")
    log(f"  (a) pp at 1 stage, NCCL, {PP_NCCL_MICRO} microbatches: {CAPTURED_STEPS} captured "
        f"steps vs eager: bit-equal {ca_equal} (two eager runs bit-equal {ab_equal}); max loss "
        f"rel {ca[0]:.3e}, update rel L2 {ca[1]:.3e} (second eager run vs the first: "
        f"{ab[0]:.3e}, {ab[1]:.3e})"
        + (f"; captured in {ppt._captured[1].seconds:.2f} s" if ppt._captured else ""))
    if ab_equal:
        check(ca_equal, "(a) two eager pp runs are bit-equal and the captured one is not")
    check(ca[0] <= CAPTURED_LOSS_RTOL and ca[1] <= CAPTURED_UPDATE_REL_L2,
          "(a) the captured pp step disagrees with its eager run")
    restore()
    torch.cuda.synchronize()
    before = collections.Counter(_cuda.kernel_launches())
    _, calls, nbytes = collectives_and_bytes(eager)
    torch.cuda.synchronize()
    census = collections.Counter(_cuda.kernel_launches())
    census.subtract(before)
    want = pp_launches(cfg, 1, PP_NCCL_MICRO)
    log(f"  (a) one eager pp step launched {dict(+census)} (expected {want}), issued {calls} "
        f"({sum(nbytes.values()) / 1e6:.2f} MB)")
    check(dict(+census) == want, "(a) the pp step's launches are not the pinned count")
    restore()
    p0_mono = pp_flat({n: t.numpy() for n, t in ppt.merged_state_dict(state).items()}, names)
    got = pp_step_outputs(ppt, state, captured(), names)
    strainer, sstate = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
    check(np.array_equal(host(sstate.params), p0_mono),
          "(a) the stage's weights are not the single device's")
    batch_np, _, _ = bench.padded_batch(cfg, mols)
    ref = step_outputs(sstate, strainer.train_step_fn()(sstate, batch_np, 1.0)[1])
    halo_step_gates(f"(a) captured pp step ({PP_NCCL_MICRO} quarters, 1 stage) vs the captured "
                    "single-device step on bench-small", got, ref, p0_mono)
    del strainer, sstate, ppt, state
    torch.cuda.empty_cache()
    return calls, nbytes


def pp_kernel_cases(cfg, mols, device, power: str):
    """Phase 16 (b): K1, K2 and K3 (fp32, bf16; K4 as split3) at the shapes
    of a pp microbatch: the first of bench-small's PP_MICRO eighths, as
    (c) pads them; each against its plain version with phase 3's checks and
    timed as phase 4 times the others. Returns (the cases without their
    tensors, the errors, the timings)."""
    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch

    micro = to_torch(padded_parts(cfg, mols, PP_MICRO)[0], device)
    cases = kernel_cases(cfg, micro, device, tags=(
        "triplet", "quadruplet", "trip_ba", "intm_db", "quad_abd", "geometry_abd",
        "geometry_cab"))
    for case in cases:
        case["tag"] += "@pp"
    errors = compare_kernels(cases)
    timings = time_kernels(cases, power)
    for case in cases:
        for key in [k for k in case if k not in ("kernel", "tag", "dtype", "shape")]:
            del case[key]
    torch.cuda.empty_cache()
    return cases, errors, timings


def pp_references(cfg, mols, device) -> dict:
    """Phase 16 (c) and (d)'s single-device card runs, with deterministic
    algorithms: the predict of each of bench-small's PP_MICRO eighths in
    fp32, bf16 and "high"; the gradient of `ef_loss` summed over the
    eighths; one step at test_halo.py's settings on all of bench-small."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    ref = {}
    eighths = [to_torch(e, device) for e in padded_parts(cfg, mols, PP_MICRO)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, c in (("float32", cfg), ("bfloat16", dataclasses.replace(
                cfg, compute_dtype="bfloat16")), ("high", dataclasses.replace(
                cfg, matmul_precision="high"))):
            model = make_model(c, device)
            out = [predict(model, e) for e in eighths]
            ref[f"predict_{name}"] = tuple(np.stack([host(o[i]) for o in out])
                                           for i in range(2))
        trainer, state = make_trainer(cfg, "float32", device, train_kw=HALO_TRAIN)
        ref["p0"] = host(state.params)
        metrics = trainer.train_step_fn()(state, bench.padded_batch(cfg, mols)[0], 1.0)[1]
        ref["step"] = step_outputs(state, metrics)
        del trainer, state
        # the gradient on a model of its own, after the capture (ep_references)
        model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device=device)
        loss = 0.0
        for e in eighths:
            E, F = energy_and_forces(model, e, create_graph=True)
            loss = loss + ef_loss(E, F, e)
        ref["grad"] = host(flat_grad(model, loss))
        del model, E, F, loss
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    return ref


def pp_driver_run(device, workdir: str, group) -> dict:
    """Phase 16 (e): `train.run(pp=2, pp_micro=PP_DRIVER_MICRO)` for
    PARALLEL_RUN's steps, then a resume to 2 more with the export: the best
    metrics, finite; rank 0's checkpoint at the last step with both stages'
    rows; the export loaded into a monolithic model."""
    import torch

    from gemnet_pytorch_tpu_torch import train as train_driver
    from gemnet_pytorch_tpu_torch.compat import strip_reference_aliases
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.parallel import mesh

    run_dir = os.path.join(workdir, "run_pp")
    export = os.path.join(workdir, "pp_export.pth")
    config = dict(PARALLEL_RUN, restart=run_dir, logdir=workdir)
    kw = dict(device=device, synthetic_molecules=PARALLEL_RUN_MOLECULES, group=group,
              pp=mesh.world_size(group), pp_micro=PP_DRIVER_MICRO)
    first = train_driver.run(config, **kw)
    n_steps = PARALLEL_RUN["num_steps"] + 2
    second = train_driver.run(dict(config, num_steps=n_steps), export_torch=export, **kw)
    for best in (first, second):
        check(all(np.isfinite(v) for v in best.values()), "(e) train.run(pp): non-finite metrics")
    if mesh.is_main(group):
        ckpt = torch.load(os.path.join(run_dir, "logs", "checkpoint"), map_location="cpu",
                          weights_only=True)
        check(int(ckpt["step"]) == n_steps
              and ckpt["params.stage"].shape[0] == mesh.world_size(group),
              f"(e) rank 0's pp checkpoint: step {int(ckpt['step'])}, "
              f"{ckpt['params.stage'].shape[0]} stages")
        model = GemNet(ModelConfig.from_dict(config), generator=torch.Generator().manual_seed(0),
                       device="cpu")
        model.load_state_dict(strip_reference_aliases(torch.load(export, weights_only=True)),
                              strict=True)
    return dict(first=first, second=second)


def pp_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 16 (c) and (e) on one rank of a gloo group of PP_RANKS ranks
    sharing cuda:0, S = PP_RANKS: on bench-small's PP_MICRO eighths, E/F in
    fp32, bf16 and "high", the gradient of `ef_loss` and one step, each
    with the collectives it issued, in order; one eager fp32 step on
    bench-large's systems, one a microbatch (peak MiB, ms); then
    `train.run(pp=world)`."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import collectives, pp

    spec, device, group, cfg = _gloo_rank(workdir, world, rank)
    out = {}
    _cuda.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    eighths = [to_torch(e, device) for e in padded_parts(cfg, spec["mols"], PP_MICRO)]
    for name, c in (("float32", cfg), ("bfloat16", dataclasses.replace(
            cfg, compute_dtype="bfloat16")), ("high", dataclasses.replace(
            cfg, matmul_precision="high"))):
        stage = pp.PipelineStage(c, rank, world, generator=torch.Generator().manual_seed(0),
                                 device=device).requires_grad_(False)
        with collectives.recorded() as seq:
            E, F = pp.make_pp_energy_and_forces(stage, group)(eighths)
        out[f"predict_{name}"] = (host(E), host(F), seq)
        del stage
    stage = pp.PipelineStage(cfg, rank, world, generator=torch.Generator().manual_seed(0),
                             device=device)
    with collectives.recorded() as seq:
        _, grads = pp.make_pp_loss_and_grad(stage, group, pp_ef_loss)(eighths)
    out["grad"] = ({k: host(g) for k, g in grads.items()}, seq)
    del stage, grads
    ppt, state = pp_trainer(cfg, device, group, PP_MICRO, train_kw=HALO_TRAIN)
    torch.cuda.synchronize()
    before = collections.Counter(_cuda.kernel_launches())
    with collectives.recorded() as seq:
        (state, metrics, _), calls, nbytes = collectives_and_bytes(
            lambda: ppt.train_step(state, eighths, 1.0))
    torch.cuda.synchronize()
    census = collections.Counter(_cuda.kernel_launches())
    census.subtract(before)
    out["census"], out["collectives"], out["seq"] = dict(+census), (calls, nbytes), seq
    out["step"] = pp_step_outputs(ppt, state, metrics, spec["names"])
    out["shapes"] = {k: tuple(v.shape) for k, v in eighths[0].items()
                     if k in ("id_c", "id3_reduce_ca", "id4_reduce_ca")}
    del ppt, state, eighths
    torch.use_deterministic_algorithms(False)
    # bench-large: one eager fp32 pp step, one system a microbatch
    large = [to_torch(b, device) for b in padded_parts(cfg, spec["large_mols"],
                                                       PP_LARGE_MICRO)]
    torch.cuda.empty_cache()
    ppt, state = pp_trainer(cfg, device, group, PP_LARGE_MICRO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ppt.train_step(state, large, 1.0)  # warm-up
    dist.barrier(group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics, _ = ppt.train_step(state, large, 1.0)
    torch.cuda.synchronize()
    out["large"] = dict(ms=(time.perf_counter() - t0) * 1e3,
                        peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                        loss=float(metrics["loss"]),
                        params=sum(p.numel() for p in ppt.model.parameters()))
    del ppt, state, large
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["run"] = (pp_driver_run(device, workdir, group), time.perf_counter() - t0)
    torch.cuda.synchronize()
    out["launches"] = collections.Counter(_cuda.LAUNCHES)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def pp_wide_rank(rank: int, world: int, workdir: str) -> None:
    """Phase 16 (d) on one rank of a gloo group of PP_WIDE ranks sharing
    cuda:0: S = PP_WIDE E/F on bench-small's eighths; then the 2x2 dp x pp
    mesh (`make_hybrid_mesh(*PP_MESH)`, its rows pipelines of 2 stages,
    each row half of the eighths): the loss and gradient of `ef_loss`."""
    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import collectives, mesh, pp

    spec, device, group, cfg = _gloo_rank(workdir, world, rank)
    out = {}
    _cuda.reset_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    eighths = [to_torch(e, device) for e in padded_parts(cfg, spec["mols"], PP_MICRO)]
    stage = pp.PipelineStage(cfg, rank, world, generator=torch.Generator().manual_seed(0),
                             device=device).requires_grad_(False)
    with collectives.recorded() as seq:
        E, F = pp.make_pp_energy_and_forces(stage, group)(eighths)
    out["predict"] = (host(E), host(F), seq)
    del stage
    hmesh = mesh.make_hybrid_mesh(*PP_MESH, group)
    out["place"] = (hmesh.dp_index, hmesh.pp_index)
    stage = pp.PipelineStage(cfg, hmesh.pp_index, hmesh.n_pp,
                             generator=torch.Generator().manual_seed(0), device=device)
    m = PP_MICRO // hmesh.n_dp
    row = eighths[hmesh.dp_index * m:(hmesh.dp_index + 1) * m]
    with collectives.recorded() as seq:
        loss, grads = pp.make_pp_loss_and_grad(stage, hmesh, pp_ef_loss)(row)
    out["dp_pp"] = (float(loss), {k: host(g) for k, g in grads.items()}, seq)
    torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    out["launches"] = collections.Counter(_cuda.LAUNCHES)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def merged_grad(results, key, names) -> np.ndarray:
    """The ranks' gradients by name (each rank's preamble and stage),
    checked equal where two ranks hold one parameter, as one flat vector in
    the single device's order."""
    merged = {}
    for res in results:
        for name, g in res[key][1 if key == "dp_pp" else 0].items():
            if name in merged:
                check(np.array_equal(merged[name], g),
                      f"({key}) two ranks' gradients of {name} differ")
            merged[name] = g
    check(sorted(merged) == sorted(names), f"({key}) the ranks' gradients miss parameters")
    return pp_flat(merged, names)


def pp_gloo(cfg, mols, large_mols, device, workdir: str, power: str, names,
            single_large=None) -> tuple:
    """Phase 16 (c)-(e): PP_RANKS gloo ranks running `pp_rank`, then
    PP_WIDE running `pp_wide_rank`, held against the single-device card.
    Returns (their launches, the bench-large numbers, the collectives of a
    step)."""
    import dataclasses

    import torch

    from gemnet_pytorch_tpu_torch.models import GemNet

    ref = pp_references(cfg, mols, device)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    spec = dict(device=str(device), cfg=dataclasses.asdict(cfg), mols=mols,
                large_mols=large_mols, names=names)
    t0 = time.perf_counter()
    results = spawn_ranks(os.path.join(workdir, "pp"), spec, target=pp_rank, world=PP_RANKS)
    log(f"  {PP_RANKS} gloo ranks on cuda:0 ran (c) and (e) in {time.perf_counter() - t0:.1f} s "
        f"(spawn and CUDA start included)")
    want = pp_launches(cfg, PP_RANKS, PP_MICRO)
    for r, res in enumerate(results):
        E, F, seq = res["predict_float32"]
        ef_gates(f"(c) pp predict of the {PP_MICRO} eighths, rank {r}", E, F,
                 *ref["predict_float32"])
        check(seq == results[0]["predict_float32"][2], "(c) the ranks' pp predict collectives "
              "differ in order")
        for name, (rel_e, rel_f) in (("bfloat16", (BF16_E_REL, BF16_F_REL)),
                                     ("high", (SERVE_RTOL, SERVE_RTOL))):
            got = res[f"predict_{name}"]
            for t, g, w, rel in zip("EF", got[:2], ref[f"predict_{name}"], (rel_e, rel_f)):
                ok, err = close(g, w, rel)
                log(f"  (c) pp predict {name}, rank {r}, {t}: max |diff| {err:.3e} vs the "
                    f"single-device {name} predict (rtol {rel} of max |{t}|)")
                check(ok, f"(c) rank {r}'s {name} pp predict {t} disagrees with the single device")
            check(got[2] == results[0][f"predict_{name}"][2],
                  f"(c) the ranks' {name} pp predict collectives differ in order")
        check(res["grad"][1] == results[0]["grad"][1],
              "(c) the ranks' pp gradient collectives differ in order")
        halo_step_gates(f"(c) pp fp32 step ({PP_MICRO} eighths, {PP_RANKS} stages) vs the "
                        f"single-device step on bench-small, rank {r}", res["step"], ref["step"],
                        ref["p0"])
        calls, nbytes = res["collectives"]
        log(f"  (c) rank {r}: an eighth {res['shapes']}; one step launched {res['census']} "
            f"(expected {want}), issued {calls} ({sum(nbytes.values()) / 1e6:.2f} MB) in "
            f"{len(res['seq'])} collectives")
        check(res["census"] == want, f"(c) rank {r}'s pp step launched {res['census']}")
        check(res["seq"] == results[0]["seq"],
              f"(c) rank {r}'s pp step issued its collectives in another order than rank 0")
    grad_gates("(c) pp gradient of the E/F loss over the eighths (merged over the ranks)",
               merged_grad(results, "grad", names), ref["grad"], model)
    large = dict(single=single_large, ranks=[res["large"] for res in results])
    log(f"  (c) bench-large eager fp32 pp step [{power}]: {PP_RANKS} stages, {PP_LARGE_MICRO} "
        f"microbatches of one system; parameters a rank " + ", ".join(
            str(x["params"]) for x in large["ranks"]) + "; peak MiB a rank " + ", ".join(
            f"{x['peak_mib']:.1f}" for x in large["ranks"]) + "; ms " + ", ".join(
            f"{x['ms']:.1f}" for x in large["ranks"]) + " (gloo through the host, 2 ranks "
        "sharing one card: not a scaling number)" + (
            f" vs single-device eager on bench-large {single_large['peak_mib']:.1f} MiB, "
            f"{single_large['ms']:.1f} ms" if single_large else ""))
    first = [res["run"][0] for res in results]
    log(f"  (e) train.run(pp={PP_RANKS}, pp_micro={PP_DRIVER_MICRO}) over the gloo ranks, "
        f"{PARALLEL_RUN['num_steps']} steps, then a resume to "
        f"{PARALLEL_RUN['num_steps'] + 2} with the export, in "
        f"{max(res['run'][1] for res in results):.1f} s: best {first[0]['second']}")
    check(all(b == first[0] for b in first), "(e) the ranks' train.run(pp) disagree")
    launches = collections.Counter()
    for res in results:
        launches.update(res["launches"])
    # (d)
    t0 = time.perf_counter()
    wide = spawn_ranks(os.path.join(workdir, "pp_wide"), spec, target=pp_wide_rank,
                       world=PP_WIDE)
    log(f"  {PP_WIDE} gloo ranks on cuda:0 ran (d) in {time.perf_counter() - t0:.1f} s")
    for r, res in enumerate(wide):
        # SERVE_RTOL of the largest |E|, |F|, as every card-vs-card predict
        # of phase 14 (d): the psum of 4 ranks' partial dE/dR sums in
        # another order than one backward (tests/test_torch_pp.py measures
        # the same at 4 stages: up to 5 times tests/test_pp.py's gate)
        E, F, seq = res["predict"]
        for name, got, want in zip("EF", (E, F), ref["predict_float32"]):
            ok, err = close(got, want, SERVE_RTOL)
            log(f"  (d) pp predict at {PP_WIDE} stages, rank {r}, {name}: max |diff| {err:.3e}, "
                f"max |{name}| {np.abs(want).max():.3e} (rtol {SERVE_RTOL} of it)")
            check(ok, f"(d) rank {r}'s S = {PP_WIDE} pp {name} disagrees with the single device")
        check(seq == wide[0]["predict"][2], "(d) the ranks' pp collectives differ in order")
        check(res["place"] == divmod(r, PP_MESH[1]), f"(d) rank {r}'s place {res['place']}")
        loss = res["dp_pp"][0]
        check(loss == wide[0]["dp_pp"][0] and res["dp_pp"][2] == wide[0]["dp_pp"][2],
              "(d) the ranks' dp x pp losses or collectives differ")
    grad_gates(f"(d) dp x pp {PP_MESH[0]}x{PP_MESH[1]} gradient of the E/F loss (merged)",
               merged_grad(wide, "dp_pp", names), ref["grad"], model)
    log(f"  (d) dp x pp collectives of the loss and gradient on a rank: "
        f"{collections.Counter(k for k, _, _ in wide[0]['dp_pp'][2])}")
    for res in wide:
        launches.update(res["launches"])
    return launches, large, results[0]["collectives"]


def pp_phase(cfg, mols, device, workdir: str, power: str, large_mols=None,
             single_large=None) -> dict:
    """Phase 16: (b) the pp microbatch's kernels against their plain
    versions; then, the launch counters at 0, (a) on an NCCL group of one
    with deterministic algorithms, (c)-(e) on gloo ranks sharing cuda:0.
    `single_large`: the single-device eager fp32 step's peak MiB and ms on
    bench-large (phase 15), printed beside the pp ranks'. Returns the cases,
    errors and timings of (b), and the launches and numbers of the phase."""
    import torch
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.parallel import mesh

    out = {}
    names = monolithic_names(cfg)
    log("  (b) K1, K2, K3 and K4 at a pp microbatch's shapes (an eighth of bench-small)")
    out["cases"], out["errors"], out["timings"] = pp_kernel_cases(cfg, mols, device, power)
    _cuda.reset_launches()
    group = mesh.initialize_distributed(f"localhost:{free_port()}", 1, 0, device=device)
    check(mesh.backend(group) == "nccl", f"phase 16's group is {mesh.backend(group)}, not NCCL")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["one_stage"] = pp_nccl(cfg, mols, device, group, names)
    finally:
        torch.use_deterministic_algorithms(False)
        dist.destroy_process_group()
    launches, out["large"], out["collectives"] = pp_gloo(
        cfg, mols, large_mols or bench.molecules("large"), device, workdir, power, names,
        single_large)
    torch.cuda.synchronize()
    launches.update(_cuda.LAUNCHES)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------- bench

def run_bench(workdir: str, windows: int = 3):
    """Phase 10: `gemnet_pytorch_tpu_torch.bench` in-process with --profile
    and K steps per call (BENCH_ARGS), both workloads and both dtypes,
    `windows` timed windows each (the captured step). It prints its JSON
    line; the line must hold every BENCH_KEYS value, no step below its
    floor, a kernel census of one step equal to the pinned launches, and
    K1-K3 in both workloads' traces of the captured step. Returns (launches
    by kernel and shape, the JSON)."""
    import os

    import torch

    from gemnet_pytorch_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = bench.run(bench.parse_args(["--profile", os.path.join(workdir, "trace"), *BENCH_ARGS]),
                    windows=windows)
    torch.cuda.synchronize()
    census = dict(_cuda.LAUNCHES)
    log(f"  bench: {time.perf_counter() - t0:.1f} s, {sum(census.values())} launches")
    missing = [k for k in BENCH_KEYS if out.get(k) is None]
    check(not missing, f"the bench's JSON has no value for {missing}")
    check(out["below_floor"] is False and out["large_below_floor"] is False,
          "a bench step measured below its speed-of-light floor")
    calls = sum(TRAIN_LAUNCHES["bfloat16"].values())
    check(out["kernel_calls"] == calls and out["large_kernel_calls"] == calls,
          f"the bench's kernel census ({out['kernel_calls']}, {out['large_kernel_calls']} calls) "
          f"is not the {calls} launches of a bf16 step")
    for prefix in ("", "large_"):
        step_ms, groups = out[f"{prefix}profile_step_ms"], out[f"{prefix}profile_groups_ms"]
        check((step_ms or 0) > 0 and all(groups[k] > 0 for k in ("K1", "K2", "K3")),
              f"the bench's trace readback: {step_ms} ms a {prefix}step, groups {groups}")
    check(all(set(out[f"{k}_peak_mib"]) == {"bfloat16", "float32"} for k in bench.KINDS),
          "the bench reports no peak memory of a workload and dtype")
    check(out["steps_per_call"] == 2 and out["large_scan"] == 4,
          f"the bench ran {out['steps_per_call']} steps per call, large scan {out['large_scan']}")
    log(f"  K steps per call: small scan2 {out['scan_ms']:.3f} ms/step vs single "
        f"{out['small_ms_median']:.3f}; large scan4 {out['large_scan_ms']:.3f} vs single "
        f"{out['large_ms_median']:.3f} (dispatch overhead {out['large_dispatch_overhead_ms']:.3f} "
        "ms/step)")
    return census, out


# ---------------------------------------------------------------- main

def main() -> int:
    # cuBLAS sums in a fixed order only with a fixed workspace configuration,
    # which torch.use_deterministic_algorithms asks for (phase 11); it is
    # read at the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import native, to_torch
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.scripts import gather_probe

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
    t0 = time.perf_counter()
    log(f"  the native graph builder: {native.build()} in {time.perf_counter() - t0:.1f} s")
    for source, text in _cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{source}] {line.strip()}")

    cfg = ModelConfig()
    mols = bench.molecules("small")
    batch_np, _, _ = bench.padded_batch(cfg, mols)
    cases = kernel_cases(cfg, to_torch(batch_np, device), device)

    log("== 3. kernels vs plain versions (bench-small shapes: fp32, bf16 and split3 streams; "
        "the gather probe's shape)")
    errors = compare_kernels(cases)
    # the bench-large batch's quadruplet and quad_abd shapes, one case at a
    # time (a plain K1/K2 there makes a (2454528, 1568) fp32 temporary)
    t0 = time.perf_counter()
    large_np, _, _ = bench.padded_batch(cfg, bench.molecules("large"))
    large = kernel_cases(cfg, to_torch(large_np, device), device, tags=LARGE_TAGS)
    for case in large:
        case["tag"] += "@large"
    log("== 3. kernels vs plain versions at the bench-large shapes (quadruplet K1/K2/K4, "
        "K3 quad_abd)")
    errors.update(compare_kernels(large))
    log(f"  large shapes checked in {time.perf_counter() - t0:.1f} s")
    # the halo path's K1/K2 shapes: rank 0's shard of bench-small over
    # PARALLEL_RANKS, its own rows and segment plans (phase 14 (c) launches
    # them, in fp32)
    from gemnet_pytorch_tpu_torch.parallel import local_halo_batch

    shard = to_torch(local_halo_batch(halo_batches(cfg, mols, PARALLEL_RANKS)[1], 0), device)
    halo = [c for c in kernel_cases(cfg, shard, device, tags=("triplet", "quadruplet"))
            if c["dtype"] == "f32"]
    for case in halo:
        case["tag"] += "@halo"
    log(f"== 3. kernels vs plain versions at the halo shard's shapes ({PARALLEL_RANKS} ranks, "
        "bench-small: K1/K2 fp32 on a rank's local rows and plans)")
    errors.update(compare_kernels(halo))
    del shard
    large += halo

    log(f"== 4. kernel timing [{power}]")
    timings = time_kernels(cases + large, power)
    for case in large:  # keep what the kernels line needs, free the rest
        for key in [k for k in case if k not in ("kernel", "tag", "dtype", "shape")]:
            del case[key]
    torch.cuda.empty_cache()

    log("== 5. serving GemNet-Q (config.yaml widths, random weights, seed 0)")
    serve_census, per_kernel, timing, exact_E = serve(cfg, mols, device)
    check(per_kernel == SERVE_LAUNCHES["default"],
          f"one predict launched {per_kernel}, expected {SERVE_LAUNCHES['default']}")
    serve_high_census = serve_high(cfg, mols, device, exact_E)
    serve_large_system(cfg, device)

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

    log(f"== 10. the bench (gemnet_pytorch_tpu_torch.bench --profile: bf16 headline, fp32 A/B, "
        f"bench-small and bench-large) [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_bench_") as workdir:
        bench_census, bench_out = run_bench(workdir)

    log(f"== 11. CUDA graphs: capacity plans, the captured train steps (fp32, bf16, 'high'), "
        f"{STEPS_PER_CALL} steps per call, the captured predict, MD [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_graphs_") as workdir:
        _cuda.reset_launches()
        graph_census, graph_timing = graphs_phase(cfg, mols, device, workdir)

    log(f"== 12. the rest of training: MVE (fp32, bf16, 'high'), the per-tensor optimizer and "
        f"AGC, the captured eval, scale fitting [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_rest_") as workdir:
        _cuda.reset_launches()
        rest_timing = rest_phase(cfg, mols, device, workdir)
        torch.cuda.synchronize()
        rest_census = dict(_cuda.LAUNCHES)

    log(f"== 13. the rest of the single-device stack: the native graph builder, the provider, "
        f"MD's host parts, load_pretrained and the examples, remat_blocks, "
        f"bilinear_implementation='xla' [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_stack_") as workdir:
        _cuda.reset_launches()
        stack_timing = stack_phase(cfg, mols, device, workdir,
                                   step_ms=graph_timing["float32"]["captured_ms"],
                                   fwd_ms=bench_out["fwd_ms_median"])
        torch.cuda.synchronize()
        stack_census = dict(_cuda.LAUNCHES)

    log(f"== 14. data parallelism and the halo edge partition: NCCL at world size 1 (captured "
        f"dp and halo steps), {PARALLEL_RANKS} gloo ranks sharing cuda:0 (dp, halo at both "
        f"bench batches) [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_parallel_") as workdir:
        t0 = time.perf_counter()
        _cuda.reset_launches()
        parallel_timing, rank_launches = parallel_phase(cfg, mols, device, workdir, power)
        torch.cuda.synchronize()
        parallel_census = collections.Counter(_cuda.LAUNCHES)
        parallel_census.update(rank_launches)
        log(f"  phase 14 in {time.perf_counter() - t0:.1f} s")

    log(f"== 15. the rest of the edge partition: ep (rung 2a) and the 2-D meshes (dp x ep, "
        f"dp x halo): NCCL at world size 1 (captured ep and 1x1 dp x halo steps), the ep "
        f"kernels, {PARALLEL_RANKS} and {HYBRID_MESH[0] * HYBRID_MESH[1]} gloo ranks sharing "
        f"cuda:0 [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_ep_") as workdir:
        t0 = time.perf_counter()
        ep_out = ep_hybrid_phase(cfg, mols, device, workdir, power)
        log(f"  phase 15 in {time.perf_counter() - t0:.1f} s")
    errors.update(ep_out["errors"])
    timings.update(ep_out["timings"])

    log(f"== 16. the pipeline (parallel/pp.py): NCCL at world size 1 (the captured PPTrainer "
        f"step, 1 stage), the kernels at a pp microbatch's shapes, {PP_RANKS} and {PP_WIDE} gloo "
        f"ranks sharing cuda:0 ({PP_RANKS} and {PP_WIDE} stages, dp x pp "
        f"{PP_MESH[0]}x{PP_MESH[1]}, train.run(pp={PP_RANKS})) [{power}]")
    with tempfile.TemporaryDirectory(prefix="gemnet_pp_") as workdir:
        t0 = time.perf_counter()
        pp_out = pp_phase(cfg, mols, device, workdir, power,
                          single_large=ep_out["large"]["single"])
        log(f"  phase 16 in {time.perf_counter() - t0:.1f} s")
    errors.update(pp_out["errors"])
    timings.update(pp_out["timings"])

    paths = {"serve": serve_census, "train_fp32": train_census["float32"],
             "train_bf16": train_census["bfloat16"], "serve_high": serve_high_census,
             "train_high": high_census, "probe": probe_census, "bench": bench_census,
             "graph": graph_census, "rest": rest_census, "stack": stack_census,
             "parallel": dict(parallel_census), "ep": dict(ep_out["launches"]),
             "pp": dict(pp_out["launches"])}
    # each row's own paths, where it must have launched (at the large
    # shapes only the bench's steps and phase 12's timed MVE steps run, in
    # fp32 and bf16: no path runs split3 there); "graph": the launches the
    # captured graphs of phase 11 hold; "rest": phase 12's launches (eager,
    # and those its captures recorded; a replay is counted at its capture);
    # "stack": phase 13's, counted as phase 12's; "parallel": phase 14's, this
    # process's and its gloo ranks'
    own = {"f32": ("serve", "train_fp32", "graph", "rest", "parallel"),
           "bf16": ("train_bf16", "graph", "rest", "parallel"),
           "split3": ("serve_high", "train_high", "graph", "rest")}
    own_large = {"f32": ("bench", "rest"), "bf16": ("bench", "rest"), "split3": ()}
    # at the halo shard's shapes: phase 14's gloo ranks; at the ep shard's:
    # phase 15's ep ranks (a step in fp32, a predict in bf16 and "high")
    own_halo = {"f32": ("parallel",)}
    own_ep = {"f32": ("ep",), "bf16": ("ep",), "split3": ("ep",)}
    # at a pp microbatch's shapes: phase 16's (a step in fp32, a predict in
    # bf16 and "high" on (c)'s ranks)
    own_pp = {"f32": ("pp",), "bf16": ("pp",), "split3": ("pp",)}
    cases += large + ep_out["cases"] + pp_out["cases"]
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
    log(f"== kernels on the serving, training, probe and bench paths [{power}]")
    log(f"  {'kernel':50s} " + " ".join(f"{p:>10s}" for p in paths)
        + f" {'ms':>8s} {'call ms':>8s} {'bound ms':>9s} {'plain ms':>9s} {'library ms':>10s}"
        + f" {'lib call':>9s}")
    for case, row in zip(cases, kernels):
        by_path = row["launches_by_path"]
        if case["kernel"] in ("P1", "P2"):
            must = ("probe",)
        else:
            must = (own_large if case["tag"].endswith("@large") else
                    own_halo if case["tag"].endswith("@halo") else
                    own_ep if case["tag"].endswith("@ep") else
                    own_pp if case["tag"].endswith("@pp") else own)[row["dtype"]]
        for p in must:
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
                    f"triplets+quads/s" for dt, t in train_timing.items())
        + f"; bench {bench_out['value']:.4e} agg/s (bf16 small), large "
        f"{bench_out['large_agg_per_s']:.4e}; captured "
        + "; ".join(f"{dt} step {graph_timing[dt]['captured_ms']:.3f} ms (eager "
                    f"{graph_timing[dt]['eager_ms']:.3f})" for dt in ("bfloat16", "float32"))
        + f"; request {graph_timing['request']['captured_ms']:.3f} ms (eager "
        f"{graph_timing['request']['eager_ms']:.3f}); MD {graph_timing['md']['md_ms_per_step']:.2f}"
        " ms/step; MVE captured "
        + "; ".join(f"{kind} {dt} {rest_timing[f'mve_{kind}_{dt}']['ms']:.3f} ms"
                    for kind in bench.KINDS for dt in ("bfloat16", "float32"))
        + "; fp32 small step " + ", ".join(
            f"{m} {t['ms']:.3f}" for m, t in rest_timing["optimizer"].items())
        + f" ms; eval {rest_timing['eval']['captured_ms']:.3f} ms (eager "
        f"{rest_timing['eval']['eager_ms']:.3f}); fitting {rest_timing['fit_s']:.1f} s; "
        + "graph build small / large ms numpy vs native " + ", ".join(
            f"{t['numpy']:.2f} / {t['native']:.2f}" for t in stack_timing["builders"].values())
        + "; provider batches/s numpy {numpy:.1f}, native {native:.1f}".format(
            **stack_timing["provider"])
        + "; MD ms/step numpy {:.2f}, native {:.2f}".format(
            *(stack_timing["md"][b]["ms_per_step"] for b in ("numpy", "native")))
        + "; bf16 step ms / peak MiB, plain vs remat: " + "; ".join(
            f"{kind} {stack_timing['remat'][f'{kind}_plain']['ms']:.3f} / "
            f"{stack_timing['remat'][f'{kind}_plain']['peak_mib']:.1f} vs "
            f"{stack_timing['remat'][f'{kind}_remat']['ms']:.3f} / "
            f"{stack_timing['remat'][f'{kind}_remat']['peak_mib']:.1f}" for kind in bench.KINDS)
        + "; captured dp (NCCL, world size 1) vs single step ms, deterministic algorithms: "
        + ", ".join(f"{dt} {parallel_timing['dp'][f'dp_{dt}']['ms']:.3f} vs "
                    f"{parallel_timing['dp'][f'single_{dt}']['ms']:.3f}"
                    for dt in ("float32", "bfloat16"))
        + "; halo over 2 gloo ranks on one card, bench-large eager step peak MiB a rank vs one "
        "device: " + ", ".join(
            f"{dt} {parallel_timing['large'][dt]['ranks'][0]['peak_mib']:.1f} vs "
            f"{parallel_timing['large'][dt]['single']['peak_mib']:.1f}"
            for dt in ("float32", "bfloat16"))
        + f"; ep over 2 gloo ranks, bench-large eager fp32 step peak MiB a rank "
        f"{ep_out['large']['ranks'][0]['peak_mib']:.1f} vs one device "
        f"{ep_out['large']['single']['peak_mib']:.1f}; an ep step's collectives "
        f"{ep_out['ep_collectives'][0]} ({sum(ep_out['ep_collectives'][1].values()) / 1e6:.2f} "
        f"MB); pp over 2 gloo ranks, bench-large eager fp32 step peak MiB a rank "
        f"{pp_out['large']['ranks'][0]['peak_mib']:.1f}; a pp step's collectives a rank "
        f"{pp_out['collectives'][0]} ({sum(pp_out['collectives'][1].values()) / 1e6:.2f} MB)")
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
