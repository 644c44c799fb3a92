"""Training driver of the PyTorch port: the repository's `train.py`
(reference train_seml.py:42-387) on one device, or data-parallel (`--dp
N`), halo edge-partitioned (`--halo N`), row-partitioned (`--ep N`,
deprecated) or pipelined (`--pp N`, N stages of the block stack) over N
processes, one a device, or data-parallel and halo at once (`--dp-halo DP
EP`, DP x EP processes).

    python -m gemnet_pytorch_tpu_torch.train [--config config.yaml] [--num-steps N]
        [--dataset PATH] [--batch-size B] [--evaluation-interval N]
        [--save-interval N] [--logdir DIR] [--restart RUN_DIR]
        [--synthetic-molecules N] [--export-torch OUT.pth] [--steps-per-call K]
        [--device cuda|cpu] [--dp N | --halo N | --ep N | --dp-halo DP EP |
         --pp N [--pp-micro M]] [--coordinator HOST:PORT --num-processes N --process-id I]

    python -m torch.distributed.run --nproc-per-node N \
        -m gemnet_pytorch_tpu_torch.train --dp N    # or --halo N, --ep N, --pp N
    python -m torch.distributed.run --nproc-per-node 4 \
        -m gemnet_pytorch_tpu_torch.train --dp-halo 2 2

It builds the model, data and Trainer from the flat config schema
(config.yaml), and runs the step loop with periodic checkpoints, validation
on the EMA weights, best-model tracking, plateau LR decay and early
stopping. It runs on the card unless `--device cpu` is given, and raises if
CUDA is asked for and absent. When the configured dataset is missing, a
synthetic COLL-like dataset is generated in the run directory.

The batches are packed into one buffer each in the provider's prefetch
threads (`Trainer.packer`), and each step is the Trainer's
`train_step_fn()`: a CUDA graph replay on the card. `--steps-per-call K`
runs up to K steps per host call (`Trainer.train_on_batches`), in chunks
cut as the repository's train.py cuts them (`chunk_steps`). Validation on
the EMA weights is the Trainer's captured eval step (`test_on_batch`).
Every mode of the Trainer comes from the config dict: `mve` with
`num_targets: 2`, `agc` and `agc_compat_reference`, and `flat_optimizer:
false` (the per-tensor optimizer).

`main(argv)` parses the flags into a config dict; `run(config, ...)` trains
from such a dict, so a caller without PyYAML (the card's machine) passes
the dict itself. `--config` is read only when given and present.

The parallel modes (train.py:46-48, :63-67, :87-116, :271-330): one
process per device, started by `python -m torch.distributed.run` or with the
coordinator flags (process 0's host:port, the process count, this
process's id); the process group's backend follows the device (NCCL on
the card, gloo on the CPU). `--dp N` (N = the world size, as train.py
asserts; `--coordinator` alone takes the world size) gives each rank one of
N batches drawn by every process alike, and runs the data-parallel step
(`parallel.dp`); `--halo N` partitions each batch over the N ranks in the
prefetch threads, with HaloPads estimated from sample batches, grown on an
outlier batch and agreed across the ranks before each step (`HaloBatches`),
and runs the halo step (`parallel.halo`). `--dp-halo DP EP` cuts the
group into DP rows of EP ranks (`parallel.make_hybrid_mesh`): each step
every process draws DP batches, each row halo-partitions its own, with the
pads agreed over the whole group, and runs the dp x halo step
(`parallel.hybrid`). `--ep N` (rung 2a, deprecated as in train.py) pads
and row-partitions each batch in the prefetch threads, with chunk sizes
the PadDims fix and the PadDims agreed across the ranks before each step,
and runs the ep step (`parallel.ep`). `--pp N` (train.py:73-81, :228-237)
builds rank s's `parallel.pp.PipelineStage` (the preamble and blocks s of
N) and trains it with `parallel.pp.PPTrainer` on `--pp-micro M`
microbatches a step (default 4N; one step is a single-device step on the
M batches together, one step per call): every rank draws the same M
batches, padded in the prefetch threads, and the ranks agree on the
PadDims of the step's M batches before it (`PPBatches`: every rank runs
the preamble of every microbatch). Validation runs on the same group,
except under `--ep` and `--pp`: the single-device eval on every rank,
rank 0's metrics broadcast (train.py's else branch; under `--pp` a
monolithic model on each rank holds the merged EMA weights,
`PPTrainer.merged_state_dict`). Only rank 0 writes the log, the
checkpoints, the best model and the export; the other ranks log to
sidecar directories and keep their plateau and early-stopping state in
lockstep. Every rank resumes from rank 0's checkpoint (under `--pp` it
holds every stage, gathered, and each rank takes its own at the same N).
`run(config, dp=N, group=...)` takes a group the caller made (a gloo group
on one card, as chip_smoke.py's phases 14 to 16 do).

Not ported yet, and refused: `--tp` (parallel/tp.py); and the
`GEMNET_SWEEP_OVERRIDES` environment variable (a caller passes its
overrides in `run`'s config dict instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import string
import threading
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from .compat import save_reference_checkpoint
from .config import ModelConfig, TrainConfig
from .data import DataContainer, DataProvider, make_dataset
from .data.padding import ROW_BLOCK, pad_batch, round_up, scale_graph_dims
from .models import GemNet
from .models.scaling import load_scales_from_json
from .parallel import ep as ep_mod
from .parallel import halo as halo_mod
from .parallel import hybrid, mesh
from .parallel import pp as pp_mod
from .training import (
    BestMetrics, Metrics, PlateauState, Trainer, make_writer, read_checkpoint,
    restore_checkpoint, save_checkpoint, save_params,
)

# flags of the repository's train.py this driver refuses, with their "unset"
# value and the module of the JAX package a later slice ports for them
UNPORTED_FLAGS = {"tp": (0, "parallel/tp.py")}
# the loop's 10-step logging boundary (train.py:397)
LOG_INTERVAL = 10
OVERRIDES = ("num_steps", "dataset", "batch_size", "logdir", "restart",
             "evaluation_interval", "save_interval")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.train")
    p.add_argument("--config", default=None, help="flat YAML config (config.yaml's schema)")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--evaluation-interval", type=int, default=None)
    p.add_argument("--save-interval", type=int, default=None)
    p.add_argument("--logdir", default=None)
    p.add_argument("--restart", default=None, help="run directory to resume")
    p.add_argument("--synthetic-molecules", type=int, default=512)
    p.add_argument("--export-torch", default=None,
                   help="after training, export the EMA weights as a reference-loadable "
                   ".pth state dict (compat.save_reference_checkpoint)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="up to K train steps per host call (Trainer.multi_step_fn)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel over N processes, one a device (parallel/dp.py)")
    p.add_argument("--halo", type=int, default=0,
                   help="halo edge-partitioned over N processes, one a device "
                   "(parallel/halo.py)")
    p.add_argument("--ep", type=int, default=0,
                   help="DEPRECATED (use --halo): row-partitioned (rung 2a) over N "
                   "processes, one a device (parallel/ep.py)")
    p.add_argument("--dp-halo", type=int, nargs=2, default=None, metavar=("DP", "EP"),
                   help="DP data-parallel rows, each halo-partitioned over EP processes "
                   "(parallel/hybrid.py)")
    p.add_argument("--pp", type=int, default=0,
                   help="pipeline over N processes, one a device: each holds 1/N of the "
                   "block stack (parallel/pp.py PPTrainer)")
    p.add_argument("--pp-micro", type=int, default=0,
                   help="microbatches a --pp step (default 4*pp; the bubble is "
                   "(N-1)/(M+N-1)); a step trains on pp_micro batches")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-process without torchrun)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    for flag, (unset, module) in UNPORTED_FLAGS.items():
        p.add_argument("--" + flag.replace("_", "-"), default=unset, type=int,
                       help=f"not ported yet ({module} of the JAX package)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    asked = [f"--{k.replace('_', '-')} ({module})" for k, (unset, module) in UNPORTED_FLAGS.items()
             if getattr(args, k) != unset]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: not ported to the PyTorch driver yet; a later slice brings "
            "it. --dp, --halo, --ep, --dp-halo and --pp run")
    if args.pp_micro and not args.pp:
        raise ValueError("--pp-micro is the microbatch count of --pp: pass --pp N with it")
    if os.environ.get("GEMNET_SWEEP_OVERRIDES"):
        raise NotImplementedError(
            "GEMNET_SWEEP_OVERRIDES is not read by the PyTorch driver: pass the overrides in "
            "run()'s config dict")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(levelname)s): %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    config = {}
    if args.config and os.path.exists(args.config):
        from .config import load_yaml_config

        config = load_yaml_config(args.config)
    for key in OVERRIDES:
        val = getattr(args, key)
        if val is not None:
            config[key] = val
    dp_halo = tuple(args.dp_halo) if args.dp_halo is not None else None
    modes = (args.dp, args.halo, args.ep, dp_halo, args.pp)
    if sum(bool(m) for m in modes) > 1:
        raise ValueError("pick one of --dp / --ep / --halo / --dp-halo / --pp")
    device, group = args.device, None
    if any(modes) or args.coordinator:
        group = mesh.initialize_distributed(args.coordinator, args.num_processes,
                                            args.process_id, device=args.device)
        device = mesh.local_device(args.device)
        if not any(modes):
            args.dp = mesh.world_size(group)  # train.py:108-113
    try:
        best = run(config, device=device, synthetic_molecules=args.synthetic_molecules,
                   export_torch=args.export_torch, steps_per_call=args.steps_per_call,
                   dp=args.dp, halo=args.halo, ep=args.ep, dp_halo=dp_halo, pp=args.pp,
                   pp_micro=args.pp_micro, group=group)
        if group is not None:
            torch.distributed.barrier(group)  # rank 0's checkpoint is written
        return best
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()


def chunk_steps(step: int, num_steps: int, steps_per_call: int, intervals, lr_changed: bool) -> int:
    """Steps of the next call (train.py:394-405): up to `steps_per_call` and
    the steps left, cut so that no chunk crosses a multiple of any of
    `intervals` (logging, checkpoints, evaluation), and 1 where the
    plateau's delayed lr (`lr_changed`) applies to one step alone."""
    k = min(steps_per_call, num_steps - step)
    for interval in intervals:
        k = min(k, interval - step % interval)
    return 1 if lr_changed else k


def run_directory(tcfg, group=None) -> str:
    """A new run directory under logdir, or the one to restart
    (train.py:158-184, reference train_seml.py:116-137); over a process
    group every rank takes rank 0's."""
    if tcfg.restart not in (None, "None"):
        return tcfg.restart
    uid = "".join(random.SystemRandom().choice(string.ascii_letters + string.digits)
                  for _ in range(6))
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    name = [os.path.join(tcfg.logdir,
                         f"{stamp}_{uid}_{os.path.basename(tcfg.dataset or 'synthetic')}_"
                         f"{tcfg.comment}")]
    if group is not None:
        torch.distributed.broadcast_object_list(name, src=0, group=group)
    return name[0]


def run(config: dict, *, device="cuda", synthetic_molecules: int = 512,
        export_torch: Optional[str] = None, steps_per_call: int = 1, dp: int = 0,
        halo: int = 0, ep: int = 0, dp_halo: Optional[tuple] = None, pp: int = 0,
        pp_micro: int = 0, group=None) -> dict:
    """Train from a flat config dict (config.yaml's keys; missing keys take
    the ModelConfig/TrainConfig defaults), up to `steps_per_call` steps per
    host call (one device), or over `group` in one parallel mode:
    data-parallel (`dp`), halo-partitioned (`halo`), row-partitioned (`ep`,
    rung 2a) or pipelined (`pp` stages, `pp_micro` microbatches a step,
    default 4*pp) over that many processes, or `dp_halo=(n_dp, n_ep)`, n_dp
    data-parallel rows each halo-partitioned over n_ep processes; the
    group's world size must be the mode's count. Returns the best
    validation metrics as {f"{key}_best": value}, as the repository's
    train.py does."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call {steps_per_call} < 1")
    modes = {"dp": dp, "halo": halo, "ep": ep, "dp_halo": dp_halo, "pp": pp}
    asked = [k for k, v in modes.items() if v]
    if len(asked) > 1:
        raise ValueError("pick one of dp / ep / halo / dp_halo / pp")
    if pp_micro and not pp:
        raise ValueError("pp_micro without pp")
    pp_micro = pp_micro or 4 * pp
    n_par = int(np.prod(dp_halo)) if dp_halo else dp or halo or ep or pp
    if n_par:
        if group is None:
            raise ValueError(f"{asked[0]} runs over a process group: pass the one "
                             "parallel.initialize_distributed returned")
        if mesh.world_size(group) != n_par:
            raise ValueError(f"{asked[0]}={modes[asked[0]]} needs a group of {n_par} "
                             f"processes, this one has {mesh.world_size(group)}")
    elif group is not None:
        raise ValueError("a process group without dp, ep, halo, dp_halo or pp")
    rank, is_main = (mesh.rank(group), mesh.is_main(group)) if n_par else (0, True)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to train on the CPU")
    mcfg = ModelConfig.from_dict(config)
    tcfg = TrainConfig.from_dict(config)
    np.random.seed(tcfg.data_seed)

    # ---- run directory ----
    directory = run_directory(tcfg, group if n_par else None)
    best_dir = os.path.join(directory, "best")
    log_dir = os.path.join(directory, "logs")
    for d in (directory, best_dir, log_dir):
        os.makedirs(d, exist_ok=True)
    logging.info("Directory: %s", directory)
    ckpt_path = os.path.join(log_dir, "checkpoint")
    best_path = os.path.join(best_dir, "model")

    # ---- data (train.py:186-207) ----
    dataset = tcfg.dataset
    if not dataset or not os.path.exists(dataset):
        # one file a process: the seeded content is the same, concurrent
        # writes to one path would race (train.py:188-193)
        dataset = os.path.join(directory, f"synthetic_train{f'_p{rank}' if n_par else ''}.npz")
        logging.warning("dataset missing; generating synthetic data at %s", dataset)
        make_dataset(dataset, n_molecules=synthetic_molecules, seed=tcfg.data_seed)
    container = DataContainer(dataset, cutoff=mcfg.cutoff, int_cutoff=mcfg.int_cutoff,
                              triplets_only=mcfg.triplets_only)
    num_train = tcfg.num_train or int(0.9 * len(container))
    num_val = tcfg.num_val or len(container) - num_train
    provider = DataProvider(container, num_train, num_val, tcfg.batch_size,
                            seed=tcfg.data_seed, shuffle=True, random_split=True)
    logging.info("pad dims: %s", provider.pad_dims)

    # ---- model/trainer (train.py:209-222) ----
    def new_model(cls=GemNet, **kw):
        m = cls(mcfg, generator=torch.Generator().manual_seed(tcfg.tfseed), device=device, **kw)
        if mcfg.scale_file and os.path.exists(mcfg.scale_file):
            load_scales_from_json(m, mcfg.scale_file)
            logging.info("loaded scale factors from %s", mcfg.scale_file)
        return m

    # --pp: this rank's stage, and a monolithic model for the eval, the
    # best model and the export, which holds the merged weights
    pp_trainer = eval_model = None
    model = new_model(pp_mod.PipelineStage, stage=rank, num_stages=pp) if pp else new_model()
    logging.info("nParams: %d", sum(p.numel() for p in model.parameters()))
    trainer = Trainer(model, tcfg)
    if pp:
        pp_trainer = pp_mod.PPTrainer(trainer, group, pp_micro)
        state = pp_trainer.init_state()
        eval_model = new_model()
        eval_trainer = Trainer(eval_model, tcfg)
        logging.info("pipeline over %d stages, %d microbatches; rank %d holds blocks %d-%d",
                     pp, pp_micro, rank, model.start, model.stop - 1)
    else:
        state = trainer.init_state()
    plateau = PlateauState(factor=tcfg.decay_factor, patience=tcfg.decay_patience,
                           cooldown=tcfg.decay_cooldown)
    # the other ranks log to sidecar directories: they compute the same
    # metrics (the plateau and early stopping stay in lockstep), rank 0's
    # are the record (train.py:353-366)
    writer = make_writer(log_dir if is_main else os.path.join(directory, f"logs_p{rank}"))
    train_metrics = Metrics("train", trainer.tracked_metrics)
    val_metrics = Metrics("val", trainer.tracked_metrics)
    best_state_dir = best_dir if is_main else os.path.join(directory, f"best_p{rank}")
    os.makedirs(best_state_dir, exist_ok=True)
    best_metrics = BestMetrics(best_state_dir, val_metrics, assert_exist=False)

    # ---- restore (train.py:375-382) ----
    step_init = 0
    if os.path.exists(ckpt_path):
        if pp:  # every stage's rows: this rank takes its own
            state = pp_trainer.load_checkpoint_tensors(read_checkpoint(ckpt_path, plateau), state)
        else:
            state, plateau = restore_checkpoint(ckpt_path, state, plateau)
        best_metrics.restore()
        step_init = int(state.step)
        logging.info("restored checkpoint at step %d", step_init)
    else:
        best_metrics.initialize()

    # ---- the step of each mode (train.py:230-345) ----
    step_fn, val_iter = None, None
    if dp:
        from .parallel import dp as dp_mod

        train_iter = provider.get_dataset("train", transform=trainer.packer.pack)
        step_fn = dp_mod.make_dp_train_step(trainer, group)
        val_step = dp_mod.make_dp_eval_step(trainer, group)
        logging.info("data parallel over %d processes, rank %d", dp, rank)
    elif halo or dp_halo:
        train_iter, val_iter, step_fn, val_step = _halo_mode(
            trainer, provider, container, mcfg, tcfg, group, dp_halo)
    elif ep:
        train_iter, val_iter, step_fn, val_step = _ep_mode(
            trainer, provider, mcfg, group)
    elif pp:
        batches = PPBatches(trainer, group, provider.pad_dims, mcfg.triplets_only)
        train_iter = provider.get_dataset("train", raw_transform=batches.partition)
        val_iter = provider.get_dataset("val", transform=eval_trainer.packer.pack)
        pp_step = pp_trainer.train_step_fn()
        step_fn = lambda state, items, lr: pp_step(state, batches.rows(items), lr)[0]  # noqa: E731
        eval_fn = eval_trainer.eval_step_fn()

        def val_step(state, row, use_ema=True):
            m, c = eval_fn(None, row)
            return halo_mod.broadcast_metrics(m, group), c
    else:
        train_iter = provider.get_dataset("train", transform=trainer.packer.pack)
    if val_iter is None:
        val_iter = provider.get_dataset("val", transform=trainer.packer.pack)
    try:
        steps_per_epoch = int(np.ceil(num_train / tcfg.batch_size))
        n_val_batches = int(np.ceil(num_val / tcfg.batch_size))
        t_start, t_steps = None, 0
        step = step_init
        # torch scheduler mechanics (reference ReduceLROnPlateau mutates base_lrs
        # after the current step's scheduler.step() already computed the next
        # step's lr, trainer.py:658-668): a plateau reduce at the eval following
        # step s takes effect at step s+2. lr_eff is snapshotted before each eval
        # to reproduce that (train.py:388-393).
        lr_eff = plateau.lr_scale
        while step < tcfg.num_steps:
            k = chunk_steps(step, tcfg.num_steps, 1 if n_par else steps_per_call,
                            (LOG_INTERVAL, tcfg.save_interval, tcfg.evaluation_interval),
                            lr_eff != plateau.lr_scale)
            step += k
            # metrics accumulate on the device, drained at eval intervals
            if dp:
                # every process draws the same dp batches and steps on its own
                state, _, _ = step_fn(state, [next(train_iter) for _ in range(dp)][rank], lr_eff)
            elif dp_halo:  # a batch for each dp row
                state, _ = step_fn(state, [next(train_iter) for _ in range(dp_halo[0])], lr_eff)
            elif halo or ep:
                state, _ = step_fn(state, next(train_iter), lr_eff)
            elif pp:  # every rank draws the same M microbatches
                state = step_fn(state, [next(train_iter) for _ in range(pp_micro)], lr_eff)
            elif k > 1:
                state, _ = trainer.train_on_batches(state, [next(train_iter) for _ in range(k)],
                                                    lr_eff)
            else:
                state, _ = trainer.train_on_batch(state, next(train_iter), lr_eff)
            # snapshot before any plateau.step below (train.py:472-474)
            lr_eff = plateau.lr_scale
            if t_start is None and step >= step_init + 2:
                t_start, t_steps = time.perf_counter(), step  # skip the first steps

            if step % LOG_INTERVAL == 0:
                writer.add_scalar("lr_scale", plateau.lr_scale, step)
            if step % tcfg.save_interval == 0:
                _checkpoint(ckpt_path, state, plateau, is_main, pp_trainer)
            if step % tcfg.evaluation_interval != 0:
                continue

            if t_start is not None and step > t_steps:
                sps = (time.perf_counter() - t_start) / (step - t_steps)
                writer.add_scalar("seconds_per_step", sps, step)
                logging.info("seconds_per_step=%.4f min_per_epoch=%.2f", sps,
                             sps * steps_per_epoch / 60)
            t_start, t_steps = None, step
            state = trainer.drain_metrics(state, train_metrics)
            # validation on the EMA weights (reference train_seml.py:345-356),
            # over the same group in the parallel modes
            if dp:
                _dp_validation(trainer, state, val_step, val_iter, val_metrics, n_val_batches,
                               dp, rank)
            elif dp_halo:
                _dp_halo_validation(trainer, state, val_step, val_iter, val_metrics,
                                    n_val_batches, dp_halo[0])
            elif halo or ep or pp:
                if pp:  # the merged EMA weights into every rank's monolithic model
                    eval_model.load_state_dict(pp_trainer.merged_state_dict(state, ema=True))
                for _ in range(n_val_batches):
                    m, c = val_step(state, next(val_iter), use_ema=True)
                    trainer._update_metrics(val_metrics, m, c)
            else:
                for _ in range(n_val_batches):
                    trainer.test_on_batch(state, next(val_iter), val_metrics, use_ema=True)
            if val_metrics.loss < best_metrics.loss:
                best_metrics.update(step, val_metrics)
                if is_main and pp:
                    save_params(best_path, eval_model)
                elif is_main:
                    with trainer.weights(state, use_ema=True):
                        save_params(best_path, trainer.model)
            best_metrics.write(writer, step)
            logging.info("%d/%d (epoch %d): %s", step, tcfg.num_steps, step // steps_per_epoch,
                         "; ".join(f"{k}: train={train_metrics.result(False)[k]:.6f}, "
                                   f"val={val_metrics.result(False)[k]:.6f}"
                                   for k in val_metrics.keys))
            plateau.step(val_metrics.loss)
            train_metrics.write(writer, step)
            val_metrics.write(writer, step)
            train_metrics.reset_states()
            val_metrics.reset_states()
            if step - best_metrics.step > tcfg.patience * tcfg.evaluation_interval:
                logging.info("early stopping at step %d", step)
                break
    finally:
        train_iter.close()  # stops the prefetch threads
        val_iter.close()

    # ---- final checkpoint and export (train.py:610-623) ----
    _checkpoint(ckpt_path, state, plateau, is_main, pp_trainer)
    if export_torch and pp:  # the merged EMA weights (collective)
        eval_model.load_state_dict(pp_trainer.merged_state_dict(state, ema=True))
    if is_main and export_torch:
        if pp:
            save_reference_checkpoint(export_torch, eval_model, mcfg)
        else:
            with trainer.weights(state, use_ema=True):
                save_reference_checkpoint(export_torch, model, mcfg)
        logging.info("exported reference .pth to %s", export_torch)
    writer.close()
    logging.info("done; best: %s", dict(best_metrics.items()))
    return {f"{k}_best": v for k, v in best_metrics.items()}


def _checkpoint(path: str, state, plateau, is_main: bool, pp_trainer=None) -> None:
    """Rank 0 writes the checkpoint; under --pp every rank first sends its
    stage's rows to it (`PPTrainer.checkpoint_tensors`, collective)."""
    if pp_trainer is not None:
        state = pp_trainer.checkpoint_tensors(state)
    if is_main:
        save_checkpoint(path, state, plateau)


def _dp_validation(trainer, state, val_step, val_iter, val_metrics, n_batches: int, dp: int,
                   rank: int) -> None:
    """The data-parallel EMA validation (train.py:514-536): dp batches a
    call, the remainder group padded with `zero_masks` rows, which add
    nothing to any num/den pair."""
    done = 0
    while done < n_batches:
        take = min(dp, n_batches - done)
        rows = [next(val_iter) for _ in range(take)]
        done += take
        rows += [trainer.packer.zero_masks(rows[0])] * (dp - take)
        m, c = val_step(state, rows[rank], use_ema=True)
        trainer._update_metrics(val_metrics, m, c)


def _dp_halo_validation(trainer, state, val_step, val_iter, val_metrics, n_batches: int,
                        n_dp: int) -> None:
    """The dp x halo EMA validation (train.py:541-570): a batch for each dp
    row a call; the rows of the last call past the batches left take a
    copy of the first row's with its mol and atom masks zeroed
    (`val_step` takes the call's batches and does so)."""
    done = 0
    while done < n_batches:
        take = min(n_dp, n_batches - done)
        done += take
        m, c = val_step(state, [next(val_iter) for _ in range(take)], use_ema=True)
        trainer._update_metrics(val_metrics, m, c)


class HaloBatches:
    """--halo's and --dp-halo's batches (train.py:286-330). `partition(g, Z,
    R, E, F)` runs in the provider's threads: it builds the batch's halo
    partition at the current pads, grown (headroom 1.25) and built again
    where an outlier batch outgrows them. `row(items, which)` runs on the
    main thread before each step and eval batch, on the items of that step
    (one batch, or one for each dp row): the ranks of `group` agree on pads
    that cover them all (`halo.agree_halo_pads`), a rank whose item `which`
    is behind the agreed pads builds it again at them, and the rank's shard
    of it is packed. The agreement is needed because each rank grows its
    pads in its own threads, in whatever order they reach the batches: the
    same batch may meet old pads on one rank and grown pads on another. A
    partition built at old pads is built again where the JAX driver drops
    it and draws another batch (its train.py:449-458): every rank keeps the
    same batches."""

    def __init__(self, trainer, group, pads, triplets_only: bool, shard: Optional[int] = None,
                 n_shards: Optional[int] = None):
        self._trainer, self._group = trainer, group
        self._shard = mesh.rank(group) if shard is None else shard
        self._n_shards = mesh.world_size(group) if n_shards is None else n_shards
        self._triplets_only = triplets_only
        self.pads = pads
        self._lock = threading.Lock()

    def _build(self, raw, pads):
        g, Z, R, E, F = raw
        return halo_mod.build_halo_partition(g, Z, R, self._n_shards, E=E, F=F,
                                            triplets_only=self._triplets_only, pads=pads)

    def _grow(self, used, headroom: float = 1.0):
        with self._lock:
            self.pads = self.pads.grow_to(used, headroom=headroom)
            return self.pads

    def partition(self, g, Z, R, E, F):
        raw, pads = (g, Z, R, E, F), self.pads
        part = self._build(raw, pads)
        if not pads.covers(part["halo_pads"]):  # outlier: grow and build again
            pads = self._grow(part["halo_pads"], headroom=1.25)
            logging.info("halo pads grown: %s", pads)
            part = self._build(raw, pads)
        return raw, part

    def row(self, items, which: int = 0) -> np.ndarray:
        if not isinstance(items, list):
            items = [items]
        pads = items[0][1]["halo_pads"]
        for _, part in items[1:]:
            pads = pads.grow_to(part["halo_pads"])
        agreed = halo_mod.agree_halo_pads(pads, self._group)
        raw, part = items[which]
        if agreed != part["halo_pads"]:
            if agreed != pads:
                self._grow(agreed)
                logging.info("halo pads agreed across ranks: %s", agreed)
            part = self._build(raw, agreed)
            if part["halo_pads"] != agreed:
                raise RuntimeError(f"a partition built at {agreed} used {part['halo_pads']}")
        return self._trainer.packer.pack(halo_mod.local_halo_batch(part, self._shard))


def _halo_mode(trainer, provider, container, mcfg, tcfg, group, dp_halo=None):
    """(train iterator, val iterator, train step, eval step) of --halo
    (train.py:286-330) or --dp-halo: the partitioner replaces the padding
    and runs in the prefetch threads; HaloPads are estimated from 8 sample
    batches and grown on an outlier batch (the packer's layout then changes
    and the captured step captures again); before each step and eval batch
    the ranks (of the world, under --dp-halo) agree on the pads and each
    packs its own shard (`HaloBatches`). The validation partitions are built
    inline, so none is stale after a train batch grew the pads. Under
    --dp-halo each step takes a batch for each dp row (every rank draws the
    same ones) and the rank trains on its row's; an eval call past the
    batches left gives its rows a copy of the first batch with zeroed mol
    and atom masks (`BatchPacker.zero_masks`)."""
    n_dp, n_ep = dp_halo or (1, mesh.world_size(group))
    rng = np.random.RandomState(0)
    train_idx = provider.idx["train"]
    samples = (container.build(rng.choice(train_idx, size=min(tcfg.batch_size, len(train_idx)),
                                          replace=False)) for _ in range(8))
    pads = halo_mod.estimate_halo_pads(samples, n_ep, triplets_only=mcfg.triplets_only,
                                       headroom=1.25, n_mol=tcfg.batch_size)
    logging.info("halo pads: %s", pads)
    if dp_halo:
        hmesh = mesh.make_hybrid_mesh(n_dp, n_ep, group)
        batches = HaloBatches(trainer, group, pads, mcfg.triplets_only, shard=hmesh.ep_index,
                              n_shards=n_ep)
        train_step = hybrid.make_dp_halo_train_step(trainer, hmesh)
        eval_step = hybrid.make_dp_halo_eval_step(trainer, hmesh)
        me = hmesh.dp_index
        logging.info("dp%d x halo%d, rank %d at (%d, %d)", n_dp, n_ep, mesh.rank(group),
                     hmesh.dp_index, hmesh.ep_index)
    else:
        batches = HaloBatches(trainer, group, pads, mcfg.triplets_only)
        train_step = halo_mod.make_halo_train_step(trainer, group)
        eval_step = halo_mod.make_halo_eval_step(trainer, group)
        me = 0
        logging.info("halo-partitioned over %d processes, rank %d", n_ep, mesh.rank(group))
    train_iter = provider.get_dataset("train", raw_transform=batches.partition)
    val_iter = provider.get_dataset("val", raw_transform=batches.partition, prefetch_workers=0)

    def eval_row(items):
        if not isinstance(items, list):
            return batches.row(items)
        row = batches.row(items, me if me < len(items) else 0)
        return row if me < len(items) else trainer.packer.zero_masks(row)

    return (train_iter, val_iter,
            lambda state, items, lr_scale: train_step(state, batches.row(items, me), lr_scale),
            lambda state, items, use_ema=False: eval_step(state, eval_row(items), use_ema))


class EpBatches:
    """--ep's batches (train.py:248-269). `partition(g, Z, R, E, F)` runs in
    the provider's threads: it pads the batch to the current PadDims (grown
    with headroom 1.25 where an outlier batch outgrows them, as the
    provider grows its own) and partitions it over the ranks with the chunk
    sizes those dims fix (`ep.partition_batch`). `row(item)` runs on the
    main thread before each step: the ranks agree on the dims
    (`mesh.agree_max`: the psums of the bilinear outputs are (nEdges,
    units) on every rank, and an outlier may grow one rank's dims in its
    threads before its peers'), a rank behind them pads and partitions the
    batch again, and the rank's shard is packed."""

    def __init__(self, trainer, group, dims, triplets_only: bool):
        self._trainer, self._group = trainer, group
        self._rank, self._n_shards = mesh.rank(group), mesh.world_size(group)
        self._triplets_only = triplets_only
        self.dims = dims
        self._lock = threading.Lock()

    def _build(self, raw, dims):
        g, Z, R, E, F = raw
        batch = pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=self._triplets_only)
        # fixed chunks keep one shape (one capture) across batches
        trip = round_up(-(-dims.n_triplets // self._n_shards), ROW_BLOCK)
        quad = (None if self._triplets_only
                else round_up(-(-dims.n_quads // self._n_shards), ROW_BLOCK))
        return ep_mod.partition_batch(batch, self._n_shards, trip_chunk=trip, quad_chunk=quad)

    def partition(self, g, Z, R, E, F):
        n_mol, n_atoms = int(g.batch_seg.max()) + 1, len(Z)
        with self._lock:
            if not self.dims.fits(g, n_mol, n_atoms):  # outlier: grow
                self.dims = self.dims.grow_to(scale_graph_dims(g, 1.25), n_mol,
                                              int(n_atoms * 1.25))
                logging.info("pad dims grown: %s", self.dims)
            dims = self.dims
        raw = (g, Z, R, E, F)
        return raw, dims, self._build(raw, dims)

    def row(self, item) -> np.ndarray:
        raw, dims, part = item
        agreed = mesh.agree_max(dims, self._group)
        if agreed != dims:
            with self._lock:  # the threads' dims may have grown meanwhile
                self.dims = _dims_max(self.dims, agreed)
            logging.info("pad dims agreed across ranks: %s", agreed)
            part = self._build(raw, agreed)
        return self._trainer.packer.pack(ep_mod.local_ep_batch(part, self._rank))


def _ep_mode(trainer, provider, mcfg, group):
    """(train iterator, val iterator, train step, eval step) of --ep
    (train.py:248-269, deprecated there for --halo): the row partitioner
    runs in the prefetch threads (`EpBatches`) and each rank trains on its
    shard; the validation is the single-device eval of the EMA weights on
    every rank (train.py's else branch), eager (a second layout would make
    the trainer's one packer capture again after every eval), its metrics
    rank 0's, broadcast: they drive the run's decisions, which the ranks
    must take alike."""
    from .data import to_torch

    logging.warning(
        "--ep (rung 2a) is deprecated: it replicates the edge embeddings and all-reduces "
        "the bilinear outputs in every block; use --halo %d instead", mesh.world_size(group))
    batches = EpBatches(trainer, group, provider.pad_dims, mcfg.triplets_only)
    train_iter = provider.get_dataset("train", raw_transform=batches.partition)
    val_iter = provider.get_dataset("val")
    train_step = ep_mod.make_ep_train_step(trainer, group)
    logging.info("row-partitioned (ep) over %d processes, rank %d", mesh.world_size(group),
                 mesh.rank(group))

    def eval_step(state, batch, use_ema=False):
        m, c = trainer.eval_step(state, to_torch(batch, trainer.device), use_ema)
        return halo_mod.broadcast_metrics(m, group), c

    return (train_iter, val_iter,
            lambda state, item, lr_scale: train_step(state, batches.row(item), lr_scale),
            eval_step)


class PPBatches(EpBatches):
    """--pp's batches. `partition(g, Z, R, E, F)` (EpBatches') pads each
    batch in the provider's threads at the current PadDims, grown (headroom
    1.25) where an outlier batch outgrows them. `rows(items)` runs on the
    main thread before each step, on its M microbatches: the ranks agree on
    PadDims that cover all M (`mesh.agree_max`: every rank runs the
    preamble of every microbatch, and the pipeline's states and psums have
    one shape), the microbatches behind them are padded again, and the M
    are packed into one (M, total) stack of one layout."""

    def _build(self, raw, dims):
        g, Z, R, E, F = raw
        return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=self._triplets_only)

    def rows(self, items) -> np.ndarray:
        dims = items[0][1]
        for _, d, _ in items[1:]:
            dims = _dims_max(dims, d)
        agreed = mesh.agree_max(dims, self._group)
        if agreed != self.dims:
            with self._lock:  # the threads' dims may have grown meanwhile
                self.dims = _dims_max(self.dims, agreed)
        if any(d != agreed for _, d, _ in items):
            logging.info("pad dims agreed across ranks: %s", agreed)
        batches = [b if d == agreed else self._build(raw, agreed) for raw, d, b in items]
        return np.stack([self._trainer.packer.pack(b) for b in batches])


def _dims_max(a, b):
    """The field-wise max of two PadDims."""
    return dataclasses.replace(a, **{f.name: max(getattr(a, f.name), getattr(b, f.name))
                                     for f in dataclasses.fields(a)})


if __name__ == "__main__":
    main()
