"""Training driver of the PyTorch port: the single-device path of the
repository's `train.py` (reference train_seml.py:42-387).

    python -m gemnet_pytorch_tpu_torch.train [--config config.yaml] [--num-steps N]
        [--dataset PATH] [--batch-size B] [--evaluation-interval N]
        [--save-interval N] [--logdir DIR] [--restart RUN_DIR]
        [--synthetic-molecules N] [--export-torch OUT.pth] [--steps-per-call K]
        [--device cuda|cpu]

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

Not ported, and refused: the parallel modes (`--dp`, `--ep`, `--halo`,
`--dp-halo`, `--pp`, `--tp`, `--coordinator`) and the
`GEMNET_SWEEP_OVERRIDES` environment variable (a caller passes its
overrides in `run`'s config dict instead).
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import string
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from .compat import save_reference_checkpoint
from .config import ModelConfig, TrainConfig
from .data import DataContainer, DataProvider, make_dataset
from .models import GemNet
from .models.scaling import load_scales_from_json
from .training import (
    BestMetrics, Metrics, PlateauState, Trainer, make_writer, restore_checkpoint,
    save_checkpoint, save_params,
)

# flags of the repository's train.py this driver refuses, with their "unset" value
UNPORTED_FLAGS = {"dp": 0, "ep": 0, "halo": 0, "dp_halo": None, "pp": 0, "pp_micro": 0,
                  "tp": 0, "coordinator": None, "num_processes": None, "process_id": None}
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
    for flag, unset in UNPORTED_FLAGS.items():
        p.add_argument("--" + flag.replace("_", "-"), default=unset,
                       nargs=2 if flag == "dp_halo" else None,
                       type=None if flag == "coordinator" else int,
                       help="not ported (the repository's train.py runs it on the TPU)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    asked = [f"--{k.replace('_', '-')}" for k, unset in UNPORTED_FLAGS.items()
             if getattr(args, k) != unset]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the parallel modes are not ported to the PyTorch driver; it "
            "trains on one device")
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
    return run(config, device=args.device, synthetic_molecules=args.synthetic_molecules,
               export_torch=args.export_torch, steps_per_call=args.steps_per_call)


def chunk_steps(step: int, num_steps: int, steps_per_call: int, intervals, lr_changed: bool) -> int:
    """Steps of the next call (train.py:394-405): up to `steps_per_call` and
    the steps left, cut so that no chunk crosses a multiple of any of
    `intervals` (logging, checkpoints, evaluation), and 1 where the
    plateau's delayed lr (`lr_changed`) applies to one step alone."""
    k = min(steps_per_call, num_steps - step)
    for interval in intervals:
        k = min(k, interval - step % interval)
    return 1 if lr_changed else k


def run_directory(tcfg) -> str:
    """A new run directory under logdir, or the one to restart
    (train.py:158-184, reference train_seml.py:116-137)."""
    if tcfg.restart not in (None, "None"):
        return tcfg.restart
    uid = "".join(random.SystemRandom().choice(string.ascii_letters + string.digits)
                  for _ in range(6))
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    return os.path.join(tcfg.logdir,
                        f"{stamp}_{uid}_{os.path.basename(tcfg.dataset or 'synthetic')}_"
                        f"{tcfg.comment}")


def run(config: dict, *, device="cuda", synthetic_molecules: int = 512,
        export_torch: Optional[str] = None, steps_per_call: int = 1) -> dict:
    """Train from a flat config dict (config.yaml's keys; missing keys take
    the ModelConfig/TrainConfig defaults), up to `steps_per_call` steps per
    host call. Returns the best validation metrics as {f"{key}_best":
    value}, as the repository's train.py does."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call {steps_per_call} < 1")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to train on the CPU")
    mcfg = ModelConfig.from_dict(config)
    tcfg = TrainConfig.from_dict(config)
    np.random.seed(tcfg.data_seed)

    # ---- run directory ----
    directory = run_directory(tcfg)
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
        dataset = os.path.join(directory, "synthetic_train.npz")
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
    model = GemNet(mcfg, generator=torch.Generator().manual_seed(tcfg.tfseed), device=device)
    if mcfg.scale_file and os.path.exists(mcfg.scale_file):
        load_scales_from_json(model, mcfg.scale_file)
        logging.info("loaded scale factors from %s", mcfg.scale_file)
    logging.info("nParams: %d", sum(p.numel() for p in model.parameters()))
    trainer = Trainer(model, tcfg)
    state = trainer.init_state()
    plateau = PlateauState(factor=tcfg.decay_factor, patience=tcfg.decay_patience,
                           cooldown=tcfg.decay_cooldown)
    writer = make_writer(log_dir)
    train_metrics = Metrics("train", trainer.tracked_metrics)
    val_metrics = Metrics("val", trainer.tracked_metrics)
    best_metrics = BestMetrics(best_dir, val_metrics, assert_exist=False)

    # ---- restore (train.py:375-382) ----
    step_init = 0
    if os.path.exists(ckpt_path):
        state, plateau = restore_checkpoint(ckpt_path, state, plateau)
        best_metrics.restore()
        step_init = int(state.step)
        logging.info("restored checkpoint at step %d", step_init)
    else:
        best_metrics.initialize()

    # ---- loop (train.py:384-608, one device) ----
    train_iter = provider.get_dataset("train", transform=trainer.packer.pack)
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
            k = chunk_steps(step, tcfg.num_steps, steps_per_call,
                            (LOG_INTERVAL, tcfg.save_interval, tcfg.evaluation_interval),
                            lr_eff != plateau.lr_scale)
            step += k
            # metrics accumulate on the device, drained at eval intervals
            if k > 1:
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
                save_checkpoint(ckpt_path, state, plateau)
            if step % tcfg.evaluation_interval != 0:
                continue

            if t_start is not None and step > t_steps:
                sps = (time.perf_counter() - t_start) / (step - t_steps)
                writer.add_scalar("seconds_per_step", sps, step)
                logging.info("seconds_per_step=%.4f min_per_epoch=%.2f", sps,
                             sps * steps_per_epoch / 60)
            t_start, t_steps = None, step
            state = trainer.drain_metrics(state, train_metrics)
            # validation on the EMA weights (reference train_seml.py:345-356)
            for _ in range(n_val_batches):
                trainer.test_on_batch(state, next(val_iter), val_metrics, use_ema=True)
            if val_metrics.loss < best_metrics.loss:
                best_metrics.update(step, val_metrics)
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
    save_checkpoint(ckpt_path, state, plateau)
    if export_torch:
        with trainer.weights(state, use_ema=True):
            save_reference_checkpoint(export_torch, model, mcfg)
        logging.info("exported reference .pth to %s", export_torch)
    writer.close()
    logging.info("done; best: %s", dict(best_metrics.items()))
    return {f"{k}_best": v for k, v in best_metrics.items()}


if __name__ == "__main__":
    main()
