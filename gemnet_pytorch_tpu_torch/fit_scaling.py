"""Scaling-factor fitting entry point of the PyTorch port: the counterpart
of the repository's `fit_scaling.py` (reference fit_scaling.py).

    python -m gemnet_pytorch_tpu_torch.fit_scaling [--config config.yaml]
        [--n-batches 25] [--scale-file scaling_factors.json] [--dataset PATH]
        [--batch-size 32] [--overwrite-mode 1|2|other] [--device cuda|cpu]

It builds the model with direct_forces=True (faster, as the reference does,
fit_scaling.py:119) and weights drawn from `tfseed`, streams validation
batches, and fits every activation-variance scaling factor in creation
order (`training.fit_scaling.fit_scaling_factors`), writing
scaling_factors.json. An existing file is overwritten (`--overwrite-mode
1`), completed with the factors still at 1.0 (`2`), or left alone (any
other value: it exits). Without a dataset, a synthetic one of 256
molecules is made beside the scale file. It runs on the card unless
`--device cpu` is given.

`main(argv)` parses the flags; `run(config, ...)` fits from a flat config
dict, so a caller without PyYAML passes the dict itself.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import torch

from .config import ModelConfig, TrainConfig
from .data import DataContainer, DataProvider, make_dataset
from .models import GemNet
from .models.scaling import load_scales_from_json
from .training.fit_scaling import fit_scaling_factors


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.fit_scaling")
    p.add_argument("--config", default="config.yaml")
    p.add_argument("--n-batches", type=int, default=25)
    p.add_argument("--scale-file", default="scaling_factors.json")
    p.add_argument("--dataset", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--overwrite-mode", default="1",
                   help="1: overwrite the file; 2: fit only unfitted factors; else exit "
                   "(reference fit_scaling.py:81-92)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(levelname)s): %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    config = {}
    if os.path.exists(args.config):
        from .config import load_yaml_config

        config = load_yaml_config(args.config)
    return run(config, device=args.device, n_batches=args.n_batches,
               scale_file=args.scale_file, dataset=args.dataset, batch_size=args.batch_size,
               overwrite_mode=args.overwrite_mode)


def run(config: dict, *, device="cuda", n_batches: int = 25,
        scale_file: str = "scaling_factors.json", dataset: Optional[str] = None,
        batch_size: int = 32, overwrite_mode="1") -> Optional[dict]:
    """Fit the factors of the model a flat config dict describes, with
    direct forces; returns the fitted values by name, or None where an
    existing `scale_file` is to be left alone (`overwrite_mode` neither "1"
    nor "2")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                           "pass device='cpu' (--device cpu) to fit on the CPU")
    mcfg = ModelConfig.from_dict(dict(config, direct_forces=True))
    tcfg = TrainConfig.from_dict(config)

    skip_fitted = False
    if os.path.exists(scale_file):
        logging.info("Already found existing file: %s", scale_file)
        if str(overwrite_mode) == "1":
            logging.info("Selected: Overwrite the current file.")
        elif str(overwrite_mode) == "2":
            logging.info("Selected: Only fit unfitted variables.")
            skip_fitted = True
        else:
            logging.info("Selected: Exit script")
            return None

    dataset = dataset or tcfg.val_dataset
    if not dataset or not os.path.exists(dataset):
        dataset = os.path.join(os.path.dirname(os.path.abspath(scale_file)),
                               "fit_scaling_synthetic.npz")
        logging.warning("val dataset missing; generating synthetic data at %s", dataset)
        make_dataset(dataset, n_molecules=256, seed=tcfg.data_seed)
    container = DataContainer(dataset, cutoff=mcfg.cutoff, int_cutoff=mcfg.int_cutoff,
                              triplets_only=mcfg.triplets_only)
    provider = DataProvider(container, 0, min(n_batches * batch_size, len(container)),
                            batch_size, seed=tcfg.data_seed, shuffle=True, random_split=True)
    batch_iter = provider.get_dataset("val")
    try:
        model = GemNet(mcfg, generator=torch.Generator().manual_seed(tcfg.tfseed),
                       device=device)
        if skip_fitted:
            load_scales_from_json(model, scale_file)
        fitted = fit_scaling_factors(model, batch_iter, n_batches=n_batches,
                                     scale_file=scale_file, comment=tcfg.comment,
                                     skip_fitted=skip_fitted, overwrite_file=not skip_fitted)
    finally:
        batch_iter.close()  # stops the prefetch threads
    logging.info("Fitting done. Results saved to: %s", scale_file)
    return fitted


if __name__ == "__main__":
    main()
