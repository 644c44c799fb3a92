"""The variant sweep (port of the repository's `scripts/sweep.py`, which
stands in for the reference's Sacred/SEML grid, config_seml.yaml:80-92:
triplets_only x direct_forces): train each of GemNet-dT, -T, -dQ and -Q in
turn with `train.run`, its overrides on top of the config, and write one
JSON report of each run's best validation metrics.

    python -m gemnet_pytorch_tpu_torch.scripts.sweep [--config config.yaml]
        [--num-steps N] [--evaluation-interval N] [--batch-size B]
        [--logdir logs/sweep] [--out sweep_results.json] [--device cuda|cpu]

The flags are the repository's sweep's, with `--device` (the card unless
`cpu` is given) in place of its JAX platform; `--config` is read where the
file is present (PyYAML), else the defaults (config.yaml's values) hold.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

GRID = [
    {"triplets_only": True, "direct_forces": True, "comment": "GemNet-dT"},
    {"triplets_only": True, "direct_forces": False, "comment": "GemNet-T"},
    {"triplets_only": False, "direct_forces": True, "comment": "GemNet-dQ"},
    {"triplets_only": False, "direct_forces": False, "comment": "GemNet-Q"},
]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gemnet_pytorch_tpu_torch.scripts.sweep")
    p.add_argument("--config", default="config.yaml")
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--evaluation-interval", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--logdir", default="logs/sweep")
    p.add_argument("--out", default="sweep_results.json")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def variant_configs(args: argparse.Namespace) -> dict:
    """{variant: the config dict `train.run` trains it from}: the config
    file's, the variant's overrides, then the flags (the repository's
    sweep passes these as train.py flags, which apply after the
    overrides)."""
    base = {}
    if os.path.exists(args.config):
        from ..config import load_yaml_config

        base = load_yaml_config(args.config)
    out = {}
    for overrides in GRID:
        name = overrides["comment"]
        out[name] = dict(base, **overrides, num_steps=args.num_steps,
                         evaluation_interval=args.evaluation_interval,
                         save_interval=10 * args.num_steps, batch_size=args.batch_size,
                         logdir=os.path.join(args.logdir, name))
    return out


def main(argv=None) -> dict:
    from .. import train

    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s (%(levelname)s): %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    results = {}
    for name, config in variant_configs(args).items():
        print(f"=== {name} ===", flush=True)
        results[name] = train.run(config, device=args.device)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
