"""Scaling-factor bookkeeping: global names and JSON loading (port of
`gemnet_pytorch_tpu/models/scaling.py`).

Each `layers.ScalingFactor` holds its factor in a `scale_factor` buffer
(the reference state-dict schema) and carries its global name
(`TripInteraction_1_had_rbf`, ...), the key of `scaling_factors.json`.
`collect_stats` turns on the statistics `training.fit_scaling` fits the
factors from (the JAX package's `scale_stats` collection); outside it a
factor is one multiply.
"""

from __future__ import annotations

import contextlib
import json
from typing import Iterable, Optional

from torch import nn

from ..config import ModelConfig
from .layers import ScalingFactor


def scale_names_in_creation_order(cfg: ModelConfig) -> list[str]:
    """Global names in reference module creation order
    (gemnet.py:220-256; interaction_block.py:84-138; atom_update_block.py:41,133-141)."""
    names: list[str] = []
    for i in range(1, cfg.num_blocks + 1):
        if not cfg.triplets_only:
            names += [
                f"QuadInteraction_{i}_had_rbf",
                f"QuadInteraction_{i}_had_cbf",
                f"QuadInteraction_{i}_sum_sbf",
            ]
        names += [
            f"TripInteraction_{i}_had_rbf",
            f"TripInteraction_{i}_sum_cbf",
            f"AtomUpdate_{i}_sum",
        ]
    for j in range(cfg.num_blocks + 1):
        names.append(f"OutBlock_{j}_sum")
        if cfg.direct_forces:
            names.append(f"OutBlock_{j}_had")
    return names


def scaling_factors(model: nn.Module) -> dict[str, ScalingFactor]:
    """The model's scaling-factor modules, by global name."""
    return {m.scale_name: m for m in model.modules() if isinstance(m, ScalingFactor)}


def load_scales_from_json(model: nn.Module, scale_file: str) -> None:
    """Set every factor named in a scaling_factors.json (in place)."""
    if not scale_file.endswith(".json"):
        raise ValueError(f"{scale_file} is not a json path")
    with open(scale_file) as f:
        content = json.load(f)
    for name, module in scaling_factors(model).items():
        if name in content:
            module.scale_factor.fill_(float(content[name]))


@contextlib.contextmanager
def collect_stats(model: nn.Module, names: Optional[Iterable[str]] = None):
    """Inside the block, every call of the named factors (all, where `names`
    is None) appends its [var_in·n, var_out·n, n] to the list this yields
    under the factor's name; the statistics are off again after it."""
    factors = scaling_factors(model)
    chosen = list(factors) if names is None else list(names)
    missing = [name for name in chosen if name not in factors]
    if missing:
        raise KeyError(f"the model has no scaling factor {missing}")
    stats = {name: [] for name in chosen}
    try:
        for name in chosen:
            factors[name].stats = stats[name]
        yield stats
    finally:
        for name in chosen:
            factors[name].stats = None
