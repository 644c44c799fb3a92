"""Activation-variance scaling-factor fitting (port of
`gemnet_pytorch_tpu/training/fit_scaling.py`; reference
gemnet/model/layers/scaling.py:7-147 and fit_scaling.py).

The factors are fitted one at a time, in the reference's module-creation
order (`scale_names_in_creation_order`). For each, `n_batches` fresh
batches run through `energy_and_forces` with that factor's statistics on
(`models.scaling.collect_stats`); their [var_in·n, var_out·n, n] sum in
float64 on the host, and the factor becomes old · sqrt(var_in / var_out).
Each fitted value streams into the same `scaling_factors.json` schema as the
JAX package writes, after its `comment` key.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import numpy as np
import torch

from ..data.batch import to_torch
from ..models.gemnet import GemNet, energy_and_forces
from ..models.scaling import collect_stats, scale_names_in_creation_order, scaling_factors
from ..utils.jsonio import update_json, write_json


@torch.no_grad()
def factor_stats(model: GemNet, batches, name: str) -> np.ndarray:
    """[var_in·n, var_out·n, n] of the factor `name`, summed in float64 over
    `batches` (padded numpy batches) run through `energy_and_forces`."""
    device = next(model.parameters()).device
    with collect_stats(model, [name]) as stats:
        for batch in batches:
            energy_and_forces(model, to_torch(batch, device))
    if not stats[name]:
        raise ValueError(f"the factor {name} was not called")
    return torch.stack(stats[name]).cpu().numpy().astype(np.float64).sum(axis=0)


def fit_scaling_factors(
    model: GemNet,
    batch_iter: Iterator[dict],
    n_batches: int = 25,
    scale_file: Optional[str] = None,
    comment: str = "GemNet",
    skip_fitted: bool = False,
    overwrite_file: bool = True,
) -> dict[str, float]:
    """Fit every scaling factor of `model` in place; returns the fitted
    values by name. `batch_iter` yields padded numpy batches (a
    DataProvider's iterator).

    skip_fitted: fit only the factors still at 1.0 (reference
    overwrite_mode=2, fit_scaling.py:81-92). overwrite_file: start the json
    anew, holding only `comment`, before fitting."""
    factors = scaling_factors(model)
    if scale_file and overwrite_file:
        write_json(scale_file, {"comment": comment})
    fitted = {}
    for name in scale_names_in_creation_order(model.cfg):
        old = float(factors[name].scale_factor)
        if skip_fitted and abs(old - 1.0) > 1e-12:
            logging.info("skip already-fitted %s", name)
            continue
        var_in, var_out, n = factor_stats(model, (next(batch_iter) for _ in range(n_batches)),
                                          name)
        if var_in == 0:
            raise ValueError(f"did not track variable {name}")
        ratio = var_out / var_in
        new = float(old * np.sqrt(1.0 / ratio).astype(np.float32))
        logging.info("%s: Var_in=%.3f Var_out=%.3f ratio=%.3f -> scale=%.3f",
                     name, var_in / n, var_out / n, ratio, new)
        factors[name].scale_factor.fill_(new)
        fitted[name] = new
        if scale_file:
            update_json(scale_file, {name: new})
    return fitted
