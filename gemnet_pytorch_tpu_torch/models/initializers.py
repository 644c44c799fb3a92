"""Parameter initializers (reference gemnet/model/initializers.py), drawn
from an explicit `torch.Generator`.

Weights use the torch layouts of the reference: Dense kernels (out, in) with
fan_in = in, 3-D efficient weights (d0, d1, out) with fan_in = d0*d1. The
draws need not (and do not) reproduce the JAX package's random numbers.
"""

from __future__ import annotations

import math

import torch


def _standardize(kernel: torch.Tensor) -> torch.Tensor:
    eps = 1e-6
    axis = [0, 1] if kernel.ndim == 3 else 1  # the output dimension stays
    var, mean = torch.var_mean(kernel, dim=axis, unbiased=True, keepdim=True)
    return (kernel - mean) / torch.sqrt(var + eps)


@torch.no_grad()
def he_orthogonal_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Random (semi-)orthogonal matrix, standardized to zero mean and unit
    variance, scaled by sqrt(1/fan_in); in place."""
    torch.nn.init.orthogonal_(tensor, generator=generator)
    fan_in = tensor.shape[0] * tensor.shape[1] if tensor.ndim == 3 else tensor.shape[1]
    tensor.copy_(_standardize(tensor) * math.sqrt(1.0 / fan_in))
    return tensor


@torch.no_grad()
def atom_embedding_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform(-sqrt(3), sqrt(3)) (reference embedding_block.py:22-24); in place."""
    s = math.sqrt(3.0)
    return torch.nn.init.uniform_(tensor, -s, s, generator=generator)
