"""The weights of a run, made from its seed on the run's device in one draw.

The schema is the reference's (`reference.model.GemNet`): one state dict
that loads into the reference and into the program under test alike. Every
weight matrix is drawn N(0, 1/fan_in) (fan_in: a Dense weight's input
width, a 3-D weight's first two sizes), the atom embeddings N(0, 1); the
Bessel frequencies are their initial values pi * n and the scaling factors
1. All of it is one `torch.randn` of every element on a generator of the
device, scaled per element: a few large calls, not one per leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.model import GemNet


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    device = torch.device(device)
    with torch.device("meta"):
        schema = GemNet(cfg).state_dict()
    names = list(schema)
    numels = [schema[k].numel() for k in names]
    std = []
    for k in names:
        shape = schema[k].shape
        if k.endswith("embeddings.weight"):
            std.append(1.0)
        elif len(shape) >= 2:
            fan_in = shape[1] if len(shape) == 2 else shape[0] * shape[1]
            std.append(math.sqrt(1.0 / fan_in))
        else:
            std.append(0.0)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    flat *= torch.repeat_interleave(torch.tensor(std, device=device),
                                    torch.tensor(numels, device=device))
    out, off = {}, 0
    for k, n in zip(names, numels):
        out[k] = flat[off:off + n].view(schema[k].shape)
        off += n
        if k.endswith("frequencies"):
            out[k].copy_(torch.tensor(np.pi * np.arange(1, n + 1), dtype=torch.float32))
        elif k.endswith("scale_factor"):
            out[k].fill_(1.0)
    return out


def scale_heads(sd: dict, alpha: float) -> None:
    """Scale every energy head by `alpha`, in place: E and -dE/dR are linear
    in the heads together, so they scale by `alpha`."""
    for k, v in sd.items():
        if k.endswith("out_energy.weight"):
            v.mul_(alpha)
