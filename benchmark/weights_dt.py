"""The weights of a `gemnet-dt-oc20` run, made from its seed as `weights.py`
makes the others': the schema of the GemNet-dT reference
(`reference.model_dt.GemNetDT`), every weight matrix N(0, 1/fan_in) and
the atom embeddings N(0, 1) in one `torch.randn` on the run's device, the
scaling factors 1."""

from __future__ import annotations

import math

import torch

from .reference.model_dt import GemNetDT


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    device = torch.device(device)
    with torch.device("meta"):
        schema = GemNetDT(cfg).state_dict()
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
        if k.endswith("scale_factor"):
            out[k].fill_(1.0)
    return out
