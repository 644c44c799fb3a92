"""Loading released GemNet configurations and checkpoints (port of
`gemnet_pytorch_tpu/pretrained.py`).

The reference ships per-checkpoint constructor kwargs
(pretrained/GemNet-{T,Q}/model_kwargs.json) and fitted scaling factors
(scaling_factors.json); weights come as torch .pth state dicts in the
reference schema, which is this package's own (less the reference's
aliases). `load_pretrained` builds the model from the kwargs, sets the
factors from the scale file and loads the weights strictly.

A JAX orbax checkpoint reaches this package through the JAX side's
`scripts/convert_checkpoint.py to-torch`, which writes such a .pth (the
parameters, not the optimizer state).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .compat import strip_reference_aliases
from .config import ModelConfig
from .models import GemNet
from .models.scaling import load_scales_from_json
from .utils.jsonio import read_json


def config_from_model_kwargs(path: str) -> ModelConfig:
    """A ModelConfig from a reference model_kwargs.json."""
    return ModelConfig.from_dict(read_json(path))


def find_scale_file(directory: str) -> Optional[str]:
    """The scaling_factors.json beside the kwargs, else the one in the
    parent directory (the reference's global file), else None
    (pretrained.py:53-62)."""
    for cand in (os.path.join(directory, "scaling_factors.json"),
                 os.path.join(os.path.dirname(directory), "scaling_factors.json")):
        if os.path.exists(cand):
            return cand
    return None


def load_pretrained(directory: str, weights_path: Optional[str] = None,
                    scale_file: Optional[str] = None, seed: int = 0,
                    device="cuda") -> GemNet:
    """The GemNet of a reference pretrained directory, on `device`.

    directory: holds model_kwargs.json (reference pretrained/GemNet-Q).
    weights_path: a torch .pth state dict in the reference schema (its
      "model" entry where it has one), loaded with strict=True after the
      scale file, so its factors win where it holds them, as in the JAX
      package; without it the weights are drawn from `seed`.
    scale_file: scaling_factors.json; by default `find_scale_file`'s.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for and no CUDA device is available; "
                           "pass device='cpu' to load the model on the CPU")
    cfg = config_from_model_kwargs(os.path.join(directory, "model_kwargs.json"))
    model = GemNet(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    scale_file = scale_file or find_scale_file(directory)
    if scale_file:
        load_scales_from_json(model, scale_file)
    if weights_path is not None:
        if not os.path.exists(weights_path):
            raise FileNotFoundError(f"no weights at {weights_path}")
        state = torch.load(weights_path, map_location="cpu")
        if "model" in state:
            state = state["model"]
        model.load_state_dict(strip_reference_aliases(state), strict=True)
    return model.to(device)
