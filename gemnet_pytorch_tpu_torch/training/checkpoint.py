"""Checkpoints: the train state and the model-only best checkpoint (port of
`gemnet_pytorch_tpu/training/checkpoint.py`, with `torch.save`/`torch.load`
in place of orbax).

Counterpart of the reference's two .pth files per run (train_seml.py:336-340):
`save_checkpoint` writes the whole `TrainState` (step, flat parameters,
optimizer state, flat or per tensor, EMA, metric accumulators) and the
plateau state into a `path + ".plateau.npz"` sidecar, as the JAX package
does; `save_params` writes the model's `state_dict` (the reference
schema's names, scale factors included).

Restores are in place. The model's parameters are views of `state.params`
(`flat_opt.flatten_parameters`), so `restore_checkpoint` copies into the
existing buffers with `copy_`; rebinding `state.params` to a new tensor would
leave the model training on the old weights. `restore_params` goes through
`load_state_dict`, which copies into the parameters as well. Every file,
the plateau sidecar included, is written to a temporary name and renamed,
so an interrupted save never leaves a torn checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .schedules import PlateauState
from .trainer import TrainState

_STATE_FIELDS = ("step", "params", "ema_params", "metric_acc")


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _temp_name(path: str) -> str:
    """A temporary name beside `path` with the same suffix (np.savez appends
    ".npz" to a name that lacks it)."""
    root, ext = os.path.splitext(path)
    return f"{root}.{os.getpid()}.tmp{ext}"


def _save(payload, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = _temp_name(path)
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """The tensors a checkpoint holds, by key: the state's own (no copies).
    The per-tensor optimizer's moments are keyed by parameter name
    (`opt_state.mu.<name>`)."""
    out = {k: getattr(state, k) for k in _STATE_FIELDS}
    for f in dataclasses.fields(state.opt_state):
        value = getattr(state.opt_state, f.name)
        if isinstance(value, dict):
            out.update({f"opt_state.{f.name}.{name}": t for name, t in value.items()})
        else:
            out[f"opt_state.{f.name}"] = value
    return out


def save_checkpoint(path: str, state, plateau: Optional[PlateauState] = None) -> None:
    """The state (a TrainState, or a dict of tensors by key: the pipeline's,
    `parallel.pp.PPTrainer.checkpoint_tensors`) to `path`, the plateau to
    its sidecar. Both are written in full to temporary names before either
    is renamed, so neither file is ever torn; the two renames follow each
    other, the sidecar's first."""
    path = _abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = _temp_name(path)
    tensors = state if isinstance(state, dict) else state_tensors(state)
    torch.save({k: _host(v) for k, v in tensors.items()}, tmp)
    if plateau is not None:
        sidecar = path + ".plateau.npz"
        tmp_sidecar = _temp_name(sidecar)
        np.savez(tmp_sidecar, **plateau.state_dict())
        os.replace(tmp_sidecar, sidecar)
    os.replace(tmp, path)


@torch.no_grad()
def restore_checkpoint(path: str, state: TrainState, plateau: Optional[PlateauState] = None
                       ) -> tuple[TrainState, Optional[PlateauState]]:
    """Copy the checkpoint at `path` into `state`'s own tensors (and the
    sidecar into `plateau`); returns them."""
    saved = read_checkpoint(path, plateau)
    targets = state_tensors(state)
    if sorted(saved) != sorted(targets):
        raise KeyError(f"checkpoint {path} holds {sorted(saved)}, the state {sorted(targets)}")
    for key, dst in targets.items():
        src = saved[key]
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint {key}: {src.dtype}{tuple(src.shape)}, "
                             f"state {dst.dtype}{tuple(dst.shape)}")
        dst.copy_(src)
    return state, plateau


def read_checkpoint(path: str, plateau: Optional[PlateauState] = None) -> dict:
    """The tensors of the checkpoint at `path`, by key, on the CPU; its
    sidecar, where there is one, is read into `plateau` (in place)."""
    path = _abspath(path)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if plateau is not None and os.path.exists(path + ".plateau.npz"):
        with np.load(path + ".plateau.npz", allow_pickle=True) as data:
            plateau.load_state_dict({k: data[k].item() for k in data.files})
    return saved


def save_params(path: str, model: torch.nn.Module) -> None:
    """Model-only checkpoint (reference `save_weights`, gemnet.py:789-790):
    the model's state_dict as it is bound (bind the EMA weights first for the
    best model, `Trainer.weights`)."""
    _save({k: _host(v) for k, v in model.state_dict().items()}, _abspath(path))


def restore_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a `save_params` checkpoint into `model` in place (strict)."""
    model.load_state_dict(torch.load(_abspath(path), map_location="cpu", weights_only=True),
                          strict=True)
    return model
