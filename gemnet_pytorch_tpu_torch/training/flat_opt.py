"""Flat-parameter optimizer: the AdamW/Adam(amsgrad) update as a dozen
tensor ops over ONE contiguous fp32 parameter buffer (port of
`gemnet_pytorch_tpu/training/flat_opt.py`).

`flatten_parameters` moves a module's parameters into one buffer and makes
each parameter a view of it, so the optimizer, the EMA and the global-norm
clip are a few elementwise kernels over ~2.2M elements at the config.yaml
widths instead of a few per parameter tensor, and a data-parallel gradient
reduction would be one collective. The buffer's order is `named_parameters()`;
the JAX package ravels in sorted-key order, so the two differ only in the
order the global norm sums its squares.

Per-parameter-group behaviour (reference gemnet/training/trainer.py:115-178)
is kept with element masks built at init from the parameter names:
- `wd_mask`: weight_decay for 'adamw' parameters (everything except the atom
  embeddings, the Bessel frequencies and biases), 0 for 'adam' ones;
- `shared_scale`: 1/num_blocks for the shared basis MLPs, 1/(num_blocks+1)
  for mlp_rbf_out, 1 elsewhere (reference trainer.py:250-278).

`torch.optim` is not used: its Adam's eps default differs and it evaluates
the schedule at another step than optax, which the JAX package follows.
The update writes the parameter, EMA and moment buffers in place (no second
copy of the ~9 MB buffers per step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch

SHARED_INT_LAYERS = ("mlp_rbf3", "mlp_cbf3", "mlp_rbf_h")
SHARED_QUAD_LAYERS = ("mlp_rbf4", "mlp_cbf4", "mlp_sbf4")


@dataclass
class FlatOptState:
    count: torch.Tensor  # int32 scalar on the device, shared by the amsgrad
    # bias correction and the LR schedule (optax increments both together)
    mu: torch.Tensor
    nu: torch.Tensor
    nu_max: torch.Tensor
    wd_mask: torch.Tensor  # per-element weight-decay coefficient
    shared_scale: torch.Tensor  # per-element shared-gradient divisor


def flatten_parameters(module: torch.nn.Module) -> torch.Tensor:
    """Copy `module`'s fp32 parameters into one contiguous buffer, in
    `parameters()` order, and rebind each parameter to its view of it."""
    return flatten_named(list(module.named_parameters()))


def flatten_named(named: list[tuple[str, torch.nn.Parameter]]) -> torch.Tensor:
    """`flatten_parameters` over a list of (name, parameter): a part of a
    module's parameters (the pipeline's preamble or stage, `parallel/pp.py`)."""
    for name, p in named:
        if p.dtype != torch.float32:
            raise TypeError(f"{name} is {p.dtype}: master parameters must be float32")
    params = [p for _, p in named]
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    bind_views(params, flat)
    return flat


def bind_parameters(module: torch.nn.Module, flat: torch.Tensor) -> None:
    """Make every parameter of `module` a view of `flat` (no copy)."""
    bind_views(list(module.parameters()), flat)


def bind_views(params: list[torch.nn.Parameter], flat: torch.Tensor) -> None:
    """Make each of `params` a view of `flat`, in order (no copy)."""
    off = 0
    for p in params:
        n = p.numel()
        p.data = flat[off:off + n].view_as(p)
        off += n
    if off != flat.numel():
        raise ValueError(f"buffer holds {flat.numel()} elements, the parameters {off}")


def param_label(name: str) -> str:
    """'adam' for atom embeddings / Bessel frequencies / biases, 'adamw'
    otherwise (reference trainer.py:118-129; flat_opt.py:59-68 by flax path)."""
    parts = name.split(".")
    if any("atom_emb" in p for p in parts):
        return "adam"
    if "frequencies" in parts[-1] or "bias" in parts[-1]:
        return "adam"
    return "adamw"


def build_masks(named_shapes: Iterable[tuple[str, torch.Size]], model_cfg,
                weight_decay: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (wd_mask, shared_scale) over parameters given in buffer order."""
    shared = set(SHARED_INT_LAYERS)
    if not model_cfg.triplets_only:
        shared |= set(SHARED_QUAD_LAYERS)
    wd, sc = [], []
    for name, shape in named_shapes:
        n = int(torch.Size(shape).numel())
        top = name.split(".")[0]
        if top in shared:
            s = 1.0 / model_cfg.num_blocks
        elif top == "mlp_rbf_out":
            s = 1.0 / (model_cfg.num_blocks + 1)
        else:
            s = 1.0
        wd.append(torch.full((n,), weight_decay if param_label(name) == "adamw" else 0.0))
        sc.append(torch.full((n,), s))
    return torch.cat(wd).to(device), torch.cat(sc).to(device)


def init(flat_params: torch.Tensor, wd_mask, shared_scale) -> FlatOptState:
    def z():
        return torch.zeros_like(flat_params)

    return FlatOptState(
        count=torch.zeros((), dtype=torch.int32, device=flat_params.device),
        mu=z(), nu=z(), nu_max=z(), wd_mask=wd_mask, shared_scale=shared_scale)


@torch.no_grad()
def apply_update(
    g: torch.Tensor,
    st: FlatOptState,
    p: torch.Tensor,
    ema: torch.Tensor,
    lr_scale,
    *,
    schedule: Callable,
    learning_rate: float,
    grad_clip_max: float,
    ema_decay: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
    clip_scale: torch.Tensor | None = None,
) -> None:
    """One optimizer step on flat vectors, in place on p, ema and st.

    The JAX package's optax.chain(scale_shared_grads, clip_by_global_norm,
    multi_transform({adamw, adam})) + apply_updates + EMA: the schedule is
    evaluated at the PRE-increment count, the amsgrad bias correction at the
    post-increment count, and EMA follows the update. `lr_scale` (the
    plateau's multiplier) is a float or a 0-d fp32 tensor on p's device: the
    Trainer passes a device scalar it fills before each step, so a captured
    step reads the value of each replay, not the one of its capture.

    `clip_scale` replaces the global-norm clip with a multiplier the caller
    computed, where the whole gradient spans several flat vectors and the
    norm must be taken over all of them (the pipeline's preamble and stage
    vectors, `parallel/pp.py`; JAX `training/flat_opt.py:123-141`)."""
    g = g * st.shared_scale
    if clip_scale is None:
        gnorm = torch.sqrt(torch.sum(g * g))
        g = torch.where(gnorm < grad_clip_max, g, g * (grad_clip_max / gnorm))
    else:
        g = g * clip_scale

    lr_t = learning_rate * schedule(st.count)
    st.count += 1
    cf = st.count.float()
    st.mu.mul_(b1).add_((1.0 - b1) * g)
    st.nu.mul_(b2).add_((1.0 - b2) * (g * g))
    mu_hat = st.mu / (1.0 - b1**cf)
    # torch amsgrad semantics (reference trainer.py:131-150 uses
    # torch.optim.AdamW/Adam(amsgrad=True)): running max of the RAW second
    # moment, bias-corrected at the current step
    torch.maximum(st.nu_max, st.nu, out=st.nu_max)
    upd = mu_hat / (torch.sqrt(st.nu_max / (1.0 - b2**cf)) + eps)
    upd = upd + st.wd_mask * p
    p.add_(upd * (-lr_t) * lr_scale)
    ema.sub_((1.0 - ema_decay) * (ema - p))
