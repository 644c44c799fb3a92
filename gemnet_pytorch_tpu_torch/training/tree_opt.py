"""Per-tensor optimizer: the JAX package's optax tree-mode chain
(`gemnet_pytorch_tpu/training/trainer.py:178-320`), which it runs with
`flat_optimizer=False` and always with AGC (`:422`).

One plain function per optax transformation, over the model's parameter
tensors in `named_parameters()` order, chained as JAX chains them:

    scale_shared_grads -> clip_by_global_norm | adaptive_gradient_clip
    -> scale_by_amsgrad_torch -> add_decayed_weights (the 'adamw' label
    only, when weight_decay > 0) -> scale_by_learning_rate

then the plateau's `lr_scale`, the update and the EMA (`:596-605`). With
weight_decay == 0 JAX runs one Adam chain (`:316-317`); here that is the
same chain with no tensor decayed. The amsgrad count is shared by every
tensor and by the schedule, as optax's per-label counts all advance
together.

The parameters stay views of the Trainer's flat buffer (`flat_opt`); only
the optimizer state is per tensor: `count` and the `mu`/`nu`/`nu_max`
moments by parameter name. Every state tensor is updated in place, since a
captured step reads and writes their addresses. The elementwise steps run
as `torch._foreach_*` calls over all tensors at once.

AGC's unit axis follows the port's layouts. JAX's `unitwise_norm` takes a
flax kernel (in, out) and reduces every axis but the last; a `Dense.weight`
here is (out, in) (`models/layers.py`), so its norm is over dim 1. Every
other weight has the JAX layout (the embedding table, the 3-D down
projection and bilinear weights) and reduces every dim but the last; a 1-D
tensor takes its whole norm.

Where the tensors are parts of a larger gradient (a tensor-parallel rank's
slices, `parallel/tp.py`), the caller passes the global norm's function
(`apply_update(norm_fn=...)`). AGC's units lie along the shard dims (a
Dense row, the last dim of a 3-D weight, a column of the embedding table),
so it clips a rank's slices as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from ..models.layers import Dense
from .flat_opt import SHARED_INT_LAYERS, SHARED_QUAD_LAYERS, param_label

AGC_EPS = 1e-3  # the parameter norm's floor (trainer.py:214)
AGC_GRAD_FLOOR = 1e-6  # the gradient norm's floor (trainer.py:243)


@dataclass
class TreeOptState:
    count: torch.Tensor  # int32 scalar on the device
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    nu_max: dict[str, torch.Tensor]


@dataclass(frozen=True)
class TreeLayout:
    """What the chain needs to know of each tensor, by position in
    `named_parameters()` order."""

    names: tuple[str, ...]
    shapes: tuple[torch.Size, ...]
    shared_div: tuple[int, ...]  # scale_shared_grads' divisor (1: not shared)
    decayed: tuple[bool, ...]  # the 'adamw' label
    unit_dims: tuple[tuple[int, ...], ...]  # AGC's reduced dims (): whole norm
    head: tuple[bool, ...]  # out_energy / out_forces


def build_layout(model: torch.nn.Module, model_cfg) -> TreeLayout:
    shared = set(SHARED_INT_LAYERS)
    if not model_cfg.triplets_only:
        shared |= set(SHARED_QUAD_LAYERS)
    dense = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, Dense)}
    names, shapes, div, decayed, dims, head = [], [], [], [], [], []
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        names.append(name)
        shapes.append(p.shape)
        div.append(model_cfg.num_blocks if top in shared
                   else model_cfg.num_blocks + 1 if top == "mlp_rbf_out" else 1)
        decayed.append(param_label(name) == "adamw")
        if p.ndim <= 1:
            dims.append(())
        elif name in dense:
            dims.append((1,))  # (out, in): per output unit
        else:
            dims.append(tuple(range(p.ndim - 1)))
        head.append("out_energy" in name or "out_forces" in name)
    return TreeLayout(tuple(names), tuple(shapes), tuple(div), tuple(decayed), tuple(dims),
                      tuple(head))


def init(layout: TreeLayout, device) -> TreeOptState:
    def zeros():
        return {n: torch.zeros(s, device=device) for n, s in zip(layout.names, layout.shapes)}

    return TreeOptState(count=torch.zeros((), dtype=torch.int32, device=device),
                        mu=zeros(), nu=zeros(), nu_max=zeros())


def views(flat: torch.Tensor, layout: TreeLayout) -> list[torch.Tensor]:
    """The tensors of `layout` as views of a flat buffer in its order."""
    out, off = [], 0
    for shape in layout.shapes:
        n = shape.numel()
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


# ---------------------------------------------------------------- transformations

def scale_shared_grads(grads: Sequence[torch.Tensor], layout: TreeLayout) -> list[torch.Tensor]:
    """Shared layers' gradients over their share count (trainer.py:190-210)."""
    return [g / d if d != 1 else g for g, d in zip(grads, layout.shared_div)]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """||g|| over every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        gnorm: torch.Tensor) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: every gradient times max_norm / ||g|| where
    the global norm `gnorm` (`global_norm(grads)`, or the norm of the
    gradient they are parts of) reaches max_norm."""
    factor = torch.where(gnorm < max_norm, torch.ones_like(gnorm), max_norm / gnorm)
    return torch._foreach_mul(list(grads), factor)


def unitwise_norm(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """The norm of each unit of `x` over `dims`, kept as broadcastable
    axes; the whole norm where `dims` is empty (trainer.py:224-229)."""
    if not dims:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))


def adaptive_gradient_clip(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                           layout: TreeLayout, clip_factor: float,
                           compat_reference: bool = False) -> list[torch.Tensor]:
    """AGC (trainer.py:213-249; NFNets): each unit's gradient clipped to
    clip_factor · max(||p||_unit, 1e-3). The output heads pass unclipped;
    `compat_reference` clips only them (the reference's inverted selection,
    trainer.py:237-241)."""
    out = []
    for g, p, dims, head in zip(grads, params, layout.unit_dims, layout.head):
        if head != compat_reference:
            out.append(g)
            continue
        max_norm = torch.clamp_min(unitwise_norm(p, dims), AGC_EPS) * clip_factor
        g_norm = torch.clamp_min(unitwise_norm(g, dims), AGC_GRAD_FLOOR)
        out.append(torch.where(g_norm < max_norm, g, g * (max_norm / g_norm)))
    return out


def scale_by_amsgrad_torch(grads: Sequence[torch.Tensor], st: TreeOptState,
                           b1: float = 0.9, b2: float = 0.999,
                           eps: float = 1e-7) -> list[torch.Tensor]:
    """AMSGrad with torch semantics (trainer.py:252-285): the running max of
    the raw second moment, bias-corrected at the incremented count. Updates
    the moments and the count in place."""
    grads = list(grads)
    mu, nu, nu_max = list(st.mu.values()), list(st.nu.values()), list(st.nu_max.values())
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    torch._foreach_maximum_(nu_max, nu)
    st.count += 1
    cf = st.count.float()
    bc1, bc2 = 1.0 - b1**cf, 1.0 - b2**cf
    denom = torch._foreach_sqrt(torch._foreach_div(nu_max, bc2))
    torch._foreach_add_(denom, eps)
    return torch._foreach_div(torch._foreach_div(mu, bc1), denom)


def add_decayed_weights(updates: list[torch.Tensor], params: Sequence[torch.Tensor],
                        layout: TreeLayout, weight_decay: float) -> list[torch.Tensor]:
    """updates + weight_decay · params for the 'adamw' tensors (optax's
    add_decayed_weights on that label's chain), in place on `updates`."""
    if weight_decay > 0:
        decayed = [i for i, d in enumerate(layout.decayed) if d]
        torch._foreach_add_([updates[i] for i in decayed],
                            torch._foreach_mul([params[i] for i in decayed], weight_decay))
    return updates


@torch.no_grad()
def apply_update(
    grads: Sequence[torch.Tensor],
    st: TreeOptState,
    layout: TreeLayout,
    flat_params: torch.Tensor,
    flat_ema: torch.Tensor,
    lr_scale,
    *,
    schedule: Callable,
    learning_rate: float,
    weight_decay: float,
    grad_clip_max: float,
    ema_decay: float,
    agc: bool = False,
    agc_compat_reference: bool = False,
    norm_fn: Callable = global_norm,
) -> None:
    """One step of the chain, in place on the parameters (views of
    `flat_params`), the EMA and the state. The schedule is read at the
    chain's count before the step, as optax's scale_by_learning_rate reads
    its own; `lr_scale` is a float or a device scalar. `norm_fn`: the
    global norm of the gradients the clip takes (module docstring)."""
    params = views(flat_params, layout)
    g = scale_shared_grads(grads, layout)
    if agc:
        g = adaptive_gradient_clip(g, params, layout, grad_clip_max, agc_compat_reference)
    else:
        g = clip_by_global_norm(g, grad_clip_max, norm_fn(g))
    lr_t = learning_rate * schedule(st.count)
    u = scale_by_amsgrad_torch(g, st)
    u = add_decayed_weights(u, params, layout, weight_decay)
    torch._foreach_mul_(u, -lr_t)
    torch._foreach_mul_(u, lr_scale)
    torch._foreach_add_(params, u)
    # s - (1 - d)(s - p), elementwise: the flat buffers give the per-tensor result
    flat_ema.sub_((1.0 - ema_decay) * (flat_ema - flat_params))
