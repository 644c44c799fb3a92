"""Tensor parallelism: GemNet's weights sharded over the ranks of a process
group (port of `gemnet_pytorch_tpu/parallel/tp.py`).

JAX shards the parameters on a `tp` mesh and leaves the rest to GSPMD,
which chooses, op by op, whether to gather an activation or a weight. PyTorch
has no partitioner, so the port chooses once: it stores shards and gathers
the weights.

- Storage. Each rank holds its 1/N slice of every sharded parameter
  (`tp_param_specs`: JAX's rules in the port's layouts) under the
  parameter's monolithic name (`TPModel`), so the Trainer's flat fp32
  buffer, its EMA and the per-tensor AMSGrad moments (`training/tree_opt.py`)
  are the rank's slices too. At config.yaml's widths 147 of GemNet-Q's 153
  tensors shard; a rank holds 1 079 558 of its 2 158 470 parameters at
  N = 2 and 540 102 at N = 4. The six tensors whose dim does not divide
  (the Bessel frequencies and the five (1, 128) energy heads, 646 floats)
  stay whole on every rank.
- Forward. One differentiable all-gather over the group of the rank's
  sharded part (`collectives.all_gather_shards`: 4 315 648 bytes a rank at
  N = 2), one fixed permutation of the gathered vector and the replicated
  tensors into the single device's flat layout, and views of that as the
  full parameters, bound to the model for the call
  (`torch.func.functional_call`). Everything after that is the
  single-device program: the same kernels (K1, K2, K3, and K4 under
  "high") at the same shapes, the same bits on the CPU. The bf16 mode casts
  after the gather, as `Dense` does per call.
- Backward. The gather's transpose is the rank's own slice of the cotangent
  (`collectives.py`); the permutation's is the inverse permutation. F =
  -dE/dR never crosses the gather (the weights are not on the path from E
  to R); the loss's backward crosses it once. Every rank runs the same
  program on the same batch, so a sharded parameter's gradient is exact on
  its rank with no collective, and a replicated one is whole on every rank:
  it is all-reduced over the group and divided by N, so that the ranks'
  copies never drift apart (on the card `index_add_`'s float atomics part
  replicated computations in their last bits).
- Training (`TPTrainer`, a `Trainer` of a `TPModel`) runs the optimizer
  in tree mode only (`flat_optimizer=False`, as JAX's `init_tp_state`
  asserts): its global-norm clip sums the replicated tensors' squares on
  the rank and the sharded ones' over the group (`TPModel.grad_norm`);
  AGC's units lie along the shard dims (a Dense row, the last dim of a 3-D
  weight, a column of the embedding table) and need no collective.

What this does not shard: the dense FLOPs. Every rank runs the whole
model. Sharding them, Megatron-style, would gather activations around each
Dense: an identity-forward, all-reduce-backward operator before it and a
gather after it, both on the -dE/dR path and differentiated twice, about
150 layers x 3 passes. And at GemNet's widths a weight is 16-64 KB while a
Dense's input is 1.5-25 MB, so gathering the weights is the cheaper
exchange, and the dense products are a small part of a step. Tensor
parallelism here divides the parameters, moments and EMA by N; at
config.yaml's widths those are ~43 MB, which barely moves a step's peak:
JAX says the same of its tp (the right axis once the widths outgrow one
device).

dp x tp: on a 2-D mesh (`mesh.make_hybrid_mesh(n_dp, n_tp)`, its rows the
tp groups) each row holds one copy of the model and trains on its own batch.
The loss is the global masked mean over the dp column (num/den, as
`parallel/dp.py`), a sharded gradient is all-reduced over the dp column
only (its ranks share one tp index and so one shard layout), a replicated
one over the world and divided by n_tp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..models.gemnet import GemNet, energy_and_forces
from ..models.layers import Dense
from ..training.checkpoint import state_tensors
from ..training.trainer import Trainer
from . import mesh
from .collectives import all_gather, all_gather_shards, all_reduce_
from .dp import shard_batch_to_mesh


# ======================================================================
# the shards
# ======================================================================


def tp_param_specs(model: nn.Module, n: int) -> dict:
    """{parameter name: the dim its N slices split, or None (replicated)} of
    a model at its full widths, JAX's `tp_param_specs` in the port's
    layouts: a `Dense.weight` (out, in) on dim 0 (JAX's (in, out) kernel on
    its output columns), a 3-D `weight` (the bilinear's (emb, I, out), the
    down projection's (S, R, I)) on dim 2, the embedding table (93, emb) on
    dim 1; a tensor whose dim N does not divide, and every other tensor,
    stays whole."""
    dense = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, Dense)}
    table = {f"{name}.weight" for name, m in model.named_modules()
             if isinstance(m, nn.Embedding)}
    specs = {}
    for name, p in model.named_parameters():
        dim = None
        if name in dense and p.ndim == 2:
            dim = 0
        elif name.endswith(".weight") and p.ndim == 3:
            dim = 2
        elif name in table and p.ndim == 2:
            dim = 1
        specs[name] = dim if dim is not None and p.shape[dim] % n == 0 else None
    return specs


def shard_tp_state_dict(state_dict: dict, specs: dict, n: int, index: int) -> dict:
    """Rank `index`'s slices of a monolithic state dict: each sharded
    tensor's `index`-th of N equal slices along its dim (contiguous), every
    other entry as it is."""
    out = {}
    for key, value in state_dict.items():
        dim = specs.get(key)
        out[key] = value if dim is None else value.chunk(n, dim)[index].contiguous()
    return out


def merge_tp_state_dict(state_dicts: list, specs: dict) -> dict:
    """The monolithic state dict of every rank's `shard_tp_state_dict`, in
    rank order (merges gradients and moments too)."""
    out = {}
    for key, value in state_dicts[0].items():
        dim = specs.get(key)
        out[key] = value if dim is None else torch.cat([sd[key] for sd in state_dicts], dim)
    return out


def _groups(group):
    """(tp group, dp group, world) of a process group (tp alone), a
    `mesh.HybridMesh` (dp x tp: its rows hold the model) or None."""
    if isinstance(group, mesh.HybridMesh):
        return group.tp, group.dp, group.world
    return group, None, group


class _Permute(torch.autograd.Function):
    """x[index]; backward: the cotangent gathered by the inverse
    permutation (a gather, not `index_select`'s scatter-add), itself a
    `_Permute`, so a double backward is one too."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.index, ctx.inverse = index, inverse
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        return _Permute.apply(g, ctx.inverse, ctx.index), None, None


class TPModel(GemNet):
    """A rank's GemNet under tensor parallelism over `group` (a process
    group, or a dp x tp `mesh.HybridMesh`): every parameter under its
    monolithic name, a sharded one holding this rank's slice
    (`tp_param_specs`). The monolithic model is built on the CPU, where the
    generator draws every weight as `GemNet` draws them; each sharded
    parameter is then cut to its slice and only the slices move to
    `device`. No rank keeps a whole sharded parameter outside a call's
    transient gather (module docstring). `group=None` is a group of one."""

    def __init__(self, cfg, group=None, *, generator: torch.Generator, device="cuda"):
        if cfg.ep_axis is not None:
            raise ValueError("tensor parallelism does not compose with an edge partition "
                             "(ep_axis/ep_halo)")
        if cfg.remat_blocks:
            # the recomputation runs in the backward, after the call's
            # gathered weights are unbound again
            raise ValueError("tensor parallelism does not compose with remat_blocks")
        super().__init__(cfg, generator=generator, device="cpu")
        self.tp_group, self.dp_group, self.world = _groups(group)
        tp = self.tp_group
        self.tp_index, self.n_tp = (0, 1) if tp is None else (mesh.rank(tp), mesh.world_size(tp))
        self.tp_specs = tp_param_specs(self, self.n_tp)
        self.full_shapes = {name: p.shape for name, p in self.named_parameters()}
        with torch.no_grad():
            for name, p in self.named_parameters():
                if self.tp_specs[name] is not None:
                    p.data = p.data.chunk(self.n_tp, self.tp_specs[name])[self.tp_index].clone()
        index = self._gather_order()
        inverse = torch.empty_like(index)
        inverse[index] = torch.arange(index.numel(), dtype=index.dtype)
        self.register_buffer("_tp_index", index, persistent=False)
        self.register_buffer("_tp_inverse", inverse, persistent=False)
        self._bound = False
        self.to(device)

    def _gather_order(self) -> torch.Tensor:
        """The permutation that takes [every rank's sharded slices, in rank
        order (N x L) | this rank's replicated tensors] to the single
        device's flat layout (`named_parameters()` order, full shapes), as
        int32 indices."""
        named = list(self.named_parameters())
        n = self.n_tp
        L = sum(p.numel() for name, p in named if self.tp_specs[name] is not None)
        parts, off, rep = [], 0, n * L
        for name, p in named:
            dim = self.tp_specs[name]
            if dim is None:
                parts.append(torch.arange(rep, rep + p.numel()))
                rep += p.numel()
                continue
            blocks = [(r * L + off + torch.arange(p.numel())).view(p.shape) for r in range(n)]
            parts.append(torch.cat(blocks, dim).reshape(-1))
            off += p.numel()
        return torch.cat(parts).to(torch.int32)

    def full_parameters(self) -> dict:
        """Every parameter at its full shape, by name: the sharded ones
        gathered over the group (one collective), the replicated ones this
        rank's own, all views of one fp32 vector in the single device's flat
        layout; differentiable back to this rank's parameters."""
        named = list(self.named_parameters())
        sharded = [p.reshape(-1) for name, p in named if self.tp_specs[name] is not None]
        replicated = [p.reshape(-1) for name, p in named if self.tp_specs[name] is None]
        gathered = all_gather_shards(torch.cat(sharded), self.tp_group)
        flat = _Permute.apply(torch.cat([gathered.reshape(-1), *replicated]), self._tp_index,
                              self._tp_inverse)
        # one split, not a slice a parameter: split's backward is one cat of
        # the gradients, a slice's a zero-filled copy of `flat` each
        shapes = [self.full_shapes[name] for name, _ in named]
        parts = flat.split([shape.numel() for shape in shapes])
        return {name: part.view(shape) for (name, _), part, shape in zip(named, parts, shapes)}

    def forward(self, batch, R=None):
        """GemNet's forward on the full weights of `full_parameters()`."""
        if self._bound:  # inside the functional call below: the full weights are bound
            return super().forward(batch, R)
        params = self.full_parameters()
        self._bound = True
        try:
            return torch.func.functional_call(self, params, (batch, R))
        finally:
            self._bound = False

    def sharded(self) -> list:
        """Whether each parameter, in `named_parameters()` order, is sharded."""
        return [self.tp_specs[name] is not None for name, _ in self.named_parameters()]

    def reduce_gradients(self, grads) -> list:
        """Per-parameter gradients of a loss every rank of a tp row holds
        alike (`named_parameters()` order) -> the step's gradients: a
        sharded one all-reduced over the dp column (dp x tp; alone it is
        exact as it is), a replicated one all-reduced over the world and
        divided by N (module docstring)."""
        grads = list(grads)
        flags = self.sharded()
        for group, want, scale in ((self.dp_group, True, 1.0),
                                   (self.world, False, 1.0 / self.n_tp)):
            idx = [i for i, s in enumerate(flags) if s == want]
            if group is None or not idx:
                continue
            flat = all_reduce_(torch.cat([grads[i].reshape(-1) for i in idx]), group)
            if scale != 1.0:
                flat = flat * scale
            for i, v in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = v.view_as(grads[i])
        return grads

    def grad_norm(self, grads) -> torch.Tensor:
        """||g|| of the whole model's gradient from this rank's per-tensor
        gradients (`named_parameters()` order): the replicated tensors'
        squares on the rank, the sharded slices' summed over the tp group
        (one all-reduce of 4 bytes)."""
        norms = torch._foreach_norm(list(grads))
        flags = self.sharded()
        squares = lambda xs: torch.sum(torch.stack(xs) ** 2)  # noqa: E731
        total = all_reduce_(squares([n for n, s in zip(norms, flags) if s]).reshape(1),
                            self.tp_group)[0]
        whole = [n for n, s in zip(norms, flags) if not s]
        return torch.sqrt(total + squares(whole) if whole else total)

    def merge_named(self, local: dict) -> dict:
        """A dict of this rank's slices by parameter name (parameters,
        gradients, moments) -> the whole tensors, on every rank
        (collective)."""
        names = [name for name, _ in self.named_parameters()]
        return _gather_merge({n: local[n] for n in names}, self.tp_specs, self.tp_group)


def _gather_merge(local: dict, specs: dict, group) -> dict:
    """The whole tensors, by key, of every rank's slices `local` (`specs`
    by key), on every rank: one all-gather of them all, fp32, to the CPU."""
    keys = list(local)
    rows = all_gather(torch.cat([local[k].detach().reshape(-1).float() for k in keys]),
                      group).cpu()
    per_rank = [{k: part.view(local[k].shape).clone() for k, part in zip(
        keys, row.split([local[k].numel() for k in keys]))} for row in rows]
    return merge_tp_state_dict(per_rank, specs)


# ======================================================================
# the model's functions
# ======================================================================


def _check_model(model) -> TPModel:
    if not isinstance(model, TPModel):
        raise TypeError("tensor parallelism runs a parallel.tp.TPModel")
    return model


def _check_trainer(trainer) -> TPModel:
    if not isinstance(trainer, TPTrainer):
        raise TypeError("tensor parallelism trains with a parallel.tp.TPTrainer")
    return trainer.model


def make_tp_energy_and_forces(model: TPModel):
    """(batch, create_graph=False) -> (E, F) with the variant's force path,
    the same on every rank: the direct head, or F = -dE/dR (the gathered
    weights are constants of R, so no collective enters the force
    backward)."""
    _check_model(model)
    return lambda batch, create_graph=False: energy_and_forces(model, batch, create_graph)


def make_tp_loss_and_grad(model: TPModel, loss_fn):
    """(batch) -> (loss, grads): `loss_fn(E, F, batch)` and its gradient by
    parameter name, each sharded parameter's the rank's slice, each
    replicated one whole and the same on every rank (`reduce_gradients`).
    Under dp x tp `loss_fn` is a sum (as JAX's tests take it): the loss
    returned is the sum over the dp column, the gradients those of it."""
    _check_model(model)

    def loss_and_grad(batch):
        E, F = energy_and_forces(model, batch, create_graph=True)
        loss = loss_fn(E, F, batch)
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True,
                                    materialize_grads=True)
        grads = model.reduce_gradients(grads)
        total = all_reduce_(loss.detach().clone(), model.dp_group)
        return total, {name: g for (name, _), g in zip(named, grads)}

    return loss_and_grad


# ======================================================================
# training
# ======================================================================


class TPTrainer(Trainer):
    """The Trainer of a `TPModel`: its step's gradients reduced as
    `TPModel.reduce_gradients` says, the clip's norm over the tp group
    (`TPModel.grad_norm`), the step captured where every group of the model
    is NCCL. Tree mode only: the flat optimizer's clip would take a rank's
    norm for the whole gradient's."""

    def __init__(self, model: TPModel, cfg):
        super().__init__(_check_model(model), cfg)
        if self.flat:
            raise ValueError("tensor parallelism trains with the per-tensor optimizer: set "
                             "flat_optimizer=False (the flat optimizer's clip is a rank's norm)")

    def gradients(self, loss, group=None, model=None, grad_group=None):
        """The per-tensor gradients, reduced (`TPModel.reduce_gradients`);
        `group` is the model's dp column or None."""
        if model is not None or grad_group is not None or group is not self.model.dp_group:
            raise ValueError("a tensor-parallel step takes its model's dp column as `group` "
                             "(or none), and no model view or gradient group")
        return self.model.reduce_gradients(torch.autograd.grad(
            loss, list(self.model.parameters()), allow_unused=True, materialize_grads=True))

    def grad_norm(self, grads) -> torch.Tensor:
        return self.model.grad_norm(grads)

    def process_groups(self) -> tuple:
        return (self.model.tp_group, self.model.dp_group, self.model.world)


def init_tp_state(trainer, state_dict: Optional[dict] = None):
    """The state of a `TPTrainer` (tree mode only, as JAX `tp.py:115-118`):
    parameters, EMA and the AMSGrad moments the rank's slices.
    `state_dict`: monolithic weights to start from (JAX's `variables`),
    sharded here."""
    model = _check_trainer(trainer)
    if state_dict is not None:
        model.load_state_dict(shard_tp_state_dict(state_dict, model.tp_specs, model.n_tp,
                                                  model.tp_index), strict=True)
    return trainer.init_state()


def make_tp_train_step(trainer):
    """(state, batch, lr_scale) -> (state, metrics, counts): the
    `TPTrainer`'s step (`Trainer.train_step_fn`): the loss on the full
    gathered weights, its gradients reduced (`TPModel.reduce_gradients`),
    the tree-mode update with the clip's norm over the group, the EMA.
    Captured on an NCCL group (the gather and all-reduces inside the
    graph), eager on gloo and the CPU."""
    if _check_trainer(trainer).dp_group is not None:
        raise ValueError("a dp x tp model trains with make_dp_tp_train_step")
    return trainer.train_step_fn()


def stack_dp_batches(batches):
    """Stack per-row padded batch dicts along a leading dp axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def shard_dp_batch(stacked, hmesh, device=None):
    """This rank's dp row of a `stack_dp_batches` stack (`dp.shard_batch_to_mesh`
    over the mesh's dp column): a numpy dict, or tensors on `device`."""
    return shard_batch_to_mesh(stacked, hmesh.dp, device)


def make_dp_tp_train_step(trainer, hmesh):
    """The dp x tp step on a `mesh.make_hybrid_mesh(n_dp, n_tp)`: the loss
    the global masked mean over the dp column (num/den), the gradients
    reduced as the module docstring says, the tree-mode update. Captured
    where every group is NCCL, eager otherwise."""
    model = _check_trainer(trainer)
    if model.dp_group is not hmesh.dp or model.tp_group is not hmesh.tp:
        raise ValueError("the model is not on this mesh: build it with TPModel(cfg, hmesh)")
    return trainer.train_step_fn(group=hmesh.dp)


def check_tp_opt_sharding(trainer, state) -> None:
    """Layout guard (JAX `tp.py:194-215`): the parameters, the EMA and every
    moment of a sharded parameter are this rank's slice, none whole. Raises
    ValueError on a whole one."""
    model = _check_trainer(trainer)
    bad = []
    local = {name: p.shape for name, p in model.named_parameters()}
    n_local = sum(s.numel() for s in local.values())
    for key, t in (("params", state.params), ("ema_params", state.ema_params)):
        if t.numel() != n_local:
            bad.append((key, tuple(t.shape)))
    opt = state.opt_state
    for field in ("mu", "nu", "nu_max"):
        for name, t in getattr(opt, field).items():
            full = model.full_shapes[name]
            sliced = model.tp_specs[name] is not None and model.n_tp > 1
            if t.shape != local[name] or (sliced and t.shape == full):
                bad.append((f"{field}.{name}", tuple(t.shape)))
    if bad:
        raise ValueError(f"tensors of sharded parameters held whole or misshapen: {bad}")


def _state_names(trainer) -> list:
    return [name for name, _ in trainer.model.named_parameters()]


def _unflatten(flat: torch.Tensor, names: list, shapes: dict) -> dict:
    out, off = {}, 0
    for name in names:
        n = shapes[name].numel()
        out[name] = flat[off:off + n].view(shapes[name])
        off += n
    return out


def merged_state_dict(trainer, state, ema: bool = False) -> dict:
    """The monolithic model's state dict (CPU tensors) of the current or
    the EMA weights, on every rank (collective; JAX's sharded variables
    gathered), the scale factors included."""
    model = _check_trainer(trainer)
    names = _state_names(trainer)
    local = {n: p.shape for n, p in model.named_parameters()}
    out = model.merge_named(_unflatten(state.ema_params if ema else state.params, names, local))
    params = dict(model.named_parameters())
    for key, t in model.state_dict().items():
        if key not in params:
            out[key] = t.detach().cpu().clone()
    return out


def checkpoint_tensors(trainer, state) -> dict:
    """The checkpoint of the whole model, on every rank (collective): the
    single device's tree-mode checkpoint (`training.checkpoint.state_tensors`:
    the flat parameters and EMA in its layout, the moments by name at their
    full shapes), so a tp run resumes at any N, or on one device."""
    model = _check_trainer(trainer)
    names = _state_names(trainer)
    local = {n: p.shape for n, p in model.named_parameters()}
    opt = state.opt_state
    parts = {"params": _unflatten(state.params, names, local),
             "ema_params": _unflatten(state.ema_params, names, local),
             **{f: getattr(opt, f) for f in ("mu", "nu", "nu_max")}}
    # one gather for all five: each part's tensors under "<part>/<name>"
    whole = _gather_merge({f"{part}/{n}": d[n] for part, d in parts.items() for n in names},
                          {f"{part}/{n}": model.tp_specs[n] for part in parts for n in names},
                          model.tp_group)
    out = {"step": state.step.detach().cpu().clone(),
           "metric_acc": state.metric_acc.detach().cpu().clone(),
           "opt_state.count": opt.count.detach().cpu().clone()}
    for part in ("params", "ema_params"):
        out[part] = torch.cat([whole[f"{part}/{n}"].reshape(-1) for n in names])
    for f in ("mu", "nu", "nu_max"):
        for n in names:
            out[f"opt_state.{f}.{n}"] = whole[f"{f}/{n}"]
    return out


@torch.no_grad()
def load_checkpoint_tensors(trainer, saved: dict, state):
    """Copy a monolithic tree-mode checkpoint (`checkpoint_tensors`, or a
    single device's) into this rank's `state`, resharded: each tensor's
    slice of the rank."""
    model = _check_trainer(trainer)
    names = _state_names(trainer)

    def mine(whole: dict) -> dict:
        return shard_tp_state_dict(whole, model.tp_specs, model.n_tp, model.tp_index)

    targets = state_tensors(state)
    if sorted(saved) != sorted(targets):
        raise KeyError(f"the checkpoint holds {sorted(saved)}, the state {sorted(targets)}")
    source = {}
    for part in ("params", "ema_params"):
        sliced = mine(_unflatten(saved[part], names, model.full_shapes))
        source[part] = torch.cat([sliced[n].reshape(-1) for n in names])
    for f in ("mu", "nu", "nu_max"):
        sliced = mine({n: saved[f"opt_state.{f}.{n}"] for n in names})
        source.update({f"opt_state.{f}.{n}": sliced[n] for n in names})
    for key, dst in targets.items():
        src = source.get(key, saved[key])
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"checkpoint {key}: {src.dtype}{tuple(src.shape)}, state "
                             f"{dst.dtype}{tuple(dst.shape)}")
        dst.copy_(src)
    return state
