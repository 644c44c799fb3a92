"""Pipeline parallelism: the block stack staged over the ranks of a process
group (port of `gemnet_pytorch_tpu/parallel/pp.py`).

GemNet's block stack is a chain of structurally identical interaction and
output block pairs, which maps onto a GPipe schedule:

- stage s (rank s of the group) holds the parameters of `num_blocks / S`
  consecutive block pairs (`PipelineStage`): the stack's parameters,
  optimizer moments and EMA are 1/S a rank;
- a step's M microbatches each carry a state (h, m, E_a, F_ca) that moves
  from rank s to rank s+1 with ONE neighbour shift a tick
  (`collectives.shift`, point to point);
- the preamble (geometry, bases, shared down-projections, embeddings,
  `out_blocks[0]`: `GemNet.preamble`) and the tail (`finalize_outputs`)
  run replicated on every rank, one microbatch at a time, so the pipelined
  program computes what the monolithic model computes;
- the bubble is (S-1)/(M+S-1) of the ticks; choose M >= 4*S.

The schedule (`_pipeline`): T = M + S - 1 ticks, the same program on every
rank. Each tick every rank shifts its state, rank 0 takes microbatch t's
preamble state in place of what it received, and rank s runs its stage on
microbatch t - s. The last rank's states of ticks S-1 .. T-1 are the
microbatches' outputs; every other rank contributes zeros to one psum of
them, which replicates them. Every rank builds the same autograd graph: it
runs its stage on every tick (on a tick it does not own, on the clipped
microbatch's constants, its result discarded by a `where`), takes every
injection and write through a `where`, and issues every shift. The
backward's collectives are then issued by the autograd engine in one order
on every rank (it runs ready nodes by sequence number), as the forward's
are. A rank that skipped the ticks it does not own would build another
graph, and its engine could order the backward's shifts and psums
otherwise. JAX unrolls its tick loop around a scan bug
(`gemnet_pytorch_tpu/parallel/pp.py:242-249`); a Python loop is unrolled
here by nature.

Gradients. JAX differentiates outside its `shard_map` with `check_vma=True`.
Here each rank's autograd sees only its own graph, and the port's rule
(`collectives.py`, `parallel/halo.py`) is the adjoint of the program
unrolled over the S ranks:

- every replicated scalar that every rank differentiates (the loss, the
  energy sum of -dE/dR) is seeded with 1/S;
- the psum of the outputs has a psum as its backward: the last stage's
  states get the whole cotangent, and the reverse shifts carry it, exact,
  down to rank 0's injection of the preamble states;
- so a stage's parameter gradient is exact on its own rank and is never
  all-reduced over pp; the preamble's (replicated) parameters carry one
  part of their gradient on each rank, and their flat gradient is
  all-reduced over the group; F = -psum(dE/dR) over the group.

The train step differentiates twice (its force loss backpropagates through
-dE/dR): the shift's backward is the reverse shift, a shift itself, and
psum's is a psum, so the rule holds again.

dp x pp: on a 2-D mesh (`mesh.make_hybrid_mesh(n_dp, n_pp)`, its rows the
pp groups) each row pipelines its own microbatches; the objective is the
sum of the rows' losses, the preamble's gradient is all-reduced over the
world and a stage's over its dp column (`make_pp_loss_and_grad`).
`PPTrainer` runs the pipeline alone, as JAX's does.

Parameter names. A stage keeps the monolithic names (`int_blocks.{i}`,
`out_blocks.{i+1}`), so `compat.state_dict_from_jax`, the reference export
and `flat_opt.build_masks` (which keys the shared scale on the top-level
name) work unchanged. JAX renames the blocks and their scale factors to
stage-local numbers (`_rename_scales`) only because ONE compiled program
runs on every device of its mesh; each rank here runs its own program.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models.gemnet import CARRY_KEYS, GemNet, finalize_outputs
from ..training import flat_opt
from . import mesh
from .collectives import all_gather, all_reduce_, psum, shift

# the keys of a batch the loss reads, stacked over the microbatches
TARGET_KEYS = ("E", "F", "mol_mask", "atom_mask")


# ======================================================================
# the split of the monolithic model
# ======================================================================


def stage_bounds(num_blocks: int, num_stages: int, stage: int) -> tuple[int, int]:
    """The blocks [start, stop) of `stage`."""
    if num_blocks % num_stages:
        raise ValueError(f"{num_blocks} blocks do not split into {num_stages} stages")
    k = num_blocks // num_stages
    return stage * k, (stage + 1) * k


def block_of(name: str) -> Optional[int]:
    """The block-loop index of a parameter or buffer name (`int_blocks.{i}`
    and `out_blocks.{i+1}` are block i), None for the preamble's."""
    parts = name.split(".")
    if parts[0] == "int_blocks":
        return int(parts[1])
    if parts[0] == "out_blocks" and int(parts[1]) > 0:
        return int(parts[1]) - 1
    return None


def _renumber(name: str, shift_by: int) -> str:
    """`name` of block i as the same tensor of block i + shift_by."""
    parts = name.split(".")
    parts[1] = str(int(parts[1]) + shift_by)
    return ".".join(parts)


def split_pp_state_dict(state_dict: dict, num_blocks: int, num_stages: int):
    """A monolithic state dict -> (the preamble's, [stage 0's, ..., stage
    S-1's]), every key under its monolithic name (JAX's
    `split_pp_variables`, without its stage-local renaming)."""
    k = stage_bounds(num_blocks, num_stages, 0)[1]
    pre, stages = {}, [{} for _ in range(num_stages)]
    for key, value in state_dict.items():
        i = block_of(key)
        (pre if i is None else stages[i // k])[key] = value
    return pre, stages


def merge_pp_state_dict(pre: dict, stages: list) -> dict:
    """The inverse of `split_pp_state_dict` (merges gradients too)."""
    out = dict(pre)
    for stage in stages:
        out.update(stage)
    return out


def stack_microbatches(batches: list) -> dict:
    """Stack per-microbatch padded numpy batches along a leading M axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


class PipelineStage(GemNet):
    """Rank `stage`'s part of GemNet: the preamble and the tail, and its
    `num_blocks / num_stages` consecutive block pairs (JAX's `PipelineStage`
    with the preamble's parameters beside it).

    The monolithic model is built on the CPU, where the generator draws
    every weight as `GemNet` draws them; the other stages' blocks are then
    dropped (an `nn.Identity` holds their place, so the names stay
    monolithic) and only the preamble and this stage move to `device`. A
    rank holds preamble + stack / S parameters: 53% and 30% of GemNet-Q's
    at config.yaml's widths for S = 2 and 4. The monolithic forward is
    refused; `make_pp_apply` runs the pipeline."""

    def __init__(self, cfg, stage: int, num_stages: int, *, generator: torch.Generator,
                 device="cuda"):
        if cfg.ep_axis is not None:
            # the halo and rung-2a models need per-block collectives a stage
            # does not issue (JAX pp.py:217-222)
            raise ValueError("pipeline parallelism does not compose with an edge partition "
                             "(ep_axis/ep_halo); use --halo or --dp-halo instead")
        super().__init__(cfg, generator=generator, device="cpu")
        self.stage, self.num_stages = stage, num_stages
        self.start, self.stop = stage_bounds(cfg.num_blocks, num_stages, stage)
        for i in range(cfg.num_blocks):
            if not self.start <= i < self.stop:
                self.int_blocks[i] = torch.nn.Identity()
                self.out_blocks[i + 1] = torch.nn.Identity()
        self.to(device)

    def forward(self, *args, **kwargs):
        raise TypeError("a PipelineStage holds one stage of the block stack: run it with "
                        "parallel.pp.make_pp_apply over its process group")

    def run_stage(self, carry, consts):
        """This stage's block pairs on the carried state."""
        return self.run_blocks(carry, consts, self.start, self.stop)

    def named_parts(self) -> tuple[list, list]:
        """(the preamble's, this stage's) named parameters, each in
        `named_parameters()` order."""
        pre, stage = [], []
        for name, p in self.named_parameters():
            (pre if block_of(name) is None else stage).append((name, p))
        return pre, stage

    def state_buffers(self) -> tuple[list, list]:
        """(the preamble's, this stage's) named buffers of the state dict
        (the scale factors, the basis' persistent constants)."""
        params = dict(self.named_parameters())
        pre, stage = [], []
        for name, t in self.state_dict(keep_vars=True).items():
            if name not in params:
                (pre if block_of(name) is None else stage).append((name, t))
        return pre, stage


# ======================================================================
# the schedule
# ======================================================================


def _groups(group):
    """(pp group, dp group, world) of a process group (pp alone) or of a
    `mesh.HybridMesh` (dp x pp: its rows pipeline)."""
    if isinstance(group, mesh.HybridMesh):
        return group.pp, group.dp, group.world
    return group, None, group


def _place(pp_group) -> tuple[int, int]:
    """(this rank's stage, the number of stages)."""
    if pp_group is None:
        return 0, 1
    return mesh.rank(pp_group), mesh.world_size(pp_group)


_FLAGS: dict = {}


def _flags(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(False, True) as bool scalars on `device`, made once (outside any CUDA
    graph capture: a captured step warms up first): the conditions of the
    schedule's `where`s, which are a rank's, not the graph's."""
    device = torch.device(device)
    if device not in _FLAGS:
        _FLAGS[device] = (torch.zeros((), dtype=torch.bool, device=device),
                          torch.ones((), dtype=torch.bool, device=device))
    return _FLAGS[device]


def _check_stage(stage: PipelineStage, pp_group) -> None:
    s, n = _place(pp_group)
    if (stage.stage, stage.num_stages) != (s, n):
        raise ValueError(f"the model is stage {stage.stage} of {stage.num_stages}, the rank is "
                         f"stage {s} of {n}")


def _pipeline(stage: PipelineStage, states: list, pp_group):
    """The GPipe schedule (module docstring) over the preamble `states` of
    M microbatches: (E_a, F_ca) of each, stacked (M, ...), replicated."""
    s, n = _place(pp_group)
    M = len(states)
    false, true = _flags(states[0]["h"].device)
    first, last = (true if s == 0 else false), (true if s == n - 1 else false)
    carries = [tuple(st[k] for k in CARRY_KEYS) for st in states]
    state = tuple(torch.zeros_like(c) for c in carries[0])
    out_e, out_f = [], []
    for t in range(M + n - 1):
        state = shift(state, pp_group)
        # stage 0 takes microbatch t's preamble state (past M: the last)
        state = tuple(torch.where(first, a, b) for a, b in zip(carries[min(t, M - 1)], state))
        mb = t - s  # the microbatch on this stage at this tick
        new = stage.run_stage(state, states[min(max(mb, 0), M - 1)])
        valid = true if 0 <= mb < M else false
        state = tuple(torch.where(valid, a, b) for a, b in zip(new, state))
        if t >= n - 1:  # the last stage finishes microbatch t - (S - 1)
            out_e.append(torch.where(last, state[2], 0.0))
            out_f.append(torch.where(last, state[3], 0.0))
    return psum(torch.stack(out_e), pp_group), psum(torch.stack(out_f), pp_group)


def _outputs(stage: PipelineStage, batches: list, pp_group, R=None):
    """(E, F_raw) of the M microbatches, stacked (M, ...): the model's raw
    second output (per-atom with direct forces, the per-edge heads
    otherwise), replicated over the pp group."""
    cfg = stage.cfg
    states = [stage.preamble(b, None if R is None else R[i]) for i, b in enumerate(batches)]
    E_a, F_ca = _pipeline(stage, states, pp_group)
    outs = [finalize_outputs(cfg, b, E_a[i], F_ca[i], st["V_ca"])
            for i, (b, st) in enumerate(zip(batches, states))]
    return torch.stack([e for e, _ in outs]), torch.stack([f for _, f in outs])


def make_pp_apply(stage: PipelineStage, group):
    """(batches) -> (E, F_raw) with leading (M,) axes, the same on every
    rank: `batches` is the rank's list of M microbatches (tensor dicts of one
    padding), `group` the pp group or a dp x pp `mesh.HybridMesh`."""
    pp_group = _groups(group)[0]
    _check_stage(stage, pp_group)
    return lambda batches: _outputs(stage, batches, pp_group)


def _energy_and_forces(stage: PipelineStage, batches: list, pp_group,
                       create_graph: bool = False):
    cfg = stage.cfg
    if cfg.direct_forces:
        return _outputs(stage, batches, pp_group)
    if cfg.num_targets != 1:
        # the energy sum folds the targets into one gradient (JAX pp.py:330-335)
        raise ValueError("the pipeline's -dE/dR force path supports num_targets == 1 only")
    _, n = _place(pp_group)
    R = [b["R"].detach().requires_grad_(True) for b in batches]
    with torch.enable_grad():
        E, _ = _outputs(stage, batches, pp_group, R)
        energy = E.sum() if n == 1 else E.sum() * (1.0 / n)
        dE_dR = torch.autograd.grad(energy, R, create_graph=create_graph)
    if not create_graph:
        E = E.detach()
    return E, -psum(torch.stack(dE_dR), pp_group)[:, :, None, :]


def make_pp_energy_and_forces(stage: PipelineStage, group):
    """(batches, create_graph=False) -> (E, F) with leading (M,) axes and
    the variant's force path: the direct head, or F = -dE/dR through the
    whole pipeline, shifts included (exact and replicated: the energy sum
    seeded with 1/S, F = -psum(dE/dR) over the pp group)."""
    pp_group = _groups(group)[0]
    _check_stage(stage, pp_group)
    return lambda batches, create_graph=False: _energy_and_forces(stage, batches, pp_group,
                                                                  create_graph)


def stacked_targets(batches: list) -> dict:
    """The loss's keys of M microbatches, stacked (M, ...)."""
    return {k: torch.stack([b[k] for b in batches]) for k in TARGET_KEYS}


def pp_gradients(stage: PipelineStage, loss, group):
    """The flat (preamble, stage) gradients of a loss every rank of the pp
    group holds alike: seeded with 1/S; the preamble's all-reduced over the
    world (pp, or dp x pp), the stage's over the dp column only (module
    docstring)."""
    pp_group, dp_group, world = _groups(group)
    _, n = _place(pp_group)
    pre, st = stage.named_parts()
    params = [p for _, p in pre] + [p for _, p in st]
    grads = torch.autograd.grad(loss if n == 1 else loss * (1.0 / n), params,
                                allow_unused=True, materialize_grads=True)
    flat = [g.reshape(-1) for g in grads]
    g_pre = all_reduce_(torch.cat(flat[:len(pre)]), world)
    g_st = all_reduce_(torch.cat(flat[len(pre):]), dp_group)
    return g_pre, g_st


def _unflatten(flat: torch.Tensor, named: list) -> dict:
    out, off = {}, 0
    for name, p in named:
        out[name] = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return out


def make_pp_loss_and_grad(stage: PipelineStage, group, loss_fn):
    """(batches) -> (loss, grads): `loss_fn(E, F, targets)` over the stacked
    (M, ...) outputs and `stacked_targets(batches)`, and its gradient by
    parameter name (the preamble's and this stage's), exact. Under dp x pp
    (`group` a HybridMesh) the objective is the sum of the rows' losses
    (`loss_fn` a sum, as JAX's tests take it): the loss returned is that
    sum, the gradients those of it."""
    pp_group, dp_group, _ = _groups(group)
    _check_stage(stage, pp_group)

    def loss_and_grad(batches):
        E, F = _energy_and_forces(stage, batches, pp_group, create_graph=True)
        loss = loss_fn(E, F, stacked_targets(batches))
        g_pre, g_st = pp_gradients(stage, loss, group)
        pre, st = stage.named_parts()
        total = all_reduce_(loss.detach().clone(), dp_group)
        return total, {**_unflatten(g_pre, pre), **_unflatten(g_st, st)}

    return loss_and_grad


# ======================================================================
# training
# ======================================================================


@dataclasses.dataclass
class PPState:
    """A pipeline rank's train state: the preamble's and this stage's flat
    fp32 vectors ("pre", "stage"), each with its optimizer state and EMA
    (JAX's `TrainState` with `params={"pre": ..., "stage": ...}`)."""

    step: torch.Tensor
    params: dict
    opt_state: dict
    ema_params: dict
    metric_acc: torch.Tensor


PARTS = ("pre", "stage")


def state_tensors(state: PPState) -> dict:
    """Every tensor of the state, by checkpoint key."""
    out = {"step": state.step, "metric_acc": state.metric_acc}
    for part in PARTS:
        out[f"params.{part}"] = state.params[part]
        out[f"ema_params.{part}"] = state.ema_params[part]
        for f in dataclasses.fields(state.opt_state[part]):
            out[f"opt_state.{part}.{f.name}"] = getattr(state.opt_state[part], f.name)
    return out


def _is_stage_key(key: str) -> bool:
    return ".stage" in key


class PPTrainer:
    """The pipeline's training driver (JAX `parallel/pp.py:386-575`), over
    `trainer` (a Trainer of a `PipelineStage`), the pp process group and
    `num_micro` microbatches a step.

    State: the preamble's parameters in one flat vector, replicated; this
    stage's in another, 1/S of the stack (`PPState`), each with its
    `flat_opt` state and EMA. The global-norm clip spans both parts:
    gnorm^2 = |g_pre sc|^2 + psum_pp(|g_stage sc|^2), fed to both updates
    through `flat_opt.apply_update(clip_scale=...)`, as the single-device
    optimizer clips the whole gradient.

    Numerics: the loss is `Trainer.loss_metrics_from_outputs` over the
    microbatch stack flattened to one row space (JAX `_flatten_micro`), the
    loss of the concatenated M-microbatch batch: a pp step is a
    single-device step on that batch.

    `train_step_fn()` is captured into a CUDA graph where the group is NCCL
    (or absent), as the dp, halo and ep steps are; eager on gloo and the
    CPU."""

    def __init__(self, trainer, group, num_micro: int):
        stage = trainer.model
        if not isinstance(stage, PipelineStage):
            raise TypeError("PPTrainer trains a PipelineStage (the Trainer's model)")
        _check_stage(stage, group)
        if trainer.mve or not trainer.flat:
            raise NotImplementedError("the pipeline trains with the flat optimizer and without "
                                      "MVE, as JAX's PPTrainer")
        self.trainer, self.model, self.group = trainer, stage, group
        self.M = num_micro
        self.stage, self.S = _place(group)
        self.device = trainer.device
        self.pre_named, self.stage_named = stage.named_parts()
        self._captured = None

    # -- state --
    def init_state(self) -> PPState:
        """Flatten the preamble's and the stage's parameters into their two
        buffers (the parameters become their views) and start both
        optimizers, EMAs and the metric accumulators."""
        trainer, cfg, dev = self.trainer, self.model.cfg, self.device
        params, opt, ema = {}, {}, {}
        for part, named in zip(PARTS, (self.pre_named, self.stage_named)):
            flat = flat_opt.flatten_named(named)
            wd, sc = flat_opt.build_masks(((n, p.shape) for n, p in named), cfg,
                                          trainer.cfg.weight_decay, dev)
            params[part], opt[part], ema[part] = flat, flat_opt.init(flat, wd, sc), flat.clone()
        return PPState(step=torch.zeros((), dtype=torch.int32, device=dev), params=params,
                       opt_state=opt, ema_params=ema,
                       metric_acc=torch.zeros((len(trainer.tracked_metrics), 2), device=dev))

    def merged_state_dict(self, state: PPState, ema: bool = False) -> dict:
        """The monolithic model's state dict (CPU tensors) of the current or
        the EMA weights, on every rank: the stages' vectors and scale
        factors all-gathered (collective; JAX's `merged_variables`). Every
        stage has the same blocks, so the vectors have one length."""
        params = state.ema_params if ema else state.params
        out = {n: t.detach().cpu().clone() for n, t in _unflatten(
            params["pre"], self.pre_named).items()}
        pre_bufs, bufs = self.model.state_buffers()
        out.update({n: b.detach().cpu().clone() for n, b in pre_bufs})
        stages = all_gather(params["stage"], self.group).cpu()
        flat_bufs = torch.cat([b.detach().reshape(-1).float() for _, b in bufs]) if bufs else None
        gathered = all_gather(flat_bufs, self.group).cpu() if bufs else None
        k = self.model.stop - self.model.start
        for s in range(self.S):
            delta = (s - self.stage) * k
            for name, t in _unflatten(stages[s], self.stage_named).items():
                out[_renumber(name, delta)] = t.clone()
            off = 0
            for name, b in bufs:
                out[_renumber(name, delta)] = gathered[s][off:off + b.numel()].view_as(
                    b).to(b.dtype).clone()
                off += b.numel()
        return out

    def checkpoint_tensors(self, state: PPState) -> dict:
        """The checkpoint of the whole pipeline (collective): the preamble's
        tensors and every stage's, gathered into (S, ...) rows."""
        out = {}
        for key, t in state_tensors(state).items():
            out[key] = all_gather(t, self.group) if _is_stage_key(key) else t
        return out

    @torch.no_grad()
    def load_checkpoint_tensors(self, saved: dict, state: PPState) -> PPState:
        """Copy a `checkpoint_tensors` dict into `state`, this rank's row of
        each stage tensor; the checkpoint must be of S stages."""
        targets = state_tensors(state)
        if sorted(saved) != sorted(targets):
            raise KeyError(f"the checkpoint holds {sorted(saved)}, the state {sorted(targets)}")
        for key, dst in targets.items():
            src = saved[key]
            if _is_stage_key(key):
                if src.shape[0] != self.S:
                    raise ValueError(f"the checkpoint holds {src.shape[0]} stages, the run "
                                     f"{self.S}")
                src = src[self.stage]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"checkpoint {key}: {src.dtype}{tuple(src.shape)}, state "
                                 f"{dst.dtype}{tuple(dst.shape)}")
            dst.copy_(src)
        return state

    # -- steps --
    def _loss_and_metrics(self, batches: list):
        trainer = self.trainer
        E, F = _energy_and_forces(self.model, batches, self.group, create_graph=True)
        # the microbatch stack as one row space (JAX `_flatten_micro`)
        flat = {k: torch.cat([b[k] for b in batches]) for k in TARGET_KEYS}
        outputs = trainer._split_outputs(E.reshape((-1,) + E.shape[2:]),
                                         F.reshape((-1,) + F.shape[2:]))
        return trainer.loss_metrics_from_outputs(*outputs, flat)

    def train_step(self, state: PPState, batches: list, lr_scale):
        """The eager step on M microbatches of tensors: the loss through the
        pipeline, its gradients (`pp_gradients`), the clip over both parts,
        both updates, the EMA and the metric accumulation (in place).
        Returns (state, metrics, counts), the metrics on the device."""
        trainer, tcfg = self.trainer, self.trainer.cfg
        if len(batches) != self.M:
            raise ValueError(f"{len(batches)} microbatches, the pipeline takes {self.M}")
        if not isinstance(lr_scale, torch.Tensor):
            trainer._lr_scale.fill_(lr_scale)
            lr_scale = trainer._lr_scale
        loss, (metrics, counts) = self._loss_and_metrics(batches)
        g_pre, g_st = pp_gradients(self.model, loss, self.group)
        opt = state.opt_state
        with torch.no_grad():
            sq_pre = torch.sum((g_pre * opt["pre"].shared_scale) ** 2)
            sq_st = all_reduce_(torch.sum((g_st * opt["stage"].shared_scale) ** 2).reshape(1),
                                self.group)[0]
            gnorm = torch.sqrt(sq_pre + sq_st)
            clip = torch.where(gnorm < tcfg.grad_clip_max, torch.ones_like(gnorm),
                               tcfg.grad_clip_max / gnorm)
        kw = dict(schedule=trainer._sched_base, learning_rate=tcfg.learning_rate,
                  grad_clip_max=tcfg.grad_clip_max, ema_decay=tcfg.ema_decay, clip_scale=clip)
        for part, g in zip(PARTS, (g_pre, g_st)):
            flat_opt.apply_update(g, opt[part], state.params[part], state.ema_params[part],
                                  lr_scale, **kw)
        metrics = {k: v.detach() for k, v in metrics.items()}
        state.step += 1
        state.metric_acc.copy_(trainer.accumulate_metrics(state.metric_acc, metrics, counts))
        return state, metrics, counts

    def _rows(self, batches) -> np.ndarray:
        """M host batches (or their packed rows) as one (M, total) stack."""
        if isinstance(batches, np.ndarray):
            return batches
        packer = self.trainer.packer
        return np.stack([b if isinstance(b, np.ndarray) else packer.pack(b) for b in batches])

    def _device_batches(self, batches) -> list:
        trainer = self.trainer
        if isinstance(batches, (np.ndarray, torch.Tensor)):
            return [trainer._device_batch(row) for row in batches]
        return [trainer._device_batch(b) for b in batches]

    def _step_graph(self, state: PPState, rows):
        """The captured step for `state` and the packer's layout, capturing
        it where there is none; `rows` (M, total) go into its static buffer."""
        from .. import graphs

        trainer = self.trainer
        key = (trainer.packer.version,
               *(t.data_ptr() for t in state_tensors(state).values()))
        if self._captured is not None and self._captured[0] == key:
            trainer.packer.to_device(rows, self.device, out=self._captured[2])
            return self._captured[1]
        self._captured = None  # frees the old graph and its pool
        buf = torch.empty((self.M, trainer.packer.total), dtype=torch.int32, device=self.device)
        trainer.packer.to_device(rows, self.device, out=buf)
        batches = [trainer.packer.unpack(buf[i]) for i in range(self.M)]
        snapshot = list(state_tensors(state).values())
        saved = [t.clone() for t in snapshot]

        def restore():  # the warm-up's steps leave no trace in the state
            for t, v in zip(snapshot, saved):
                t.copy_(v)

        cap = graphs.capture(lambda: self.train_step(state, batches, trainer._lr_scale)[1:],
                             self.device, before_capture=restore, debug=trainer.graph_debug)
        self._captured = (key, cap, buf)
        return cap

    def train_step_fn(self):
        """(state, batches, lr_scale) -> (state, metrics, counts): `batches`
        M host batches of one padding, or their packed (M, total) rows. On
        a CUDA trainer whose group is NCCL (or none) the step is captured
        and replayed (the metrics are the graph's outputs, overwritten by the
        next call); otherwise the eager step on the unpacked batches."""
        if self.device.type != "cuda" or not mesh.capturable(self.group):
            return lambda state, batches, lr_scale: self.train_step(
                state, self._device_batches(batches), lr_scale)

        def step(state, batches, lr_scale):
            cap = self._step_graph(state, self._rows(batches))
            self.trainer._lr_scale.fill_(lr_scale)
            cap.graph.replay()
            return (state, *cap.outputs)

        return step

    def train_on_microbatches(self, state: PPState, batches, lr_scale):
        """One pp train step over M host batches (`train_step_fn()`).
        Returns (state, the step's loss on the device)."""
        state, metrics, _ = self.train_step_fn()(state, batches, lr_scale)
        return state, metrics["loss"].clone()
