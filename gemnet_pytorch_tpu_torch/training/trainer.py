"""Training stack: loss, optimizers, EMA, train and eval steps (port of
`gemnet_pytorch_tpu/training/trainer.py`; reference
gemnet/training/trainer.py).

- loss = (1-rho_force)·MAE(E) + rho_force·{MAE|RMSE}(F), or with OCP's
  `energy_coefficient` and `force_coefficient` their weights in place of
  rho_force's, or under MVE (`mve=True`, num_targets=2) the Gaussian NLL of
  both, with softplus variances (reference trainer.py:292-343), masked
  over padded rows; a batch with a `free_mask` (OC20's tags) counts the
  free atoms' forces alone, in the loss and the force metrics;
- the flat optimizer (`flat_opt.apply_update`: shared-gradient scaling,
  global-norm clip, AdamW/Adam(amsgrad), EMA) over one flat fp32 buffer
  whose views are the model's parameters; or, with `flat_optimizer=False`
  or AGC, the per-tensor chain of `tree_opt` over those same views (the JAX
  package's optax tree mode, trainer.py:422);
- metrics accumulate on the device, as (n_metrics, 2) rows of
  [weighted sum, weight], and reach the host only in `drain_metrics`, so a
  train step never waits for the device.

A train step is eager PyTorch: `energy_and_forces(..., create_graph=True)`
builds the force graph (F = -dE/dR), and `torch.autograd.grad` of the loss
differentiates through it (grad-of-grad) to the parameters; the
concatenated parameter gradients are the gradient of the flat buffer. On a
CUDA model every segment reduction of both backwards runs the kernels K1, K2
and K3, in fp32 or on bf16 streams as the model's compute_dtype says; the
parameters, gradients, optimizer state and EMA are fp32 in both modes.

The compiled step (trainer.py:615-701): `train_step_fn()` is the
counterpart of the jitted step and `multi_step_fn()` of the scan of K steps.
On a CUDA trainer the first call captures the whole step (forward, the force
graph, the grad-of-grad, the update, EMA and the metric accumulation) into a
CUDA graph (`graphs.capture`) over a static packed input buffer
(`data.packer.BatchPacker`, one host->device copy per call) and every call
replays it; it captures again when the packer's layout version or the
state's buffers change. The state is updated in place (its addresses are
what the graph reads), and the plateau's `lr_scale` reaches the step as a
device scalar filled before each call. A failed capture raises: a CUDA
trainer never falls back to the eager step. On a CPU trainer both run the
eager step on the unpacked batch. `train_step` is the eager step: the CPU
path, and the reference the captured step is held against on the card.

The eval step and the predict (trainer.py:701-722) are captured as well:
`eval_step_fn()` and `predict_fn()` capture the forward, -dE/dR for the
non-direct variants, and the loss and metrics or the split outputs, over a
static packed buffer of their own, keyed on the packer's version and on the
buffer the parameter views are bound to (`weights(use_ema=True)` binds them
to the EMA buffer), so a graph never replays against the other weights.
`test_on_batch`, which `train.py`'s validation calls, goes through it;
`eval_step` and `predict` are the eager versions.

The parallel modes (`parallel/dp.py`, `halo.py`, `ep.py`, `hybrid.py`) run
the same steps with up to three more arguments. `group`, data
parallelism's process group: each loss term is the rank's LOCAL numerator
over the GLOBAL denominator and each reported metric the all-reduced
numerator over it (`_ratios`, trainer.py:359-378), the counts are global,
and the flat gradient is all-reduced once (the per-tensor gradients as one
coalesced buffer). `model`, a halo or ep view of the trainer's model
(`parallel.halo.halo_model`, `parallel.ep.ep_model`, sharing its
parameters): E and F come out replicated over the view's group, the loss
is seeded with 1/P of that group, and the gradient is all-reduced over it.
Both at once are a hybrid mesh's step (`parallel/hybrid.py`): the loss's
num/den over the dp `group`, the seed 1/n_ep over the model's ep group,
and the flat gradient all-reduced once over `grad_group`, the world of
both. A step whose collectives all run on NCCL groups is captured with
them in the graph; on a gloo group (collectives on the host)
`train_step_fn()` and `eval_step_fn()` run the eager step.

A subclass whose own model runs over process groups (tensor parallelism,
`parallel.tp.TPTrainer`) overrides `process_groups`, `gradients` and
`grad_norm`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import graphs
from ..config import TrainConfig
from ..data.batch import to_torch
from ..data.packer import BatchPacker
from ..models.gemnet import GemNet, energy_and_forces
from ..parallel import mesh
from ..parallel.collectives import all_reduce_
from ..perf import spans
from . import flat_opt, tree_opt
from .schedules import linear_warmup_exponential_decay

MOL_METRICS = frozenset({"loss", "energy_mae", "energy_nll", "energy_var"})
# captured eval/predict graphs kept per kind: the current and the EMA weights
FORWARD_GRAPHS = 2


@dataclass
class TrainState:
    step: torch.Tensor  # int32 scalar on the device
    # ONE contiguous fp32 vector; the model's parameters are views of it
    params: torch.Tensor
    # flat mode: flat_opt.FlatOptState; tree mode: tree_opt.TreeOptState
    opt_state: flat_opt.FlatOptState | tree_opt.TreeOptState
    ema_params: torch.Tensor
    # (n_metrics, 2) rows of [weighted sum, weight] in Trainer.tracked_metrics
    # order, drained by Trainer.drain_metrics
    metric_acc: torch.Tensor


# ----------------------------------------------------------------- loss/metrics


def _mae_parts(pred, target, mask):
    """(sum |err|·mask, n_real_elements) — reference get_mae as num/den."""
    m = mask.to(pred.dtype).reshape((-1,) + (1,) * (pred.ndim - 1))
    feat = pred.numel() // pred.shape[0]
    return torch.sum(torch.abs(pred - target) * m), torch.sum(m) * feat


def _rmse_parts(pred, target, mask):
    """(sum of per-row L2 norms, n_real_rows) — reference get_rmse as num/den."""
    m = mask.to(pred.dtype)
    err = pred - target
    norms = torch.sqrt(torch.clamp_min(torch.sum(err * err, dim=-1), 1e-24))
    return torch.sum(norms * m), torch.sum(m)


def _ratios(parts, group=None):
    """(loss term, metric) from a (num, den) pair (trainer.py:359-378).

    On one device (`group` None) both are num/den. Under data parallelism
    the differentiated loss term is the LOCAL numerator over the GLOBAL
    denominator: the ranks' gradients, all-reduced, are then the exact
    gradient of the global masked mean (an all-reduced numerator would
    count every rank's gradient P times). The reported metric is the
    all-reduced numerator over the global denominator; no gradient flows
    through it (the denominators are mask counts)."""
    num, den = parts
    if group is None:
        local = num / torch.clamp_min(den, 1.0)
        return local, local
    den_global = torch.clamp_min(all_reduce_(den.detach().clone(), group), 1.0)
    return num / den_global, all_reduce_(num.detach().clone(), group) / den_global


def _ratio(parts):
    """Mean from a (num, den) pair on one device."""
    return _ratios(parts)[1]


def masked_mae(pred, target, mask):
    return _ratio(_mae_parts(pred, target, mask))


def _nll_parts(pred_mean, pred_var, target, mask):
    """Gaussian NLL as num/den (torch gaussian_nll_loss semantics: var
    clamped at 1e-6, 0.5·(log var + err²/var), mean reduction)."""
    m = mask.to(pred_mean.dtype).reshape((-1,) + (1,) * (pred_mean.ndim - 1))
    var = torch.clamp_min(pred_var, 1e-6)
    nll = 0.5 * (torch.log(var) + (pred_mean - target) ** 2 / var)
    feat = pred_mean.numel() // pred_mean.shape[0]
    return torch.sum(nll * m), torch.sum(m) * feat


def masked_rmse(pred, target, mask):
    return _ratio(_rmse_parts(pred, target, mask))


def masked_nll(pred_mean, pred_var, target, mask):
    return _ratio(_nll_parts(pred_mean, pred_var, target, mask))


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a train step updates in place."""
    st = state.opt_state
    if isinstance(st, tree_opt.TreeOptState):
        opt = [st.count, *st.mu.values(), *st.nu.values(), *st.nu_max.values()]
    else:
        opt = [st.count, st.mu, st.nu, st.nu_max]
    return [state.step, state.params, state.ema_params, state.metric_acc, *opt]


def flat_gradient(loss, params, group=None, replicated=None) -> torch.Tensor:
    """The gradient of `loss` over `params` as one flat buffer, all-reduced
    over `group` in one collective (dp.py:62). `replicated`: the group over
    which every rank holds the same `loss` (a halo or ep model's group) and
    its program computes one part of the gradient; the loss is seeded with
    1/P on each of its P ranks, so the all-reduce sums the parts to the
    exact gradient. `Trainer.train_step` and the parallel modes'
    loss-and-grad functions all take their gradient here."""
    if replicated is not None:
        loss = loss * (1.0 / mesh.world_size(replicated))
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)


def _model_group(model):
    """The process group a partitioned model (halo or ep view) runs over."""
    return model.group if model is not None and model.cfg.ep_axis is not None else None


def _reduce_group(group, model, grad_group=None):
    """The group a step's gradient is all-reduced over: `grad_group` where
    given (the world of a hybrid mesh, whose dp `group` and model group are
    its rows and columns), else data parallelism's or a partitioned
    model's."""
    for g in (grad_group, group):
        if g is not None:
            return g
    return _model_group(model)


# ------------------------------------------------------------------- trainer


class Trainer:
    """Train and eval steps for a GemNet model + TrainConfig, on the
    model's device."""

    def __init__(self, model: GemNet, cfg: TrainConfig):
        if cfg.mve and model.cfg.num_targets != 2:
            raise ValueError(f"mve needs num_targets=2 (a mean and a variance head), the model "
                             f"has {model.cfg.num_targets}")
        if not 0 <= cfg.rho_force <= 1:
            raise ValueError(f"rho_force {cfg.rho_force} outside [0, 1]")
        if cfg.loss not in ("mae", "rmse"):
            raise ValueError(f"loss {cfg.loss!r}: 'mae' or 'rmse'")
        self.model = model
        self.cfg = cfg
        self.model_cfg = model.cfg
        self.rho_force = float(cfg.rho_force)
        coefficients = (cfg.energy_coefficient, cfg.force_coefficient)
        if (coefficients[0] is None) != (coefficients[1] is None):
            raise ValueError("set both energy_coefficient and force_coefficient, or neither")
        if coefficients[0] is not None and cfg.mve:
            raise ValueError("OCP's loss coefficients do not apply to MVE's NLL")
        # (energy, force) weights of the loss: OCP's coefficients, else rho_force's
        self.loss_weights = ((float(coefficients[0]), float(coefficients[1]))
                             if coefficients[0] is not None
                             else (1 - self.rho_force, self.rho_force))
        self.mve = cfg.mve
        # JAX runs AGC in tree mode only (trainer.py:422)
        self.flat = cfg.flat_optimizer and not cfg.agc
        self.layout = None  # tree mode: tree_opt.TreeLayout, set by init_state
        self.device = next(model.parameters()).device
        self.tracked_metrics = (
            ["loss", "energy_mae", "energy_nll", "energy_var",
             "force_mae", "force_rmse", "force_nll", "force_var"]
            if self.mve else ["loss", "energy_mae", "force_mae", "force_rmse"])
        self._mol_metric = torch.tensor(
            [k in MOL_METRICS for k in self.tracked_metrics], device=self.device)
        self._sched_base = linear_warmup_exponential_decay(
            cfg.warmup_steps, cfg.decay_steps, cfg.decay_rate, cfg.staircase)
        self.packer = BatchPacker()
        # the step's lr_scale: a device scalar filled before each step
        self._lr_scale = torch.ones((), device=self.device)
        # the captured single step: (key, graphs.Captured, static input
        # buffer); key = (packer version, the state's buffer addresses)
        self._captured = None
        # the captured eval and predict: kind -> {(packer version, bound
        # buffer address): (graphs.Captured, static input buffer)}
        self._forward_captured = {"eval": {}, "predict": {}}
        # keep the captured graph for graphs.kernel_nodes (chip_smoke.py)
        self.graph_debug = False

    # -- state management --
    def init_state(self) -> TrainState:
        """Flatten the model's parameters into the state's buffer (the
        parameters become its views) and start the optimizer, EMA and metric
        accumulators."""
        flat = flat_opt.flatten_parameters(self.model)
        if self.flat:
            wd, sc = flat_opt.build_masks(
                ((n, p.shape) for n, p in self.model.named_parameters()),
                self.model_cfg, self.cfg.weight_decay, self.device)
            opt_state = flat_opt.init(flat, wd, sc)
        else:
            self.layout = tree_opt.build_layout(self.model, self.model_cfg)
            opt_state = tree_opt.init(self.layout, self.device)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            params=flat,
            opt_state=opt_state,
            ema_params=flat.clone(),
            metric_acc=torch.zeros((len(self.tracked_metrics), 2), device=self.device),
        )

    @contextlib.contextmanager
    def weights(self, state: TrainState, use_ema: bool):
        """Run the model on the EMA weights (rebinding the parameter views,
        no copy) inside the block when `use_ema`."""
        if not use_ema:
            yield
            return
        flat_opt.bind_parameters(self.model, state.ema_params)
        try:
            yield
        finally:
            flat_opt.bind_parameters(self.model, state.params)

    def _device_batch(self, batch):
        """The eager step's input: a padded numpy batch (data.pad_batch) goes
        through data.to_torch onto the trainer's device, a packed row is
        moved there and unpacked, packed words already there are unpacked,
        and a batch of tensors passes as it is."""
        if isinstance(batch, np.ndarray):
            batch = self.packer.to_device(batch, self.device)
        if isinstance(batch, torch.Tensor):
            return self.packer.unpack(batch)
        return to_torch(batch, self.device) if isinstance(batch["Z"], np.ndarray) else batch

    # -- prediction/loss --
    def _split_outputs(self, E, F):
        """Raw model outputs -> (mean_E, var_E, mean_F, var_F); the variances
        are None without MVE (reference trainer.py:301-306 softplus split)."""
        if self.mve:
            return (E[:, :1], torch.nn.functional.softplus(E[:, 1:]), F[:, 0, :],
                    torch.nn.functional.softplus(F[:, 1, :]))
        return E, None, F[:, 0, :], None

    def _predict(self, batch, create_graph: bool = False, model=None):
        E, F = energy_and_forces(model or self.model, batch, create_graph=create_graph)
        return self._split_outputs(E, F)

    def _loss_and_metrics(self, batch, group=None, model=None, create_graph: bool = False):
        """(loss, (metrics, counts)) of `model` (default the trainer's) on a
        batch of tensors, under data parallelism over `group` where given
        (trainer.py:502-506)."""
        outputs = self._predict(batch, create_graph=create_graph, model=model)
        return self.loss_metrics_from_outputs(*outputs, batch, group=group)

    def loss_metrics_from_outputs(self, mean_E, var_E, mean_F, var_F, batch, group=None):
        """(loss, (metrics, counts)) from split model outputs + a batch dict
        carrying E/F targets and mol/atom masks (trainer.py:508-566). With a
        data-parallel `group`: the loss from local numerators over global
        denominators, every metric (MVE's variances too) and count global
        (`_ratios`)."""
        tE, tF = batch["E"], batch["F"]
        mol_mask = batch["mol_mask"]
        # the forces of the free atoms alone where the batch marks them
        # (OC20's train_on_free_atoms): its padded atoms are not free
        atom_mask = batch.get("free_mask", batch["atom_mask"])
        e_mae_loc, energy_mae = _ratios(_mae_parts(mean_E, tE, mol_mask), group)
        f_mae_loc, force_mae = _ratios(_mae_parts(mean_F, tF, atom_mask), group)
        f_rmse_loc, force_rmse = _ratios(_rmse_parts(mean_F, tF, atom_mask), group)
        if self.mve:
            e_nll_loc, energy_nll = _ratios(_nll_parts(mean_E, var_E, tE, mol_mask), group)
            f_nll_loc, force_nll = _ratios(_nll_parts(mean_F, var_F, tF, atom_mask), group)
            loss = (1 - self.rho_force) * e_nll_loc + self.rho_force * f_nll_loc
            # the mean variances, as num/den ratios (trainer.py:528-536)
            mm, am = mol_mask.to(var_E.dtype), atom_mask.to(var_F.dtype)
            _, energy_var = _ratios((torch.sum(var_E * mm[:, None]), torch.sum(mm)), group)
            _, force_var = _ratios((torch.sum(var_F * am[:, None]), 3 * torch.sum(am)), group)
            metrics = {
                "loss": (loss if group is None else
                         (1 - self.rho_force) * energy_nll + self.rho_force * force_nll),
                "energy_mae": energy_mae,
                "energy_nll": energy_nll,
                "energy_var": energy_var,
                "force_mae": force_mae,
                "force_rmse": force_rmse,
                "force_nll": force_nll,
                "force_var": force_var,
            }
        else:
            f_loc = f_mae_loc if self.cfg.loss == "mae" else f_rmse_loc
            f_glob = force_mae if self.cfg.loss == "mae" else force_rmse
            w_e, w_f = self.loss_weights
            loss = w_e * e_mae_loc + w_f * f_loc
            metrics = {
                "loss": loss if group is None else w_e * energy_mae + w_f * f_glob,
                "energy_mae": energy_mae,
                "force_mae": force_mae,
                "force_rmse": force_rmse,
            }
        counts = {
            "n_mol": torch.sum(mol_mask.float()),
            "n_atoms": torch.sum(atom_mask.float()),
        }
        if group is not None:
            counts = {k: all_reduce_(v, group) for k, v in counts.items()}
        return loss, (metrics, counts)

    # -- optimizer/EMA/metric-accumulator application --
    @torch.no_grad()
    def accumulate_metrics(self, acc, metrics, counts):
        vals = torch.stack([metrics[k] for k in self.tracked_metrics])
        w = torch.where(self._mol_metric, counts["n_mol"], counts["n_atoms"])
        return acc + torch.stack([vals * w, w], dim=1)

    def apply_update(self, state: TrainState, grads, metrics, counts, lr_scale) -> TrainState:
        """Gradients (flat mode: the flat vector; tree mode: one tensor per
        parameter) -> the state after optimizer + EMA + metric accumulation
        (in place: the parameter views see the new weights)."""
        cfg = self.cfg
        kw = dict(schedule=self._sched_base, learning_rate=cfg.learning_rate,
                  grad_clip_max=cfg.grad_clip_max, ema_decay=cfg.ema_decay)
        if self.flat:
            flat_opt.apply_update(grads, state.opt_state, state.params, state.ema_params,
                                  lr_scale, **kw)
        else:
            tree_opt.apply_update(grads, state.opt_state, self.layout, state.params,
                                  state.ema_params, lr_scale, weight_decay=cfg.weight_decay,
                                  agc=cfg.agc, agc_compat_reference=cfg.agc_compat_reference,
                                  norm_fn=self.grad_norm, **kw)
        state.step += 1
        # in place: a captured step reads and writes the accumulators' address
        state.metric_acc.copy_(self.accumulate_metrics(state.metric_acc, metrics, counts))
        return state

    # -- steps --
    def train_step(self, state: TrainState, batch, lr_scale, group=None, model=None,
                   grad_group=None):
        """The eager step on a batch of tensors (`data.to_torch`, or unpacked):
        loss, its gradient through the force graph, update. `lr_scale` is a
        float or a device scalar. `group` (data parallelism), `model` (a halo
        or ep view) and `grad_group` (a hybrid mesh's world) as the module
        docstring says. Returns (state, metrics, counts) with the metrics
        still on the device."""
        if not isinstance(lr_scale, torch.Tensor):
            self._lr_scale.fill_(lr_scale)
            lr_scale = self._lr_scale
        loss, (metrics, counts) = self._loss_and_metrics(batch, group, model, create_graph=True)
        grads = self.gradients(loss, group, model, grad_group)
        # detached: a caller holding the metrics holds no autograd graph
        metrics = {k: v.detach() for k, v in metrics.items()}
        return self.apply_update(state, grads, metrics, counts, lr_scale), metrics, counts

    def gradients(self, loss, group=None, model=None, grad_group=None):
        """The step's gradient of `loss` over the model's parameters, reduced
        over the step's groups (`train_step`): the flat vector in flat mode,
        one tensor per parameter in tree mode."""
        params = list(self.model.parameters())
        reduce_group = _reduce_group(group, model, grad_group)
        if not self.flat and reduce_group is None:
            return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        # one collective for the whole gradient (dp.py:62); a partitioned
        # model's loss is replicated over its group
        grads = flat_gradient(loss, params, reduce_group, replicated=_model_group(model))
        if self.flat:
            return grads
        # the per-tensor gradients, split again
        return [v.view_as(p) for v, p in zip(grads.split([p.numel() for p in params]), params)]

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm the tree-mode clip takes of the step's per-tensor
        gradients (the shared layers' already scaled)."""
        return tree_opt.global_norm(grads)

    def process_groups(self) -> tuple:
        """The process groups the trainer's own model runs over in every step
        (none: data parallelism's and a partitioned view's come with the
        step)."""
        return ()

    def _capturable(self, group=None, model=None, grad_group=None) -> bool:
        """Whether a step runs on the card and every group of it (`group`, a
        view `model`'s, `grad_group`, the trainer's own) captures into a
        CUDA graph."""
        groups = (group, _model_group(model), grad_group, *self.process_groups())
        return self.device.type == "cuda" and all(mesh.capturable(g) for g in groups)

    def _host_row(self, batch) -> np.ndarray:
        """A host batch (numpy dict) packed, or a packed row as it is."""
        return batch if isinstance(batch, np.ndarray) else self.packer.pack(batch)

    def _state_key(self, state: TrainState, group=None, model=None, grad_group=None):
        extra = (() if group is None and model is None and grad_group is None
                 else (id(group), id(model), id(grad_group)))
        return ((self.packer.version, *extra)
                + tuple(t.data_ptr() for t in _state_tensors(state)))

    def _step_graph(self, state: TrainState, fill, group=None, model=None, grad_group=None):
        """The captured step for `state` (and `group`, `model`, `grad_group`),
        capturing it where there is none for the packer's version and the
        state's buffers. `fill(buf)` puts the call's first input row into
        the static buffer first."""
        key = self._state_key(state, group, model, grad_group)
        if self._captured is not None and self._captured[0] == key:
            fill(self._captured[2])
            return self._captured[1]
        self._captured = None  # frees the old graph and its pool
        buf = torch.empty(self.packer.total, dtype=torch.int32, device=self.device)
        fill(buf)
        batch = self.packer.unpack(buf)
        snapshot = _state_tensors(state)
        saved = [t.clone() for t in snapshot]

        def restore():  # the warm-up's steps leave no trace in the state
            for t, v in zip(snapshot, saved):
                t.copy_(v)

        cap = graphs.capture(
            lambda: self.train_step(state, batch, self._lr_scale, group, model, grad_group)[1:],
            self.device, before_capture=restore, debug=self.graph_debug)
        self._captured = (key, cap, buf)
        return cap

    def train_step_fn(self, group=None, model=None, grad_group=None):
        """The counterpart of the jitted step (trainer.py:615-636): a callable
        (state, batch, lr_scale) -> (state, metrics, counts), `batch` a host
        batch (numpy dict), its packed row, or packed words already on the
        trainer's device. On a CUDA trainer it copies the row into the static
        buffer and replays the captured step (the metrics are the graph's
        outputs, overwritten by the next call); on a CPU trainer, or where
        the step's collectives run on a gloo group (`group`, a partitioned
        `model`'s or `grad_group`), it runs the eager step on the unpacked
        batch."""
        if not self._capturable(group, model, grad_group):
            return lambda state, batch, lr_scale: self.train_step(
                state, self._device_batch(batch), lr_scale, group, model, grad_group)

        def step(state, batch, lr_scale):
            if isinstance(batch, torch.Tensor):
                cap = self._step_graph(state, lambda buf: buf.copy_(batch), group, model,
                                       grad_group)
            else:
                row = self._host_row(batch)
                cap = self._step_graph(
                    state, lambda buf: self.packer.to_device(row, self.device, out=buf),
                    group, model, grad_group)
            self._lr_scale.fill_(lr_scale)
            with spans.span("replay"):
                cap.graph.replay()
            return (state, *cap.outputs)

        return step

    def multi_step_fn(self):
        """K steps per host call, the counterpart of the scan of
        trainer.py:638-683: a callable (state, packed, lr_scale) -> (state,
        metrics of the last step, counts of the last step), `packed` a (K,
        total) int32 stack of packed rows, numpy or on the trainer's device.
        On a CUDA trainer a numpy stack goes over in one host->device copy,
        and each step copies its row into the static buffer on the device
        and replays the single step's graph: K steps per call run what K
        single calls run (bit for bit where the step's ops are
        deterministic), and no K needs a capture of its own. On a CPU
        trainer: K eager steps."""
        if self.device.type != "cuda":
            def multi_cpu(state, packed, lr_scale):
                for row in packed:
                    state, metrics, counts = self.train_step(
                        state, self._device_batch(torch.as_tensor(row)), lr_scale)
                return state, metrics, counts

            return multi_cpu

        def multi(state, packed, lr_scale):
            rows = (packed if isinstance(packed, torch.Tensor)
                    else self.packer.to_device(packed, self.device))
            if rows.ndim != 2 or rows.shape[0] < 1:
                raise ValueError(f"packed rows {tuple(rows.shape)}: expected (K, total)")
            self._lr_scale.fill_(lr_scale)
            for k in range(rows.shape[0]):
                cap = self._step_graph(state, lambda buf: buf.copy_(rows[k]))
                with spans.span("replay"):
                    cap.graph.replay()
            return (state, *cap.outputs)

        return multi

    def train_on_batches(self, state: TrainState, batches, lr_scale):
        """K train steps in one host call (multi_step_fn): `batches` is a list
        of host batches or packed rows of one layout. Returns (state, the
        last step's loss on the device)."""
        packed = np.stack([self._host_row(b) for b in batches])
        state, metrics, _ = self.multi_step_fn()(state, packed, lr_scale)
        return state, metrics["loss"].clone()

    def _eval_outputs(self, batch, group=None, model=None):
        _, (metrics, counts) = self._loss_and_metrics(batch, group, model)
        return {k: v.detach() for k, v in metrics.items()}, counts

    def eval_step(self, state: TrainState, batch, use_ema: bool = False, group=None, model=None):
        """(metrics, counts) of the current or the EMA weights on a batch of
        tensors; no update. The eager eval step (`eval_step_fn()` captures
        it). `group`, `model` as `train_step` takes them."""
        with self.weights(state, use_ema):
            return self._eval_outputs(batch, group, model)

    def predict(self, state: TrainState, batch, use_ema: bool = False):
        """(mean_E, var_E, mean_F, var_F) of the current or the EMA weights,
        eagerly (`predict_fn()` captures it)."""
        with self.weights(state, use_ema):
            outputs = self._predict(self._device_batch(batch))
        return tuple(None if o is None else o.detach() for o in outputs)

    def _forward_graph(self, kind: str, fn, batch, key_extra=()):
        """The captured `fn(unpacked batch)` of `kind` for the packer's
        version, the buffer the parameter views are bound to now and
        `key_extra`, capturing it where there is none; `batch` (a host
        batch, its packed row, or packed words on the card) is first put
        into its static buffer."""
        if isinstance(batch, torch.Tensor):
            def fill(buf):
                buf.copy_(batch)
        else:
            row = self._host_row(batch)  # may move the packer to a new version

            def fill(buf):
                self.packer.to_device(row, self.device, out=buf)
        graphs_of = self._forward_captured[kind]
        key = (self.packer.version, next(self.model.parameters()).data_ptr(), *key_extra)
        if key in graphs_of:
            cap, buf = graphs_of[key]
            fill(buf)
            return cap
        for stale in [k for k in graphs_of if k[0] != self.packer.version]:
            del graphs_of[stale]
        while len(graphs_of) >= FORWARD_GRAPHS:
            del graphs_of[next(iter(graphs_of))]  # frees the oldest graph and its pool
        buf = torch.empty(self.packer.total, dtype=torch.int32, device=self.device)
        fill(buf)
        unpacked = self.packer.unpack(buf)
        cap = graphs.capture(lambda: fn(unpacked), self.device, debug=self.graph_debug)
        graphs_of[key] = (cap, buf)
        return cap

    def eval_step_fn(self, group=None, model=None):
        """The counterpart of the jitted eval step (trainer.py:701-715): a
        callable (state, batch, use_ema=False) -> (metrics, counts), `batch`
        a host batch, its packed row or packed words on the trainer's
        device. On a CUDA trainer it replays the captured eval of the
        weights `use_ema` selects (the outputs are the graph's, overwritten
        by its next replay); on a CPU trainer, or over a gloo group (as
        `train_step_fn`), it runs `eval_step`."""
        if not self._capturable(group, model):
            return lambda state, batch, use_ema=False: self.eval_step(
                state, self._device_batch(batch), use_ema, group, model)

        def step(state, batch, use_ema=False):
            with self.weights(state, use_ema):
                cap = self._forward_graph(
                    "eval", lambda b: self._eval_outputs(b, group, model), batch,
                    () if group is None and model is None else (id(group), id(model)))
                cap.graph.replay()
            return cap.outputs

        return step

    def predict_fn(self):
        """The counterpart of the jitted predict (trainer.py:717-722): a
        callable (state, batch, use_ema=False) -> (mean_E, var_E, mean_F,
        var_F), `batch` as `eval_step_fn()` takes it. On a CUDA trainer it
        replays the captured predict and returns copies of its outputs; on a
        CPU trainer it runs `predict`."""
        if not self._capturable():
            return self.predict

        def run(state, batch, use_ema=False):
            with self.weights(state, use_ema):
                cap = self._forward_graph("predict", self._predict, batch)
                cap.graph.replay()
            return tuple(None if o is None else o.clone() for o in cap.outputs)

        return run

    def drop_forward_graphs(self, kind: str) -> None:
        """Free the captured forwards of `kind` ("eval" or "predict") and
        their graph pools; the next call of that kind captures anew."""
        self._forward_captured[kind].clear()

    # -- host-side convenience mirroring the reference API --
    def train_on_batch(self, state: TrainState, batch, lr_scale, metrics=None):
        """One train step through `train_step_fn()` (the captured step on a
        CUDA trainer); metrics accumulate on the device. `batch` is a host
        batch or its packed row; on a CPU trainer a batch of tensors runs the
        eager step as it is. Pass a Metrics instance to also drain this
        step's metrics at once (a host sync). Returns (state, loss): a device
        scalar, or a float with `metrics`. The call is the span `train.step`."""
        if (self.device.type == "cuda" and isinstance(batch, dict)
                and isinstance(batch["Z"], torch.Tensor)):
            raise TypeError("train_on_batch on a CUDA trainer takes the host batch (or its "
                            "packed row); the eager step on tensors is train_step")
        with spans.span("train.step"):
            state, step_metrics, counts = self.train_step_fn()(state, batch, lr_scale)
            if metrics is not None:
                self._update_metrics(metrics, step_metrics, counts)
                return state, float(step_metrics["loss"])
            return state, step_metrics["loss"].clone()

    def drain_metrics(self, state: TrainState, metrics) -> TrainState:
        """Move the device-side accumulators into a host Metrics object and
        reset them (one host sync per evaluation interval). Each key drains
        with its own accumulated sample weight (reference metrics.py:66-79)."""
        acc = state.metric_acc.cpu().numpy()
        for key, (wsum, w) in zip(self.tracked_metrics, acc):
            if w > 0:
                metrics.update_state(float(w), **{key: wsum / w})
        state.metric_acc.zero_()  # in place, as the captured step reads it
        return state

    def test_on_batch(self, state: TrainState, batch, metrics, use_ema: bool = False) -> float:
        """One eval step through `eval_step_fn()` (the captured eval on a
        CUDA trainer), its metrics added to `metrics`; returns its loss.
        `batch` as `train_on_batch` takes it."""
        if (self.device.type == "cuda" and isinstance(batch, dict)
                and isinstance(batch["Z"], torch.Tensor)):
            raise TypeError("test_on_batch on a CUDA trainer takes the host batch (or its "
                            "packed row); the eager eval on tensors is eval_step")
        step_metrics, counts = self.eval_step_fn()(state, batch, use_ema)
        self._update_metrics(metrics, step_metrics, counts)
        return float(step_metrics["loss"])

    def _update_metrics(self, metrics, step_metrics, counts):
        n_mol = float(counts["n_mol"])
        n_atom = float(counts["n_atoms"])
        metrics.update_state(
            int(n_mol), **{k: float(v) for k, v in step_metrics.items() if k in MOL_METRICS})
        metrics.update_state(
            int(n_atom), **{k: float(v) for k, v in step_metrics.items() if k not in MOL_METRICS})
