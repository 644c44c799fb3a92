"""Training stack: loss, optimizers, EMA, train and eval steps (port of
`gemnet_pytorch_tpu/training/trainer.py`; reference
gemnet/training/trainer.py).

- loss = (1-rho_force)·MAE(E) + rho_force·{MAE|RMSE}(F), or under MVE
  (`mve=True`, num_targets=2) the Gaussian NLL of both, with softplus
  variances (reference trainer.py:292-343), masked over padded rows;
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


def _ratio(parts):
    """Mean from a (num, den) pair. On one device the loss term and the
    reported metric are this same ratio (the JAX package's `_ratios` splits
    them only under data parallelism, which is not ported)."""
    num, den = parts
    return num / torch.clamp_min(den, 1.0)


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

    def _predict(self, batch, create_graph: bool = False):
        E, F = energy_and_forces(self.model, batch, create_graph=create_graph)
        return self._split_outputs(E, F)

    def loss_metrics_from_outputs(self, mean_E, var_E, mean_F, var_F, batch):
        """(loss, (metrics, counts)) from split model outputs + a batch dict
        carrying E/F targets and mol/atom masks (trainer.py:508-566)."""
        tE, tF = batch["E"], batch["F"]
        mol_mask, atom_mask = batch["mol_mask"], batch["atom_mask"]
        energy_mae = _ratio(_mae_parts(mean_E, tE, mol_mask))
        force_mae = _ratio(_mae_parts(mean_F, tF, atom_mask))
        force_rmse = _ratio(_rmse_parts(mean_F, tF, atom_mask))
        if self.mve:
            energy_nll = masked_nll(mean_E, var_E, tE, mol_mask)
            force_nll = masked_nll(mean_F, var_F, tF, atom_mask)
            loss = (1 - self.rho_force) * energy_nll + self.rho_force * force_nll
            # the mean variances, as num/den ratios (trainer.py:528-536)
            mm, am = mol_mask.to(var_E.dtype), atom_mask.to(var_F.dtype)
            energy_var = _ratio((torch.sum(var_E * mm[:, None]), torch.sum(mm)))
            force_var = _ratio((torch.sum(var_F * am[:, None]), 3 * torch.sum(am)))
            metrics = {
                "loss": loss,
                "energy_mae": energy_mae,
                "energy_nll": energy_nll,
                "energy_var": energy_var,
                "force_mae": force_mae,
                "force_rmse": force_rmse,
                "force_nll": force_nll,
                "force_var": force_var,
            }
        else:
            force_loss = force_mae if self.cfg.loss == "mae" else force_rmse
            loss = (1 - self.rho_force) * energy_mae + self.rho_force * force_loss
            metrics = {
                "loss": loss,
                "energy_mae": energy_mae,
                "force_mae": force_mae,
                "force_rmse": force_rmse,
            }
        counts = {
            "n_mol": torch.sum(mol_mask.float()),
            "n_atoms": torch.sum(atom_mask.float()),
        }
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
                                  **kw)
        state.step += 1
        # in place: a captured step reads and writes the accumulators' address
        state.metric_acc.copy_(self.accumulate_metrics(state.metric_acc, metrics, counts))
        return state

    # -- steps --
    def train_step(self, state: TrainState, batch, lr_scale):
        """The eager step on a batch of tensors (`data.to_torch`, or unpacked):
        loss, its gradient through the force graph, update. `lr_scale` is a
        float or a device scalar. Returns (state, metrics, counts) with the
        metrics still on the device."""
        if not isinstance(lr_scale, torch.Tensor):
            self._lr_scale.fill_(lr_scale)
            lr_scale = self._lr_scale
        params = list(self.model.parameters())
        outputs = self._predict(batch, create_graph=True)
        loss, (metrics, counts) = self.loss_metrics_from_outputs(*outputs, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        if self.flat:
            grads = torch.cat([g.reshape(-1) for g in grads])
        # detached: a caller holding the metrics holds no autograd graph
        metrics = {k: v.detach() for k, v in metrics.items()}
        return self.apply_update(state, grads, metrics, counts, lr_scale), metrics, counts

    def _host_row(self, batch) -> np.ndarray:
        """A host batch (numpy dict) packed, or a packed row as it is."""
        return batch if isinstance(batch, np.ndarray) else self.packer.pack(batch)

    def _state_key(self, state: TrainState):
        return (self.packer.version,) + tuple(t.data_ptr() for t in _state_tensors(state))

    def _step_graph(self, state: TrainState, fill):
        """The captured step for `state`, capturing it where there is none
        for the packer's version and the state's buffers. `fill(buf)` puts
        the call's first input row into the static buffer first."""
        key = self._state_key(state)
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

        cap = graphs.capture(lambda: self.train_step(state, batch, self._lr_scale)[1:],
                             self.device, before_capture=restore, debug=self.graph_debug)
        self._captured = (key, cap, buf)
        return cap

    def train_step_fn(self):
        """The counterpart of the jitted step (trainer.py:615-636): a callable
        (state, batch, lr_scale) -> (state, metrics, counts), `batch` a host
        batch (numpy dict), its packed row, or packed words already on the
        trainer's device. On a CUDA trainer it copies the row into the static
        buffer and replays the captured step (the metrics are the graph's
        outputs, overwritten by the next call); on a CPU trainer it runs the
        eager step on the unpacked batch."""
        if self.device.type != "cuda":
            return lambda state, batch, lr_scale: self.train_step(
                state, self._device_batch(batch), lr_scale)

        def step(state, batch, lr_scale):
            if isinstance(batch, torch.Tensor):
                cap = self._step_graph(state, lambda buf: buf.copy_(batch))
            else:
                row = self._host_row(batch)
                cap = self._step_graph(
                    state, lambda buf: self.packer.to_device(row, self.device, out=buf))
            self._lr_scale.fill_(lr_scale)
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

    def _eval_outputs(self, batch):
        outputs = self._predict(batch)
        _, (metrics, counts) = self.loss_metrics_from_outputs(*outputs, batch)
        return {k: v.detach() for k, v in metrics.items()}, counts

    def eval_step(self, state: TrainState, batch, use_ema: bool = False):
        """(metrics, counts) of the current or the EMA weights on a batch of
        tensors; no update. The eager eval step (`eval_step_fn()` captures
        it)."""
        with self.weights(state, use_ema):
            return self._eval_outputs(batch)

    def predict(self, state: TrainState, batch, use_ema: bool = False):
        """(mean_E, var_E, mean_F, var_F) of the current or the EMA weights,
        eagerly (`predict_fn()` captures it)."""
        with self.weights(state, use_ema):
            outputs = self._predict(self._device_batch(batch))
        return tuple(None if o is None else o.detach() for o in outputs)

    def _forward_graph(self, kind: str, fn, batch):
        """The captured `fn(unpacked batch)` of `kind` for the packer's
        version and the buffer the parameter views are bound to now,
        capturing it where there is none; `batch` (a host batch, its packed
        row, or packed words on the card) is first put into its static
        buffer."""
        if isinstance(batch, torch.Tensor):
            def fill(buf):
                buf.copy_(batch)
        else:
            row = self._host_row(batch)  # may move the packer to a new version

            def fill(buf):
                self.packer.to_device(row, self.device, out=buf)
        graphs_of = self._forward_captured[kind]
        key = (self.packer.version, next(self.model.parameters()).data_ptr())
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

    def eval_step_fn(self):
        """The counterpart of the jitted eval step (trainer.py:701-715): a
        callable (state, batch, use_ema=False) -> (metrics, counts), `batch`
        a host batch, its packed row or packed words on the trainer's
        device. On a CUDA trainer it replays the captured eval of the
        weights `use_ema` selects (the outputs are the graph's, overwritten
        by its next replay); on a CPU trainer it runs `eval_step`."""
        if self.device.type != "cuda":
            return lambda state, batch, use_ema=False: self.eval_step(
                state, self._device_batch(batch), use_ema)

        def step(state, batch, use_ema=False):
            with self.weights(state, use_ema):
                cap = self._forward_graph("eval", self._eval_outputs, batch)
                cap.graph.replay()
            return cap.outputs

        return step

    def predict_fn(self):
        """The counterpart of the jitted predict (trainer.py:717-722): a
        callable (state, batch, use_ema=False) -> (mean_E, var_E, mean_F,
        var_F), `batch` as `eval_step_fn()` takes it. On a CUDA trainer it
        replays the captured predict and returns copies of its outputs; on a
        CPU trainer it runs `predict`."""
        if self.device.type != "cuda":
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
        scalar, or a float with `metrics`."""
        if (self.device.type == "cuda" and isinstance(batch, dict)
                and isinstance(batch["Z"], torch.Tensor)):
            raise TypeError("train_on_batch on a CUDA trainer takes the host batch (or its "
                            "packed row); the eager step on tensors is train_step")
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
