"""Training stack: loss, flat optimizer, EMA, train and eval steps (port of
`gemnet_pytorch_tpu/training/trainer.py`, flat mode; reference
gemnet/training/trainer.py).

- loss = (1-rho_force)·MAE(E) + rho_force·{MAE|RMSE}(F), masked over padded
  rows (reference trainer.py:325-343);
- the optimizer, shared-gradient scaling, global-norm clip and EMA of
  `flat_opt.apply_update`, over one flat fp32 buffer whose views are the
  model's parameters;
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

Not ported yet (the Trainer raises): MVE (`mve=True`, which needs
num_targets=2), AGC and the optax tree-mode optimizer; the TPU's one-buffer
batch transfer (`BatchPacker`) has no counterpart, `data.to_torch` takes its
role; a scan of K steps (`multi_step_fn`) waits for CUDA graphs.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..config import TrainConfig
from ..data.batch import to_torch
from ..models.gemnet import GemNet, energy_and_forces
from . import flat_opt
from .schedules import linear_warmup_exponential_decay

MOL_METRICS = frozenset({"loss", "energy_mae", "energy_nll", "energy_var"})


@dataclass
class TrainState:
    step: torch.Tensor  # int32 scalar on the device
    # ONE contiguous fp32 vector; the model's parameters are views of it
    params: torch.Tensor
    opt_state: flat_opt.FlatOptState
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


def masked_rmse(pred, target, mask):
    return _ratio(_rmse_parts(pred, target, mask))


# ------------------------------------------------------------------- trainer


class Trainer:
    """Train and eval steps for a GemNet model + TrainConfig, on the
    model's device."""

    def __init__(self, model: GemNet, cfg: TrainConfig):
        unsupported = {"mve": cfg.mve, "agc": cfg.agc, "flat_optimizer": not cfg.flat_optimizer}
        for knob, bad in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"{knob}={getattr(cfg, knob)!r} is not supported by the PyTorch port yet")
        if not 0 <= cfg.rho_force <= 1:
            raise ValueError(f"rho_force {cfg.rho_force} outside [0, 1]")
        if cfg.loss not in ("mae", "rmse"):
            raise ValueError(f"loss {cfg.loss!r}: 'mae' or 'rmse'")
        self.model = model
        self.cfg = cfg
        self.model_cfg = model.cfg
        self.rho_force = float(cfg.rho_force)
        self.device = next(model.parameters()).device
        self.tracked_metrics = ["loss", "energy_mae", "force_mae", "force_rmse"]
        self._mol_metric = torch.tensor(
            [k in MOL_METRICS for k in self.tracked_metrics], device=self.device)
        self._sched_base = linear_warmup_exponential_decay(
            cfg.warmup_steps, cfg.decay_steps, cfg.decay_rate, cfg.staircase)

    # -- state management --
    def init_state(self) -> TrainState:
        """Flatten the model's parameters into the state's buffer (the
        parameters become its views) and start the optimizer, EMA and metric
        accumulators."""
        flat = flat_opt.flatten_parameters(self.model)
        wd, sc = flat_opt.build_masks(
            ((n, p.shape) for n, p in self.model.named_parameters()),
            self.model_cfg, self.cfg.weight_decay, self.device)
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            params=flat,
            opt_state=flat_opt.init(flat, wd, sc),
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
        """A padded numpy batch (data.pad_batch) goes through data.to_torch
        onto the trainer's device; a batch from to_torch passes as it is."""
        return to_torch(batch, self.device) if isinstance(batch["Z"], np.ndarray) else batch

    # -- prediction/loss --
    def _split_outputs(self, E, F):
        """Raw model outputs -> (mean_E, var_E, mean_F, var_F); the variances
        are None without MVE."""
        return E, None, F[:, 0, :], None

    def _predict(self, batch, create_graph: bool = False):
        E, F = energy_and_forces(self.model, batch, create_graph=create_graph)
        return self._split_outputs(E, F)

    def loss_metrics_from_outputs(self, mean_E, var_E, mean_F, var_F, batch):
        """(loss, (metrics, counts)) from split model outputs + a batch dict
        carrying E/F targets and mol/atom masks (trainer.py:508-566, no MVE)."""
        tE, tF = batch["E"], batch["F"]
        mol_mask, atom_mask = batch["mol_mask"], batch["atom_mask"]
        energy_mae = _ratio(_mae_parts(mean_E, tE, mol_mask))
        force_mae = _ratio(_mae_parts(mean_F, tF, atom_mask))
        force_rmse = _ratio(_rmse_parts(mean_F, tF, atom_mask))
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
        """Flat gradient -> the state after optimizer + EMA + metric
        accumulation (in place: the parameter views see the new weights)."""
        flat_opt.apply_update(
            grads, state.opt_state, state.params, state.ema_params, lr_scale,
            schedule=self._sched_base,
            learning_rate=self.cfg.learning_rate,
            grad_clip_max=self.cfg.grad_clip_max,
            ema_decay=self.cfg.ema_decay,
        )
        state.step += 1
        state.metric_acc = self.accumulate_metrics(state.metric_acc, metrics, counts)
        return state

    # -- steps --
    def train_step(self, state: TrainState, batch, lr_scale):
        """One step: loss, its gradient through the force graph, update.
        Returns (state, metrics, counts) with the metrics still on the device."""
        params = list(self.model.parameters())
        outputs = self._predict(batch, create_graph=True)
        loss, (metrics, counts) = self.loss_metrics_from_outputs(*outputs, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        flat_grad = torch.cat([g.reshape(-1) for g in grads])
        return self.apply_update(state, flat_grad, metrics, counts, lr_scale), metrics, counts

    def eval_step(self, state: TrainState, batch, use_ema: bool = False):
        """(metrics, counts) of the current or the EMA weights; no update."""
        with self.weights(state, use_ema):
            outputs = self._predict(batch)
            _, (metrics, counts) = self.loss_metrics_from_outputs(*outputs, batch)
        return {k: v.detach() for k, v in metrics.items()}, counts

    def predict(self, state: TrainState, batch, use_ema: bool = False):
        """(mean_E, var_E, mean_F, var_F) of the current or the EMA weights."""
        with self.weights(state, use_ema):
            outputs = self._predict(self._device_batch(batch))
        return tuple(None if o is None else o.detach() for o in outputs)

    # -- host-side convenience mirroring the reference API --
    def train_on_batch(self, state: TrainState, batch, lr_scale, metrics=None):
        """One train step; metrics accumulate on the device. Pass a Metrics
        instance to also drain this step's metrics at once (a host sync).
        Returns (state, loss): a device scalar, or a float with `metrics`."""
        state, step_metrics, counts = self.train_step(state, self._device_batch(batch), lr_scale)
        if metrics is not None:
            self._update_metrics(metrics, step_metrics, counts)
            return state, float(step_metrics["loss"])
        return state, step_metrics["loss"].detach()

    def drain_metrics(self, state: TrainState, metrics) -> TrainState:
        """Move the device-side accumulators into a host Metrics object and
        reset them (one host sync per evaluation interval). Each key drains
        with its own accumulated sample weight (reference metrics.py:66-79)."""
        acc = state.metric_acc.cpu().numpy()
        for key, (wsum, w) in zip(self.tracked_metrics, acc):
            if w > 0:
                metrics.update_state(float(w), **{key: wsum / w})
        state.metric_acc = torch.zeros_like(state.metric_acc)
        return state

    def test_on_batch(self, state: TrainState, batch, metrics, use_ema: bool = False) -> float:
        step_metrics, counts = self.eval_step(state, self._device_batch(batch), use_ema)
        self._update_metrics(metrics, step_metrics, counts)
        return float(step_metrics["loss"])

    def _update_metrics(self, metrics, step_metrics, counts):
        n_mol = float(counts["n_mol"])
        n_atom = float(counts["n_atoms"])
        metrics.update_state(
            int(n_mol), **{k: float(v) for k, v in step_metrics.items() if k in MOL_METRICS})
        metrics.update_state(
            int(n_atom), **{k: float(v) for k, v in step_metrics.items() if k not in MOL_METRICS})
