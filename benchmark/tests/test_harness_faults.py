"""The check catches the faults a cell can have: with the timed path broken
underneath, a run (its look for a chip skipped, at small widths on the CPU)
comes out not correct. The limits are the cells' own (`limits/`)."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests import tiny
from gemnet_pytorch_tpu_torch import md
from gemnet_pytorch_tpu_torch.training import flat_opt
from gemnet_pytorch_tpu_torch.training.trainer import Trainer

TRAIN = [w["name"] for w in run.manifest()["workloads"]
         if run.cell(w["name"])[3]["loop"] == "train"]
MD = [w["name"] for w in run.manifest()["workloads"]
      if run.cell(w["name"])[3]["loop"] == "md"]


def _held(r, *names):
    """The first of `names` that the cell's check holds."""
    return next(r["checks"][n] for n in names if n in r["checks"])


def _run(workload):
    torch.set_num_threads(2)
    return run.run(workload, 2**31 + 99, 0.3, False, device="cpu",
                   overrides=tiny.overrides(workload))


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(workload, monkeypatch):
    """A step that returns its state unchanged: no update, no EMA."""
    monkeypatch.setattr(Trainer, "apply_update",
                        lambda self, state, grads, metrics, counts, lr_scale: state)
    r = _run(workload)
    assert r["correct"] is False
    change = _held(r, "change_gap", "change_median_gap")
    assert change["value"] > change["limit"]


@pytest.mark.parametrize("workload", TRAIN)
def test_ema_left_unchanged(workload, monkeypatch):
    """A step that updates the parameters but leaves the EMA as it was."""
    inner = flat_opt.apply_update

    def no_ema(grads, st, p, ema, *args, **kwargs):
        kept = ema.clone()
        inner(grads, st, p, ema, *args, **kwargs)
        ema.copy_(kept)

    monkeypatch.setattr(flat_opt, "apply_update", no_ema)
    r = _run(workload)
    assert r["correct"] is False
    ema, change = _held(r, "ema_gap", "ema_median_gap"), _held(r, "change_gap", "change_median_gap")
    assert ema["value"] > ema["limit"] and change["value"] <= change["limit"]


@pytest.mark.parametrize("workload", TRAIN)
def test_energy_altered(workload, monkeypatch):
    """Each step's energies altered where they are produced, by a constant
    a molecule: the forces, and so the loss but for its weight of 0.001 on
    the energy, are unchanged."""
    inner = Trainer._split_outputs

    def altered(self, E, F):
        mean_E, var_E, mean_F, var_F = inner(self, E, F)
        return mean_E + 0.1, var_E, mean_F, var_F

    monkeypatch.setattr(Trainer, "_split_outputs", altered)
    r = _run(workload)
    assert r["correct"] is False
    assert r["checks"]["energy_mae_gap"]["value"] > r["checks"]["energy_mae_gap"]["limit"]


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    """The loss's mean taken over the first half of the batch's molecules."""
    inner = Trainer.loss_metrics_from_outputs

    def half(self, mean_E, var_E, mean_F, var_F, batch, group=None):
        keep = torch.arange(batch["mol_mask"].shape[0], device=mean_E.device)
        keep = keep < batch["mol_mask"].sum() // 2
        batch = dict(batch, mol_mask=batch["mol_mask"] & keep,
                     atom_mask=batch["atom_mask"] & keep[batch["batch_seg"]])
        return inner(self, mean_E, var_E, mean_F, var_F, batch, group)

    monkeypatch.setattr(Trainer, "loss_metrics_from_outputs", half)
    r = _run(workload)
    assert r["correct"] is False
    loss = _held(r, "loss_gap", "first_loss_gap")
    assert loss["value"] > loss["limit"]


@pytest.mark.parametrize("workload", MD)
def test_answer_altered(workload, monkeypatch):
    """Each step's answer altered where it is produced: one atom's force off
    by a tenth of the RMS force."""
    inner = md.GemNetCalculator.calculate

    def altered(self, R=None):
        E, F = inner(self, R)
        F = F.copy()
        F[0] += 0.1 * np.sqrt(np.mean(np.sum(F**2, axis=1)))
        return E, F

    monkeypatch.setattr(md.GemNetCalculator, "calculate", altered)
    r = _run(workload)
    assert r["correct"] is False
    assert r["checks"]["force_gap"]["value"] > r["checks"]["force_gap"]["limit"]
