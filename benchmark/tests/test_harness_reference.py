"""The plain reference agrees with the program (its plain versions on the
CPU) at small widths: energies and forces of a batch, and one training
step."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import check, weights, workload
from benchmark.reference import graph as ref_graph
from benchmark.reference import model as ref_model
from benchmark.tests import tiny
from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
from gemnet_pytorch_tpu_torch.data.batch import to_torch
from gemnet_pytorch_tpu_torch.data.graph import build_graph
from gemnet_pytorch_tpu_torch.data.padding import estimate_pad_dims, pad_batch
from gemnet_pytorch_tpu_torch.models.gemnet import GemNet, energy_and_forces
from gemnet_pytorch_tpu_torch.training.trainer import Trainer


def _config(triplets_only):
    c = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    c.update({f.name: f.default for f in dataclasses.fields(TrainConfig)})
    return {**c, **tiny.CONFIG, "triplets_only": triplets_only}


def _batch(seed=0, sizes=(6, 8, 7)):
    rng = np.random.default_rng(seed)
    mols = [workload.random_molecule(rng, n) for n in sizes]
    labels = [workload.toy_energy_forces(*m) for m in mols]
    return (np.array(sizes), np.concatenate([m[0] for m in mols]),
            np.concatenate([m[1] for m in mols]), np.array([e for e, _ in labels], np.float32),
            np.concatenate([f for _, f in labels]))


def _padded(c, N, Z, R, E=None, F=None):
    g = build_graph(R, N, c["cutoff"], c["int_cutoff"], triplets_only=c["triplets_only"])
    dims = estimate_pad_dims([g], n_mol=len(N), n_atoms_list=[len(Z)],
                             triplets_only=c["triplets_only"], headroom=1.25)
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=c["triplets_only"])


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_energy_and_forces(triplets_only):
    c = _config(triplets_only)
    sd = weights.make(c, 3, "cpu")
    port = GemNet(ModelConfig.from_dict(c), generator=torch.Generator().manual_seed(0),
                  device="cpu")
    port.load_state_dict(sd, strict=True)
    ref = check.reference_model(c, sd, "cpu")
    N, Z, R, _, _ = _batch()
    E, F = energy_and_forces(port, to_torch(_padded(c, N, Z, R), "cpu"))
    g = ref_model.to_tensors(ref_graph.build(R, N, c["cutoff"], c["int_cutoff"],
                                             triplets_only), "cpu")
    E_r, F_r = ref.energy_and_forces(g, torch.as_tensor(Z, dtype=torch.int64),
                                     torch.as_tensor(R), len(N))
    assert torch.allclose(E[:len(N), 0], E_r[:, 0], rtol=1e-5, atol=1e-5)
    assert (F[:len(Z), 0] - F_r).abs().max() <= 1e-5 * F_r.abs().max()


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_training_steps(triplets_only):
    """Three of the program's training steps against the reference's: the
    numbers the check compares, at the rounding of fp32."""
    c = _config(triplets_only)
    sd = weights.make(c, 4, "cpu")
    port = GemNet(ModelConfig.from_dict(c), generator=torch.Generator().manual_seed(0),
                  device="cpu")
    port.load_state_dict(sd, strict=True)
    trainer = Trainer(port, TrainConfig.from_dict(c))
    state = trainer.init_state()
    batches = [_batch(s, sizes) for s, sizes in ((1, (5, 6)), (2, (7, 4)), (3, (6, 6)))]
    names = [(k, p.numel()) for k, p in port.named_parameters()]
    p0 = torch.cat([sd[k].detach().reshape(-1) for k, _ in names]).double()
    tracked = list(trainer.tracked_metrics)
    prog = {"losses": [], "energy_mae": [], "force_mae": []}
    acc = state.metric_acc.double().clone()
    for k, (N, Z, R, E, F) in enumerate(batches):
        state, loss = trainer.train_on_batch(state, _padded(c, N, Z, R, E, F), 1.0)
        prog["losses"].append(float(loss))
        step, acc = state.metric_acc.double() - acc, state.metric_acc.double().clone()
        for key in ("energy_mae", "force_mae"):
            i = tracked.index(key)
            prog[key].append(float(step[i, 0] / step[i, 1]))
        if k == 0:
            prog["grad0"] = _leaf_norms(state.opt_state.mu.double() / 0.1, names)
    prog["change"] = {k: float((p.detach().double() - sd[k].double()).norm())
                      for k, p in port.named_parameters()}
    prog["ema"] = _leaf_norms(state.ema_params.double() - p0, names)
    ref = check.reference_train(c, sd, batches, "cpu")
    gaps = check.train_gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3
    assert gaps["energy_mae_gap"] < 1e-5 and gaps["force_mae_gap"] < 1e-5
    assert gaps["ema_gap"] < 1e-3


def _leaf_norms(flat, names):
    out, off = {}, 0
    for name, n in names:
        out[name] = float(flat[off:off + n].norm())
        off += n
    return out
