"""OC20 GemNet-dT on the port (OCP's gemnet-dT.yml: periodic cells, a
neighbour cap, Gaussian and spherical-harmonic bases, direct forces, OCP's
loss) against the benchmark's plain reference (`benchmark/reference/
model_dt.py`, `graph_pbc.py`), at small widths on the CPU with seeded
weights; and the molecules' path (no cell, TUM's bases and loss) as it was.

Tolerances: E and F to 1e-5 of their scale and the loss to 1e-5 relative,
fp32 rounding of two summation orders (the port's masked segment sums over
padded rows, the reference's index_add over real ones); the gradient to
1e-4 of each leaf's norm (its sums run over ~10^4 triplet rows in either
order). A wrong offset sign or a missing free mask moves them by far more
(`test_offsets_and_free_mask_matter`)."""

import hashlib
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmark import weights_dt, workload_slab
from benchmark.reference import graph_pbc, model_dt
from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider, to_torch
from gemnet_pytorch_tpu_torch.data.packer import BatchPacker
from gemnet_pytorch_tpu_torch.data.padding import pad_batch
from gemnet_pytorch_tpu_torch.models.gemnet import GemNet, energy_and_forces
from gemnet_pytorch_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(emb_size_atom=16, emb_size_edge=16, emb_size_trip=8, emb_size_rbf=4,
              emb_size_cbf=4, emb_size_bil_trip=8, num_blocks=2, num_radial=16,
              max_neighbors=20)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    with open(os.path.join(ROOT, "benchmark/configs/gemnet-dt-oc20.json")) as f:
        cfg = {**json.load(f), **WIDTHS}
    with open(os.path.join(ROOT, "benchmark/traffic/oc20slab32.json")) as f:
        mix = {**json.load(f), "pool": 4, "surface": [2, 3], "layers": [2, 3],
               "adsorbate": [1, 3]}
    pool = workload_slab.pool(mix)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pool.npz")
        np.savez(path, **pool)
        cont = DataContainer(path, cfg["cutoff"], cfg["int_cutoff"], True,
                             max_neighbors=cfg["max_neighbors"])
    dims = DataProvider(cont, 4, 0, 3, seed=0, shuffle=False).pad_dims
    sd = weights_dt.make(cfg, 11, "cpu")
    return cfg, pool, cont, dims, sd


def _port(cfg, sd):
    model = GemNet(ModelConfig.from_dict(cfg), generator=torch.Generator().manual_seed(0),
                   device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def _reference(cfg, sd):
    ref = model_dt.GemNetDT(cfg)
    ref.load_state_dict(sd, strict=True)
    return ref


def _port_batch(cont, dims, ids, R=None):
    g, Z, R0, E, F = cont.build(ids)
    if R is not None:  # positions moved: the graph of the new ones
        cont = _with_positions(cont, ids, R)
        g, Z, R0, E, F = cont.build(ids)
    return to_torch(pad_batch(g, Z, R0, dims, E=E, F=F, triplets_only=True), "cpu")


def _with_positions(cont, ids, R):
    import copy
    out = copy.copy(cont)
    out.R = cont.R.copy()
    atoms = np.concatenate([np.arange(cont.N_cumsum[i], cont.N_cumsum[i + 1]) for i in ids])
    out.R[atoms] = R
    return out


def _ref_inputs(cfg, pool, ids, R=None):
    cum = np.concatenate([[0], np.cumsum(pool["N"])])
    atoms = np.concatenate([np.arange(cum[i], cum[i + 1]) for i in ids])
    R = pool["R"][atoms] if R is None else R
    g = graph_pbc.build(R, pool["N"][ids], pool["cell"][ids], cfg["cutoff"], cfg["max_neighbors"])
    return (model_dt.to_tensors(g, pool["cell"][ids], "cpu"),
            torch.as_tensor(pool["Z"][atoms], dtype=torch.int64), torch.as_tensor(R), atoms)


def test_energy_and_direct_forces(setup):
    cfg, pool, cont, dims, sd = setup
    ids = np.array([0, 1, 2])
    E, F = energy_and_forces(_port(cfg, sd), _port_batch(cont, dims, ids))
    g, Z, R, atoms = _ref_inputs(cfg, pool, ids)
    with torch.no_grad():
        E_r, F_r = _reference(cfg, sd)(g, Z, R, 3)
    n = len(atoms)
    scale_E, scale_F = float(E_r.abs().max()), float(F_r.abs().max())
    assert scale_F > 0.01
    np.testing.assert_allclose(E[:3].detach().numpy(), E_r.numpy(), atol=1e-5 * scale_E)
    np.testing.assert_allclose(F[:n, 0].detach().numpy(), F_r.numpy(), atol=1e-5 * scale_F)
    assert torch.all(F[n:] == 0) and torch.all(E[3:] == 0)


def _port_loss_and_grads(cfg, sd, batch):
    model = _port(cfg, sd)
    trainer = Trainer(model, TrainConfig.from_dict(cfg))
    loss, (metrics, counts) = trainer._loss_and_metrics(batch)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss), metrics, counts, dict(zip(names, grads))


def _ref_loss_and_grads(cfg, sd, pool, ids):
    ref = _reference(cfg, sd)
    g, Z, R, atoms = _ref_inputs(cfg, pool, ids)
    E, F = ref(g, Z, R, len(ids))
    E_t = torch.as_tensor(pool["E"][ids]).reshape(-1, 1)
    free = torch.as_tensor(pool["tags"][atoms] > 0)
    loss = model_dt.loss(E, F, E_t, torch.as_tensor(pool["F"][atoms]), free, cfg)
    names = [k for k, _ in ref.named_parameters()]
    return float(loss), dict(zip(names, torch.autograd.grad(loss, list(ref.parameters()))))


def test_ocp_loss_and_gradient(setup):
    """OCP's loss, 1 MAE(E) + 100 L2MAE(F) over the free atoms, and its
    gradient, leaf by leaf."""
    cfg, pool, cont, dims, sd = setup
    ids = np.array([1, 2, 3])
    batch = _port_batch(cont, dims, ids)
    loss, metrics, counts, grads = _port_loss_and_grads(cfg, sd, batch)
    ref_loss, ref_grads = _ref_loss_and_grads(cfg, sd, pool, ids)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    free = batch["free_mask"].sum()
    assert float(counts["n_atoms"]) == float(free) < float(batch["atom_mask"].sum())
    assert float(metrics["loss"]) == pytest.approx(
        float(metrics["energy_mae"]) + 100 * float(metrics["force_rmse"]), rel=1e-6)
    assert set(grads) == set(ref_grads)
    for k, v in ref_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(),
                                   atol=1e-4 * max(float(v.norm()), 1e-8), err_msg=k)


def test_offsets_and_free_mask_matter(setup):
    """The reference tells a wrong offset sign and a loss over every atom
    apart from the port by far more than the tolerances."""
    cfg, pool, cont, dims, sd = setup
    ids = np.array([0, 1, 2])
    batch = _port_batch(cont, dims, ids)
    E, F = energy_and_forces(_port(cfg, sd), dict(batch, edge_offset=-batch["edge_offset"]))
    g, Z, R, atoms = _ref_inputs(cfg, pool, ids)
    with torch.no_grad():
        _, F_r = _reference(cfg, sd)(g, Z, R, 3)
    assert float((F[:len(atoms), 0] - F_r).abs().max()) > 1e-2 * float(F_r.abs().max())
    loss, *_ = _port_loss_and_grads(cfg, sd, {k: v for k, v in batch.items()
                                              if k != "free_mask"})
    ref_loss, _ = _ref_loss_and_grads(cfg, sd, pool, ids)
    assert abs(loss - ref_loss) > 1e-3 * ref_loss


def test_force_head_is_ocps(setup):
    """OCP's head multiplies the force MLP's output by its own Dense of rbf
    (`dense_rbf_F`): with those weights zero, every direct force is zero in
    the port and in the reference, and the energy is untouched (TUM's head,
    the MLP over m * Dense(rbf), would still give forces)."""
    cfg, pool, cont, dims, sd = setup
    ids = np.array([0, 1])
    batch = _port_batch(cont, dims, ids)
    E0, F0 = energy_and_forces(_port(cfg, sd), batch)
    assert float(F0.abs().max()) > 0.01
    zeroed = {k: (torch.zeros_like(v) if ".dense_rbf_F." in k else v) for k, v in sd.items()}
    assert sum(".dense_rbf_F." in k for k in sd) == cfg["num_blocks"] + 1
    E, F = energy_and_forces(_port(cfg, zeroed), batch)
    g, Z, R, _ = _ref_inputs(cfg, pool, ids)
    with torch.no_grad():
        E_r, F_r = _reference(cfg, zeroed)(g, Z, R, 2)
    assert torch.all(F == 0) and torch.all(F_r == 0)
    np.testing.assert_array_equal(E.detach().numpy(), E0.detach().numpy())
    np.testing.assert_allclose(E[:2].detach().numpy(), E_r.numpy(),
                               atol=1e-5 * float(E_r.abs().max()))


@pytest.mark.parametrize("move", ["wrap", "lattice_shift"])
def test_invariance(setup, move):
    """E and F do not change when an atom is wrapped back into the cell
    (moved by a lattice vector) or when the whole system is shifted by one."""
    cfg, pool, cont, dims, sd = setup
    ids = np.array([0])
    model = _port(cfg, sd)
    E0, F0 = energy_and_forces(model, _port_batch(cont, dims, ids))
    cell = pool["cell"][0]
    R = pool["R"][:pool["N"][0]].copy()
    if move == "wrap":
        R[-1] += cell[0] - cell[1]  # the adsorbate's last atom, one cell over
    else:
        R += cell[1]
    E1, F1 = energy_and_forces(model, _port_batch(cont, dims, ids, R))
    n = int(pool["N"][0])
    scale_F = float(F0.abs().max())
    np.testing.assert_allclose(E1[0].detach().numpy(), E0[0].detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(F1[:n].detach().numpy(), F0[:n].detach().numpy(),
                               atol=1e-4 * scale_F)


# the molecules' path as it was at the parent commit: the packed words bit for
# bit, without and with the edges' sort metadata (which joined them since);
# E and F (8 molecules of 4-8 atoms, batches of 4, widths 16) to 1e-6, their
# bits equal on the CPU it was read on, where another CPU's BLAS may round
# otherwise
PARENT = {
    "Q": ("155cb62f4e911568", "a4f205bdbf0e29e9",
          [0.9565675854682922, 0.6233870983123779, 0.6323123574256897, 0.6158151626586914],
          12.060632705688477, -8.456262588500977),
    "T": ("ecec1a5dce4fbf50", "d34a2945a5d456e9",
          [-1.816979169845581, -0.4106302261352539, -0.4652080237865448, -0.7951110601425171],
          17.63018035888672, 3.0960845947265625),
}


@pytest.mark.parametrize("variant", ["Q", "T"])
def test_molecules_unchanged(variant, tmp_path, monkeypatch):
    from gemnet_pytorch_tpu_torch.data import packer as packer_module
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    mols = [random_molecule(rng, int(rng.integers(4, 9))) for _ in range(8)]
    R = np.concatenate([r for _, r in mols])
    path = str(tmp_path / "m.npz")
    np.savez(path, N=np.array([len(z) for z, _ in mols]), Z=np.concatenate([z for z, _ in mols]),
             R=R, E=np.zeros(8, np.float32), F=np.zeros_like(R))
    q = variant == "T"
    prov = DataProvider(DataContainer(path, 5.0, 10.0, q), 8, 0, 4, seed=1, shuffle=False)
    batch = next(prov.get_dataset("train", prefetch_workers=0))
    packer = BatchPacker()
    words = packer.pack(batch)
    cfg = ModelConfig(emb_size_atom=16, emb_size_edge=16, emb_size_trip=8, emb_size_quad=8,
                      emb_size_rbf=4, emb_size_cbf=4, emb_size_sbf=8, emb_size_bil_trip=8,
                      emb_size_bil_quad=8, num_blocks=2, triplets_only=q)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    E, F = energy_and_forces(model, packer.unpack(torch.from_numpy(words)))
    parent_digest, digest, E_ref, abs_sum, weighted = PARENT[variant]
    assert hashlib.sha256(words.tobytes()).hexdigest()[:16] == digest
    with monkeypatch.context() as m:
        m.setattr(packer_module, "with_edge_sort_metadata", lambda b: b)
        parent_words = BatchPacker().pack(batch)
    assert hashlib.sha256(parent_words.tobytes()).hexdigest()[:16] == parent_digest
    np.testing.assert_allclose(E[:, 0].detach().numpy(), E_ref, rtol=1e-6)
    assert float(F.abs().sum()) == pytest.approx(abs_sum, rel=1e-6)
    w = torch.arange(F.numel()).reshape(F.shape)
    assert float((F * w).sum()) == pytest.approx(weighted, abs=1e-4)

