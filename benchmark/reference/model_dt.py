"""OCP's GemNet-dT in plain fp32 PyTorch, on periodic systems: the
benchmark's reference for the `gemnet-dt-oc20` configuration, and OCP's
S2EF training step.

OCP (Open-Catalyst-Project/ocp, ocpmodels/models/gemnet/gemnet.py GemNetT,
configs/s2ef/all/gemnet/gemnet-dT.yml): GemNet-T's triplet interaction
blocks, with
- the edge vector from the source's image: R[t] - (R[s] + o.cell), o the
  edge's integer cell offset (`graph_pbc.build`);
- the radial basis a Gaussian smearing of d/cutoff, `num_radial` centres
  on [0, 1] with coefficient -0.5/delta^2, times the polynomial envelope;
- the circular basis Y_l0 of the angle's cosine, taken from the two edges'
  unit vectors (clamped to [-1, 1]), over that same radial basis of d_ca,
  shared by every l: the down-projection takes (nEdges, num_radial) rows;
- OCP's direct-force head (`DirectOutputBlock`): per edge a force along
  its unit vector, summed on its target atom; E extensive.
The layers are the reference's own (`model.py`), over the unpadded arrays.

OCP's training step (ocpmodels/trainers/forces_trainer.py, with the
configuration's optim keys): energy_coefficient * MAE(E) +
force_coefficient * L2MAE(F), the force error's per-atom L2 norm averaged
over the free atoms (train_on_free_atoms, tag > 0); the shared basis
layers' gradients divided by the blocks that share them
(GemNetT.shared_parameters); the gradient clipped to a global norm of
clip_grad_norm; AdamW with amsgrad; an EMA of the weights after the update:
`train.AdamW`, the same optimizer and EMA as the other cells'.

Departures from OCP's GemNetT, in what is computed:
- 93 atom embedding rows where OCP has 83: no effect for Z <= 83;
- every scale factor 1 (OCP's scaling-factor file is not in the
  repository);
- the optimizer's eps is 1e-7 (TUM's), where torch's AdamW has 1e-8, and
  the clip scales by clip/norm where torch's adds 1e-6 to the norm;
- the learning rate is constant (OCP's ReduceLROnPlateau does not step
  within the benchmark's window).
"""

from __future__ import annotations

import torch
from torch import nn

from .model import (
    AtomEmbedding,
    Dense,
    EdgeEmbedding,
    InteractionBlock,
    Scale,
    _atom_mlp,
    _sph_prefactor,
    envelope,
    segment_sum,
)


def gaussian_rbf(d, num_radial, cutoff, p):
    """OCP's RadialBasis with rbf "gaussian" and the polynomial envelope."""
    ds = d / cutoff
    offset = torch.linspace(0, 1, num_radial, device=d.device)
    coeff = -0.5 / (offset[1] - offset[0]).item() ** 2
    return envelope(ds, p)[:, None] * torch.exp(coeff * (ds[:, None] - offset[None, :]) ** 2)


def y_l0(cos, S):
    """Y_l0 of the cosines, l < S: (N,) -> (N, S)."""
    P = [torch.ones_like(cos), cos]
    for l in range(2, S):
        P.append(((2 * l - 1) * cos * P[l - 1] - (l - 1) * P[l - 2]) / l)
    return torch.stack([_sph_prefactor(l, 0) * P[l] for l in range(S)], dim=1)


class SharedDownProjection(nn.Module):
    """(nEdges, R) x (S, R, I) -> (nEdges, I, S): one radial row for every order."""

    def __init__(self, S, R, I):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(S, R, I))

    def forward(self, rbf):
        return torch.einsum("er,sri->eis", rbf, self.weight)


class DirectOutputBlock(nn.Module):
    """OCP's GemNetT OutputBlock with direct forces
    (ocpmodels/models/gemnet/layers/atom_update_block.py OutputBlock, its
    parent AtomUpdateBlock's energy path), every scale factor 1:

        x_E = sum over each target's edges of m * dense_rbf(rbf), then the
              atom MLP (`layers`) and out_energy;
        x_F = seq_forces(m) (Dense, then num_atom residual layers), times
              dense_rbf_F(rbf), scaled (OCP's scale_rbf_F, "_had"), then
              out_forces.
    """

    def __init__(self, emb_atom, emb_edge, emb_rbf, n_hidden, n_targets):
        super().__init__()
        self.dense_rbf = Dense(emb_rbf, emb_edge)
        self.scale_sum = Scale()
        self.layers = _atom_mlp(emb_edge, emb_atom, n_hidden)
        self.out_energy = Dense(emb_atom, n_targets)
        self.scale_rbf = Scale()  # OCP's scale_rbf_F
        self.seq_forces = _atom_mlp(emb_edge, emb_edge, n_hidden)
        self.out_forces = Dense(emb_edge, n_targets)
        self.dense_rbf_F = Dense(emb_rbf, emb_edge)

    def forward(self, n_atoms, m, rbf, id_a):
        x_E = self.scale_sum(segment_sum(m * self.dense_rbf(rbf), id_a, n_atoms))
        for layer in self.layers:
            x_E = layer(x_E)
        x_F = m
        for layer in self.seq_forces:
            x_F = layer(x_F)
        x_F = self.scale_rbf(x_F * self.dense_rbf_F(rbf))
        return self.out_energy(x_E), self.out_forces(x_F)


class GemNetDT(nn.Module):
    """GemNet-dT with OCP's bases on periodic systems, from the
    configuration's keys (`configs/gemnet-dt-oc20.json`)."""

    def __init__(self, c: dict):
        super().__init__()
        if not (c["triplets_only"] and c["direct_forces"] and c.get("extensive", True)):
            raise NotImplementedError("GemNetDT is the extensive triplets-only direct-force model")
        self.c = c
        Rn, S = c["num_radial"], c["num_spherical"]
        self.mlp_rbf3 = Dense(Rn, c["emb_size_rbf"])
        self.mlp_cbf3 = SharedDownProjection(S, Rn, c["emb_size_cbf"])
        self.mlp_rbf_h = Dense(Rn, c["emb_size_rbf"])
        self.mlp_rbf_out = Dense(Rn, c["emb_size_rbf"])
        self.atom_emb = AtomEmbedding(c["emb_size_atom"])
        self.edge_emb = EdgeEmbedding(2 * c["emb_size_atom"] + Rn, c["emb_size_edge"])
        self.int_blocks = nn.ModuleList([InteractionBlock(c) for _ in range(c["num_blocks"])])
        self.out_blocks = nn.ModuleList([
            DirectOutputBlock(c["emb_size_atom"], c["emb_size_edge"], c["emb_size_rbf"],
                              c["num_atom"], c.get("num_targets", 1))
            for _ in range(c["num_blocks"] + 1)])

    def forward(self, g: dict, Z, R, n_mol: int):
        """(E (n_mol, 1), F (n_atoms, 3)) of the periodic batch `g` (tensors
        of `graph_pbc.build`'s arrays, `cell` (n_mol, 3, 3) among them)."""
        c = self.c
        id_c, id_a = g["id_c"], g["id_a"]
        cell = g["cell"][g["batch_seg"][id_a]]
        shift = (g["edge_offset"].to(R.dtype)[:, :, None] * cell).sum(1)
        V = R[id_a] - (R[id_c] + shift)
        D = torch.sqrt((V * V).sum(-1))
        U = V / D[:, None]
        cos3 = torch.clamp((U[g["id3_reduce_ca"]] * U[g["id3_expand_ba"]]).sum(-1), -1.0, 1.0)
        rbf = gaussian_rbf(D, c["num_radial"], c["cutoff"], c["envelope_exponent"])
        basis = {
            "rbf3": self.mlp_rbf3(rbf),
            "cbf3": (self.mlp_cbf3(rbf), y_l0(cos3, c["num_spherical"])),
            "rbf_h": self.mlp_rbf_h(rbf),
        }
        rbf_out = self.mlp_rbf_out(rbf)
        h = self.atom_emb(Z)
        m = self.edge_emb(h, rbf, id_c, id_a)
        n_atoms = len(Z)
        E_a, F_e = self.out_blocks[0](n_atoms, m, rbf_out, id_a)
        for block, out in zip(self.int_blocks, self.out_blocks[1:]):
            h, m = block(h, m, basis, g)
            E, F = out(n_atoms, m, rbf_out, id_a)
            E_a, F_e = E_a + E, F_e + F
        E_mol = segment_sum(E_a, g["batch_seg"], n_mol)
        F_atom = segment_sum(F_e[:, :, None] * U[:, None, :], id_a, n_atoms)[:, 0, :]
        return E_mol, F_atom


def to_tensors(g: dict, cell, device) -> dict:
    """`graph_pbc.build`'s arrays and the cells as tensors on `device`."""
    out = {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in g.items()
           if k not in ("candidates", "dropped", "edge_offset")}
    out["edge_offset"] = torch.as_tensor(g["edge_offset"], device=device)
    out["cell"] = torch.as_tensor(cell, dtype=torch.float32, device=device)
    return out


def loss(E, F, E_t, F_t, free, c: dict, n_mol=None, n_free=None):
    """OCP's loss of a batch; with `n_mol` and `n_free` given, the part
    that these systems contribute: their sums over the whole batch's counts
    (a global mean, so the parts' gradients add up to the batch's)."""
    n_mol = E.shape[0] if n_mol is None else n_mol
    n_free = int(free.sum()) if n_free is None else n_free
    e_mae = torch.sum(torch.abs(E - E_t)) / (n_mol * E.shape[1])
    err = (F - F_t)[free]
    f = torch.sum(torch.sqrt(torch.clamp_min((err * err).sum(-1), 1e-24))) / n_free
    return c["energy_coefficient"] * e_mae + c["force_coefficient"] * f

