"""GemNet-Q and GemNet-T in plain fp32 PyTorch: the benchmark's reference.

A frozen copy of the model's mathematics (TUM-DAML gemnet_pytorch,
gemnet/model/gemnet.py and its layers; arXiv:2106.08903) over the unpadded
index arrays of `graph.build`: no masks, no kernels, no sort metadata. Every
segment sum is `index_add` and every product a plain `torch` product, so
with TF32 off (`exact_fp32`) it computes in full fp32. Module and parameter
names are the reference state-dict schema, so one state dict loads into
this model and into the program under test alike. Forces are -dE/dR.

Departures from the published code, all in how and not in what is computed:
the per-edge neighbour sums of the bilinear layers run over rows grouped by
their reduce edge (`neighbour_sum`, in blocks of rows so that a quadruplet
batch fits), not over a (nEdges, Kmax) dense layout; the basis functions are
evaluated from coefficient tables (spherical Bessel functions from their
sin/cos recurrence, Legendre and spherical harmonics by recurrence).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import special as sp_special
from scipy.optimize import brentq
from torch import nn

# rows of the outer products a neighbour sum holds at once
ROW_BLOCK = 1 << 17


def exact_fp32(on: bool = True) -> None:
    """fp32 products in full fp32 (TF32 off), or TF32 where `on` is False."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def segment_sum(x, ids, n):
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, ids, x)


def neighbour_sum(a, b, ids, n):
    """out[s, e, m] = sum over rows t with ids[t] == e of a[t, s] * b[t, m]."""
    S, M = a.shape[1], b.shape[1]
    out = a.new_zeros((n, S * M))
    for lo in range(0, a.shape[0], ROW_BLOCK):
        hi = lo + ROW_BLOCK
        outer = (a[lo:hi, :, None] * b[lo:hi, None, :]).reshape(-1, S * M)
        out = out.index_add(0, ids[lo:hi], outer)
    return out.reshape(n, S, M).permute(1, 0, 2)


# ------------------------------------------------------------------ basis


@lru_cache(maxsize=None)
def _sph_bessel_coeffs(n):
    """(a, b): j_l(x) = sin(x) sum_k a[l][k] x^-(k+1) + cos(x) sum_k b[l][k] x^-(k+1)."""
    a, b = [[1]], [[0]]
    if n > 1:
        a.append([0, 1])
        b.append([-1, 0])
    for l in range(2, n):
        fa = [(2 * l - 1) * c for c in [0] + a[l - 1]]
        fb = [(2 * l - 1) * c for c in [0] + b[l - 1]]
        ga = a[l - 2] + [0] * (len(fa) - len(a[l - 2]))
        gb = b[l - 2] + [0] * (len(fb) - len(b[l - 2]))
        a.append([x - y for x, y in zip(fa, ga)])
        b.append([x - y for x, y in zip(fb, gb)])
    return a, b


@lru_cache(maxsize=None)
def _bessel_zeros(n, k):
    zeros = np.zeros((n, k))
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    roots = np.zeros(k + n - 1)
    for l in range(1, n):
        for j in range(k + n - 1 - l):
            roots[j] = brentq(lambda r: sp_special.spherical_jn(l, r), points[j], points[j + 1])
        points = roots.copy()
        zeros[l][:k] = roots[:k]
    return zeros


def _sph_prefactor(l, m):
    return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - abs(m))
                     / math.factorial(l + abs(m)))


def _inv_poly(coeffs, inv_x):
    acc = torch.zeros_like(inv_x)
    for c in coeffs[::-1]:
        acc = acc * inv_x + float(c)
    return acc * inv_x


def envelope(d_scaled, p):
    a, b, c = -(p + 1) * (p + 2) / 2, p * (p + 2), -p * (p + 1) / 2
    env = 1.0 + a * d_scaled**p + b * d_scaled ** (p + 1) + c * d_scaled ** (p + 2)
    return torch.where(d_scaled < 1, env, torch.zeros_like(d_scaled))


class RadialBasis(nn.Module):
    def __init__(self, num_radial, cutoff, p):
        super().__init__()
        self.cutoff, self.p = cutoff, p
        self.frequencies = nn.Parameter(torch.tensor(
            np.pi * np.arange(1, num_radial + 1), dtype=torch.float32))

    def forward(self, d):
        ds = d[:, None] / self.cutoff
        return (envelope(ds, self.p) * math.sqrt(2.0 / self.cutoff)
                * torch.sin(self.frequencies[None, :] * ds) / d[:, None])


class BesselEnv(nn.Module):
    """j_l(z_ln d / c) / (0.5 j_{l+1}(z_ln)^2)^0.5 * envelope * c^-1.5: (N, S, R)."""

    def __init__(self, num_spherical, num_radial, cutoff, p):
        super().__init__()
        self.S, self.cutoff, self.p = num_spherical, cutoff, p
        zeros = _bessel_zeros(num_spherical, num_radial)
        norms = np.stack([1.0 / np.sqrt(0.5 * sp_special.spherical_jn(l + 1, zeros[l]) ** 2)
                          for l in range(num_spherical)])
        self.register_buffer("zeros", torch.tensor(zeros, dtype=torch.float32), persistent=False)
        self.register_buffer("norms", torch.tensor(norms, dtype=torch.float32), persistent=False)
        self.coeffs = _sph_bessel_coeffs(num_spherical)

    def forward(self, d):
        ds = d / self.cutoff
        outs = []
        for l in range(self.S):
            arg = ds[:, None] * self.zeros[l][None, :]
            inv = 1.0 / arg
            val = torch.sin(arg) * _inv_poly(self.coeffs[0][l], inv)
            if any(self.coeffs[1][l]):
                val = val + torch.cos(arg) * _inv_poly(self.coeffs[1][l], inv)
            outs.append(val * self.norms[l][None, :])
        return (torch.stack(outs, dim=1) * self.cutoff**-1.5
                * envelope(ds, self.p)[:, None, None])


def legendre_y(angle, S):
    """Y_l0(angle), l < S: (N,) -> (N, S)."""
    z = torch.cos(angle)
    P = [torch.ones_like(z), z]
    for l in range(2, S):
        P.append(((2 * l - 1) * z * P[l - 1] - (l - 1) * P[l - 2]) / l)
    return torch.stack([_sph_prefactor(l, 0) * P[l] for l in range(S)], dim=1)


def real_sph_harm(alpha, theta, S):
    """Real Y_lm(alpha polar, theta azimuthal), per l the orders
    m = 0, 1..l (cos), l..1 (sin): (N,) -> (N, S^2)."""
    z, s = torch.cos(alpha), torch.sin(alpha)
    P = {(0, 0): torch.ones_like(z)}
    for m in range(1, S):
        P[(m, m)] = (1 - 2 * m) * s * P[(m - 1, m - 1)]
    for m in range(0, S - 1):
        P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
    for l in range(2, S):
        for m in range(l - 1):
            P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
    outs = []
    for l in range(S):
        outs.append(_sph_prefactor(l, 0) * P[(l, 0)])
        for m in range(1, l + 1):
            outs.append(math.sqrt(2) * (-1) ** m * _sph_prefactor(l, m) * P[(l, m)]
                        * torch.cos(m * theta))
        for m in range(l, 0, -1):
            outs.append(math.sqrt(2) * (-1) ** m * _sph_prefactor(l, m) * P[(l, m)]
                        * torch.sin(m * theta))
    return torch.stack(outs, dim=1)


# ------------------------------------------------------------------ layers


def silu(x):
    return F.silu(x) * (1.0 / 0.6)


class Dense(nn.Module):
    def __init__(self, n_in, n_out, act=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.act = act

    def forward(self, x):
        y = x @ self.weight.t()
        return silu(y) if self.act else y


class Residual(nn.Module):
    def __init__(self, units):
        super().__init__()
        self.dense_mlp = nn.Sequential(Dense(units, units, True), Dense(units, units, True))

    def forward(self, x):
        return (x + self.dense_mlp(x)) * 2**-0.5


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("scale_factor", torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale_factor


class AtomEmbedding(nn.Module):
    def __init__(self, emb):
        super().__init__()
        self.embeddings = nn.Embedding(93, emb)

    def forward(self, Z):
        return self.embeddings(Z - 1)


class EdgeEmbedding(nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.dense = Dense(n_in, n_out, True)

    def forward(self, h, m, id_c, id_a):
        return self.dense(torch.cat([h[id_c], h[id_a], m], dim=-1))


class DownProjection(nn.Module):
    """(nEdges, S, R) x (S, R, I) -> (nEdges, I, S)."""

    def __init__(self, S, R, I):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(S, R, I))

    def forward(self, x):
        return torch.einsum("esr,sri->eis", x, self.weight)


class Bilinear(nn.Module):
    """out[e] = sum_{i,m} W[m, i, :] sum_s rbf_W1[e, i, s] sum_{t in e} sph[t, s] m[t, m]."""

    def __init__(self, emb, I, n_out):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(emb, I, n_out))

    def forward(self, rbf_W1, sph, m, ids):
        sum_k = neighbour_sum(sph, m, ids, rbf_W1.shape[0])
        x = torch.einsum("eis,sem->eim", rbf_W1, sum_k)
        return torch.einsum("eim,mio->eo", x, self.weight)


def _atom_mlp(n_in, n_out, n_hidden):
    return nn.ModuleList([Dense(n_in, n_out, True)] + [Residual(n_out) for _ in range(n_hidden)])


class AtomUpdate(nn.Module):
    def __init__(self, emb_atom, emb_edge, emb_rbf, n_hidden):
        super().__init__()
        self.dense_rbf = Dense(emb_rbf, emb_edge)
        self.scale_sum = Scale()
        self.layers = _atom_mlp(emb_edge, emb_atom, n_hidden)

    def forward(self, n_atoms, m, rbf, id_a):
        x = self.scale_sum(segment_sum(m * self.dense_rbf(rbf), id_a, n_atoms))
        for layer in self.layers:
            x = layer(x)
        return x


class OutputBlock(AtomUpdate):
    def __init__(self, emb_atom, emb_edge, emb_rbf, n_hidden, n_targets):
        super().__init__(emb_atom, emb_edge, emb_rbf, n_hidden)
        self.out_energy = Dense(emb_atom, n_targets)

    def forward(self, n_atoms, m, rbf, id_a):
        return self.out_energy(super().forward(n_atoms, m, rbf, id_a))


class QuadInteraction(nn.Module):
    def __init__(self, c):
        super().__init__()
        e, q = c["emb_size_edge"], c["emb_size_quad"]
        self.dense_db = Dense(e, e, True)
        self.mlp_rbf = Dense(c["emb_size_rbf"], e)
        self.scale_rbf = Scale()
        self.mlp_cbf = Dense(c["emb_size_cbf"], q)
        self.scale_cbf = Scale()
        self.mlp_sbf = Bilinear(q, c["emb_size_sbf"], c["emb_size_bil_quad"])
        self.scale_sbf_sum = Scale()
        self.down_projection = Dense(e, q, True)
        self.up_projection_ca = Dense(c["emb_size_bil_quad"], e, True)
        self.up_projection_ac = Dense(c["emb_size_bil_quad"], e, True)

    def forward(self, m, basis, g):
        x = self.dense_db(m)
        x = self.down_projection(self.scale_rbf(x * self.mlp_rbf(basis["rbf4"])))
        x = x[g["id4_expand_intm_db"]]
        x = self.scale_cbf(x * self.mlp_cbf(basis["cbf4"]))
        x = x[g["id4_expand_abd"]]
        rbf_W1, sph = basis["sbf4"]
        x = self.scale_sbf_sum(self.mlp_sbf(rbf_W1, sph, x, g["id4_reduce_ca"]))
        return (self.up_projection_ca(x) + self.up_projection_ac(x)[g["id_swap"]]) * 2**-0.5


class TripInteraction(nn.Module):
    def __init__(self, c):
        super().__init__()
        e, t = c["emb_size_edge"], c["emb_size_trip"]
        self.dense_ba = Dense(e, e, True)
        self.mlp_rbf = Dense(c["emb_size_rbf"], e)
        self.scale_rbf = Scale()
        self.mlp_cbf = Bilinear(t, c["emb_size_cbf"], c["emb_size_bil_trip"])
        self.scale_cbf_sum = Scale()
        self.down_projection = Dense(e, t, True)
        self.up_projection_ca = Dense(c["emb_size_bil_trip"], e, True)
        self.up_projection_ac = Dense(c["emb_size_bil_trip"], e, True)

    def forward(self, m, basis, g):
        x = self.dense_ba(m)
        x = self.down_projection(self.scale_rbf(x * self.mlp_rbf(basis["rbf3"])))
        x = x[g["id3_expand_ba"]]
        rbf_W1, sph = basis["cbf3"]
        x = self.scale_cbf_sum(self.mlp_cbf(rbf_W1, sph, x, g["id3_reduce_ca"]))
        return (self.up_projection_ca(x) + self.up_projection_ac(x)[g["id_swap"]]) * 2**-0.5


class InteractionBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        e, a = c["emb_size_edge"], c["emb_size_atom"]
        self.triplets_only = c["triplets_only"]
        self.dense_ca = Dense(e, e, True)
        if not self.triplets_only:
            self.quad_interaction = QuadInteraction(c)
        self.trip_interaction = TripInteraction(c)
        self.layers_before_skip = nn.ModuleList(
            [Residual(e) for _ in range(c["num_before_skip"])])
        self.layers_after_skip = nn.ModuleList([Residual(e) for _ in range(c["num_after_skip"])])
        self.atom_update = AtomUpdate(a, e, c["emb_size_rbf"], c["num_atom"])
        self.concat_layer = EdgeEmbedding(2 * a + e, e)
        self.residual_m = nn.ModuleList([Residual(e) for _ in range(c["num_concat"])])

    def forward(self, h, m, basis, g):
        x = self.dense_ca(m) + self.trip_interaction(m, basis, g)
        if self.triplets_only:
            x = x * 2**-0.5
        else:
            x = (x + self.quad_interaction(m, basis, g)) * 3**-0.5
        for layer in self.layers_before_skip:
            x = layer(x)
        m = (m + x) * 2**-0.5
        for layer in self.layers_after_skip:
            m = layer(m)
        h = (h + self.atom_update(h.shape[0], m, basis["rbf_h"], g["id_a"])) * 2**-0.5
        m2 = self.concat_layer(h, m, g["id_c"], g["id_a"])
        for layer in self.residual_m:
            m2 = layer(m2)
        return h, (m + m2) * 2**-0.5


# ------------------------------------------------------------------ geometry


def _angle(u, v):
    cross = torch.linalg.cross(u, v, dim=-1)
    y = torch.sqrt(torch.clamp_min((cross * cross).sum(-1), 1e-18))
    return torch.atan2(y, (u * v).sum(-1))


def _reject(a, n):
    return a - ((a * n).sum(-1) / torch.clamp_min((n * n).sum(-1), 1e-18))[:, None] * n


class GemNet(nn.Module):
    """GemNet-Q (`triplets_only` False) or GemNet-T with -dE/dR forces, from
    the configuration's keys (the names of the published config.yaml)."""

    def __init__(self, c: dict):
        super().__init__()
        if c.get("direct_forces") or not c.get("extensive", True):
            raise NotImplementedError("the reference computes extensive -dE/dR models")
        self.c = c
        S, Rn, p = c["num_spherical"], c["num_radial"], c["envelope_exponent"]
        self.rbf_basis = RadialBasis(Rn, c["cutoff"], p)
        self.cbf_env3 = BesselEnv(S, Rn, c["cutoff"], p)
        if not c["triplets_only"]:
            self.cbf_env4 = BesselEnv(S, Rn, c["int_cutoff"], p)
            self.mlp_rbf4 = Dense(Rn, c["emb_size_rbf"])
            self.mlp_cbf4 = Dense(S * Rn, c["emb_size_cbf"])
            self.mlp_sbf4 = DownProjection(S * S, Rn, c["emb_size_sbf"])
        self.mlp_rbf3 = Dense(Rn, c["emb_size_rbf"])
        self.mlp_cbf3 = DownProjection(S, Rn, c["emb_size_cbf"])
        self.mlp_rbf_h = Dense(Rn, c["emb_size_rbf"])
        self.mlp_rbf_out = Dense(Rn, c["emb_size_rbf"])
        self.atom_emb = AtomEmbedding(c["emb_size_atom"])
        self.edge_emb = EdgeEmbedding(2 * c["emb_size_atom"] + Rn, c["emb_size_edge"])
        self.int_blocks = nn.ModuleList([InteractionBlock(c) for _ in range(c["num_blocks"])])
        self.out_blocks = nn.ModuleList([
            OutputBlock(c["emb_size_atom"], c["emb_size_edge"], c["emb_size_rbf"],
                        c["num_atom"], c.get("num_targets", 1))
            for _ in range(c["num_blocks"] + 1)])

    def energy(self, g: dict, Z, R, n_mol: int):
        """Per-molecule energies (n_mol, num_targets) of the batch `g`
        (tensors of `graph.build`'s arrays) at positions R."""
        c, S = self.c, self.c["num_spherical"]
        id_c, id_a = g["id_c"], g["id_a"]
        V = R[id_a] - R[id_c]
        D = torch.sqrt((V * V).sum(-1))
        r3 = g["id3_reduce_ca"]
        Ra = R[id_a[r3]]
        angle3 = _angle(R[id_c[r3]] - Ra, R[id_c[g["id3_expand_ba"]]] - Ra)
        rbf = self.rbf_basis(D)
        basis = {
            "rbf3": self.mlp_rbf3(rbf),
            "cbf3": (self.mlp_cbf3(self.cbf_env3(D)), legendre_y(angle3, S)),
            "rbf_h": self.mlp_rbf_h(rbf),
        }
        if not c["triplets_only"]:
            ia, ib = g["id4_int_a"], g["id4_int_b"]
            D_ab = torch.sqrt(((R[ia] - R[ib]) ** 2).sum(-1))
            ab = g["id4_expand_intm_ab"]
            R_ba = R[ia[ab]] - R[ib[ab]]
            R_bd = R[id_c[g["id4_expand_intm_db"]]] - R[ib[ab]]
            angle_abd = _angle(R_ba, R_bd)
            R_bd_proj = _reject(R_bd, R_ba)[g["id4_expand_abd"]]
            ca = g["id4_reduce_intm_ca"]
            Ra = R[id_a[ca]]
            R_ac = R[id_c[ca]] - Ra
            R_ab = R[ib[g["id4_reduce_intm_ab"]]] - Ra
            cab = g["id4_reduce_cab"]
            angle_cab = _angle(R_ab, R_ac)[cab]
            angle_cabd = _angle(_reject(R_ac, R_ab)[cab], R_bd_proj)
            env4 = self.cbf_env4(D_ab).reshape(len(D_ab), -1)[ab]
            cbf4 = (env4.reshape(len(ab), S, -1) * legendre_y(angle_abd, S)[:, :, None])
            env3 = self.cbf_env3(D)
            degree = torch.tensor(np.repeat(np.arange(S), 2 * np.arange(S) + 1), device=R.device)
            basis["rbf4"] = self.mlp_rbf4(rbf)
            basis["cbf4"] = self.mlp_cbf4(cbf4.reshape(len(ab), -1))
            basis["sbf4"] = (self.mlp_sbf4(env3[:, degree]),
                             real_sph_harm(angle_cab, angle_cabd, S))
        rbf_out = self.mlp_rbf_out(rbf)
        h = self.atom_emb(Z)
        m = self.edge_emb(h, rbf, id_c, id_a)
        n_atoms = len(Z)
        E_a = self.out_blocks[0](n_atoms, m, rbf_out, id_a)
        for block, out in zip(self.int_blocks, self.out_blocks[1:]):
            h, m = block(h, m, basis, g)
            E_a = E_a + out(n_atoms, m, rbf_out, id_a)
        return segment_sum(E_a, g["batch_seg"], n_mol)

    def energy_and_forces(self, g, Z, R, n_mol, create_graph=False):
        """(E (n_mol, 1), F = -dE/dR (n_atoms, 3))."""
        R = R.detach().requires_grad_(True)
        with torch.enable_grad():
            E = self.energy(g, Z, R, n_mol)
            (dR,) = torch.autograd.grad(E.sum(), R, create_graph=create_graph)
        return (E if create_graph else E.detach()), -dR


def to_tensors(g: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.int64, device=device) for k, v in g.items()}
