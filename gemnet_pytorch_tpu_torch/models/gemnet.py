"""GemNet on padded batches, in PyTorch (port of
`gemnet_pytorch_tpu/models/gemnet.py`; reference gemnet/model/gemnet.py).

| variant   | triplets_only | direct_forces |
|-----------|---------------|---------------|
| GemNet-Q  | False         | False         |
| GemNet-dQ | False         | True          |
| GemNet-T  | True          | False         |
| GemNet-dT | True          | True          |

The forward consumes one padded batch from `data.to_torch` and returns
per-molecule energies plus, with direct forces, per-atom forces.
`energy_and_forces` derives F = -dE/dR with `torch.autograd.grad`
otherwise. A single-device batch must carry the sort metadata and the
segment plans of `to_torch` (or the packer): the bilinear reductions run
on the plans, and each gather by an index column of the table
`data.batch.SORTED_GATHERS` reads its sort with `gather_sorts`, once in
`preamble`, so its VJP is the sorted segment sum K3. A halo or ep shard
carries none, and every gather there is plain. Whether a wrapper launches
its hand-written kernel or runs its plain version follows the tensor's
device (`ops._cuda.use_kernel`): the kernel on the card, the plain version
on the CPU.

A periodic batch (`edge_offset` and `cell`, `data.graph`) runs OCP's
GemNet-T geometry: each edge's vector from its source's image, R[t] - R[s]
- o.cell, and the triplet angles from the edges' unit vectors. The bases
follow the configuration's `rbf` and `cbf`: TUM's Bessel bases by default,
or OCP's GemNetT (`rbf` "gaussian", `cbf` "spherical_harmonics": the
circular basis is Y_l0 of the angle's cosine over the radial basis' rows,
shared by every order, so the down-projection takes (nEdges, num_radial)
rows), whose direct-force head is also OCP's (`OutputBlock`'s
`ocp_forces`).

compute_dtype="bfloat16" is the JAX package's mixed-precision mode
(`gemnet_pytorch_tpu/models/gemnet.py:90-101`): geometry and basis
generation stay fp32; the basis outputs and every layer compute in bf16
(master parameters stay fp32 and are cast per call); segment reductions sum
in fp32; E and F are returned in fp32.

matmul_precision="high" is the JAX package's fast fp32 training mode
(`gemnet_pytorch_tpu/models/gemnet.py:377-386`): the bilinear reductions K1
and K2 run the split3 kernels (K4, `ops/segment_outer.py`), in the forward,
the -dE/dR backward and the loss's grad-of-grad. The precision is carried
as an argument down to `ops.bilinear`, not set process-wide. Everything
else stays exact fp32: the geometry segment sums (K3), as in JAX
(`ops/pallas/segment_outer.py:167-168`), and the dense layers, with TF32 off
(`_cuda.set_matmul_precision` is the same in every mode). JAX's "high" means
bf16x3 on its chip, about 16 mantissa bits; TF32, the card's cheap fp32
product, keeps 10. And PyTorch's flag for fp32 products
(`torch.backends.cuda.matmul.allow_tf32`) is process-wide: it cannot be
scoped to one model's dense backward matmuls. "default" and "highest" are
exact fp32.

remat_blocks recomputes each interaction block and each output block of the
block loop in the backward instead of holding its intermediates (JAX
`models/gemnet.py:300-304`, `nn.remat`), through
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: every backward
that reaches a block (the -dE/dR backward and the loss's grad-of-grad) runs
its forward again, with its K1 launches, and differentiates the recomputed
graph. The numbers are the same: the recomputation runs the same ops on the
same inputs. The model draws no random numbers, so the RNG state is
neither saved nor restored (no read of the CUDA generator inside a graph
capture).

ep_halo=True (with ep_axis, JAX's axis name) is the halo edge partition
(`parallel/halo.py`, JAX `models/gemnet.py:120-127`, `:148-160`,
`:264-276`, `:322-323`, `:371-372`): the model runs on one rank's shard of
a halo partition, over the process group `group` (`parallel.halo.halo_model`
makes such a view of a model, sharing its parameters). The geometry takes
the partitioner's per-row atom indices, the blocks exchange halo rows and
psum the per-atom accumulators, the direct-force F_atom is psum'd, and E
and F come out replicated on every rank.

ep_axis without ep_halo is the JAX package's "rung 2a" (`parallel/ep.py`,
JAX `models/gemnet.py:159-170`, `models/interaction.py:72`, `:97`, `:117-120`,
`:173`, `:192-195`): the model runs on one rank's chunk of the triplet and
quadruplet rows (`parallel.ep.ep_model` makes such a view over `group`),
with every other space replicated. The chunk carries no sort metadata, so
its gathers are plain gathers; each block psums its bilinear outputs;
everything after them computes replicated, so E and the direct F come out
replicated with no further collective (-dE/dR as the halo mode's).

The forward is three parts, as JAX's `GemNet.__call__(return_state=True)`
and `finalize_outputs` split it for the pipeline (`parallel/pp.py`):
`preamble` (up to and with `out_blocks[0]`), `run_blocks` on any contiguous
range of the block loop, and `finalize_outputs`.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..data.batch import SORT_META_KEYS, gather_sorts, sort_keys
from ..ops import _cuda, geometry
from ..ops.segment import masked_segment_mean, masked_segment_sum
from ..parallel import mesh
from ..parallel.collectives import psum
from .basis import (
    CircularBasis,
    CircularHarmonics,
    GaussianBasis,
    RadialBasis,
    SphericalBasis,
)
from .interaction import InteractionBlock
from .layers import (
    AtomEmbedding,
    Dense,
    EdgeEmbedding,
    EfficientInteractionDownProjection,
    OutputBlock,
)


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = {
        "compute_dtype": cfg.compute_dtype not in ("float32", "bfloat16"),
        "matmul_precision": cfg.matmul_precision not in ("default", "high", "highest"),
    }
    for knob, bad in unsupported.items():
        if bad:
            raise NotImplementedError(
                f"{knob}={getattr(cfg, knob)!r} is not supported by the PyTorch port yet")
    if cfg.ep_halo and cfg.ep_axis is None:
        raise ValueError("ep_halo needs ep_axis (the axis name; parallel.halo.halo_model sets "
                         "both)")
    if (cfg.rbf, cfg.cbf) not in (("bessel", "bessel"), ("gaussian", "spherical_harmonics")):
        raise NotImplementedError(f"rbf={cfg.rbf!r}, cbf={cfg.cbf!r}: the port has TUM's bases "
                                  "('bessel', 'bessel') or OCP's ('gaussian', "
                                  "'spherical_harmonics')")
    if _ocp(cfg) and cfg.ep_axis is not None:
        raise NotImplementedError("OCP's GemNet-T runs on one device or under dp")
    if _ocp(cfg) and not cfg.triplets_only:
        raise NotImplementedError("OCP's bases are ported for GemNet-(d)T only")


def _ocp(cfg: ModelConfig) -> bool:
    """OCP's GemNet-T (its bases, and its direct-force head), not TUM's."""
    return cfg.rbf == "gaussian"


def _required(batch: dict, keys) -> None:
    missing = [k for k in keys if k not in batch]
    if missing:
        raise KeyError(f"batch lacks {missing}: build it with pad_batch and data.to_torch")


# the halo shard's keys the forward reads besides the plans
HALO_KEYS = ("trip_b_atom", "edge_halo_send_idx", "edge_halo_send_mask", "id3_reduce_ca_plan")
HALO_QUAD_KEYS = ("intm_ext_a_atom", "intm_ext_b_atom", "intm_ext_d_atom", "intm_halo_send_idx",
                  "intm_halo_send_mask", "id4_reduce_ca_plan")


# the state the block loop carries from block to block (and a pipeline from
# stage to stage, `parallel/pp.py`)
CARRY_KEYS = ("h", "m", "E_a", "F_ca")


class GemNet(nn.Module):
    """GemNet-(d)T/(d)Q. Weights are drawn from `generator` on the CPU and
    the module is then moved to `device`. `group`: the process group of a
    partitioned model (cfg.ep_axis: halo or rung 2a)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator, device="cuda",
                 group=None):
        super().__init__()
        _check_supported(cfg)
        self.group = group
        # full fp32 dense products on the card in every mode (module docstring)
        _cuda.set_matmul_precision()
        precision = "split3" if cfg.matmul_precision == "high" else "exact"
        self.cfg = cfg
        self.cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        kw = dict(generator=generator, dtype=self.cdt)
        S, Rn = cfg.num_spherical, cfg.num_radial
        if cfg.rbf == "gaussian":
            self.rbf_basis = GaussianBasis(Rn, cfg.cutoff, cfg.envelope_exponent)
        else:
            self.rbf_basis = RadialBasis(Rn, cutoff=cfg.cutoff,
                                         envelope_exponent=cfg.envelope_exponent)
        if cfg.cbf == "spherical_harmonics":
            # OCP's circular basis: Y_l0(cos) over the radial basis' rows
            self.cbf_basis3 = CircularHarmonics(S)
        else:
            self.cbf_basis3 = CircularBasis(S, Rn, cutoff=cfg.cutoff,
                                            envelope_exponent=cfg.envelope_exponent)
        if not cfg.triplets_only:
            # 2D basis over interaction edges (dense mode, int_cutoff)
            self.cbf_basis = CircularBasis(S, Rn, cutoff=cfg.int_cutoff,
                                           envelope_exponent=cfg.envelope_exponent)
            self.sbf_basis = SphericalBasis(S, Rn, cutoff=cfg.cutoff,
                                            envelope_exponent=cfg.envelope_exponent)
            self.mlp_rbf4 = Dense(Rn, cfg.emb_size_rbf, **kw)
            self.mlp_cbf4 = Dense(S * Rn, cfg.emb_size_cbf, **kw)
            self.mlp_sbf4 = EfficientInteractionDownProjection(S**2, Rn, cfg.emb_size_sbf, **kw)
        self.mlp_rbf3 = Dense(Rn, cfg.emb_size_rbf, **kw)
        self.mlp_cbf3 = EfficientInteractionDownProjection(S, Rn, cfg.emb_size_cbf, **kw)
        self.mlp_rbf_h = Dense(Rn, cfg.emb_size_rbf, **kw)
        self.mlp_rbf_out = Dense(Rn, cfg.emb_size_rbf, **kw)
        self.atom_emb = AtomEmbedding(cfg.emb_size_atom, **kw)
        self.edge_emb = EdgeEmbedding(2 * cfg.emb_size_atom + Rn, cfg.emb_size_edge,
                                      cfg.activation, **kw)
        self.int_blocks = nn.ModuleList([
            InteractionBlock(
                cfg.emb_size_atom, cfg.emb_size_edge, cfg.emb_size_trip, cfg.emb_size_quad,
                cfg.emb_size_rbf, cfg.emb_size_cbf, cfg.emb_size_sbf, cfg.emb_size_bil_trip,
                cfg.emb_size_bil_quad, cfg.num_before_skip, cfg.num_after_skip,
                cfg.num_concat, cfg.num_atom, cfg.triplets_only, block_nr=i + 1,
                activation=cfg.activation, precision=precision, **kw)
            for i in range(cfg.num_blocks)])
        self.out_blocks = nn.ModuleList([
            OutputBlock(
                cfg.emb_size_atom, cfg.emb_size_edge, cfg.emb_size_rbf, cfg.num_atom,
                cfg.num_targets, cfg.activation, cfg.direct_forces, cfg.output_init,
                f"OutBlock_{i}", ocp_forces=_ocp(cfg), **kw)
            for i in range(cfg.num_blocks + 1)])
        self.to(device)

    def forward(self, batch: dict[str, torch.Tensor], R: torch.Tensor | None = None):
        """(E, F): E (n_mol_pad, num_targets); F per-atom (n_atoms_pad,
        num_targets, 3) with direct forces, else the per-edge heads, zero.
        `R` overrides batch["R"] so the caller can differentiate w.r.t. it."""
        state = self.preamble(batch, R)
        carry = self.run_blocks(tuple(state[k] for k in CARRY_KEYS), state)
        return finalize_outputs(self.cfg, batch, *carry[2:], state["V_ca"], self._out_group())

    def _out_group(self):
        # the output blocks' psum: the halo mode's alone (JAX gemnet.py:276)
        return self.group if self.cfg.ep_halo else None

    def preamble(self, batch: dict[str, torch.Tensor], R: torch.Tensor | None = None) -> dict:
        """Everything before the block loop (JAX `GemNet.__call__(return_state=
        True)`, `gemnet_pytorch_tpu/models/gemnet.py:291-298`): geometry,
        bases, the shared down-projections, the embeddings and
        `out_blocks[0]`. Returns the carried state `h`, `m`, `E_a`, `F_ca`
        (CARRY_KEYS) and what every block reads: `basis`, `rbf_out`, `ind`,
        `masks`, and `V_ca` for `finalize_outputs`."""
        cfg, cdt = self.cfg, self.cdt
        halo = cfg.ep_halo
        # rung 2a: the rows are a shard's, the rest replicated (parallel/ep.py)
        ep = cfg.ep_axis is not None and not halo
        if cfg.ep_axis is not None and self.group is None:
            kind, make = ("halo", "halo.halo_model") if halo else ("ep", "ep.ep_model")
            raise ValueError(f"a{'n' if ep else ''} {kind} model runs over a process group: "
                             f"make it with parallel.{make}(model, group)")
        if halo:
            _required(batch, HALO_KEYS + (() if cfg.triplets_only else HALO_QUAD_KEYS))
        else:
            _required(batch, ("id3_reduce_ca_plan",)
                      + (() if cfg.triplets_only else ("id4_reduce_ca_plan",)))
            stale = [k for k in SORT_META_KEYS if k in batch]
            if not ep:
                _required(batch, sort_keys(batch))
            elif stale:
                raise ValueError(f"an ep shard carries no sort metadata ({stale}): build it "
                                 "with parallel.ep.partition_batch")
        # {index column: (perm, sorted ids, plan)}; {} on a halo or ep shard
        sorts = gather_sorts(batch)
        edge_sorts = (sorts.get("id_c"), sorts.get("id_a"))
        if R is None:
            R = batch["R"]
        Z = batch["Z"]
        id_c, id_a = batch["id_c"], batch["id_a"]
        edge_mask, atom_mask = batch["edge_mask"], batch["atom_mask"]
        masks = {"edge": edge_mask, "atom": atom_mask, "trip": batch["trip_mask"]}

        # ---- geometry ----
        periodic = "edge_offset" in batch
        if periodic and cfg.ep_axis is not None:
            raise NotImplementedError("periodic batches run on one device or under dp")
        shift = (geometry.edge_shifts(batch["edge_offset"], batch["cell"], batch["batch_seg"],
                                      id_a) if periodic else None)
        D_ca, V_ca = geometry.interatomic_vectors(R, id_c, id_a, edge_mask, shift, edge_sorts)
        harmonics = cfg.cbf == "spherical_harmonics"
        if harmonics:
            # OCP's cos of the angle from the edges' unit vectors
            angles3 = geometry.triplet_cosines(V_ca, batch["id3_reduce_ca"],
                                               batch["id3_expand_ba"])
        elif periodic:
            raise NotImplementedError("periodic batches take cbf 'spherical_harmonics' (OCP's)")
        elif halo:
            # the expand edge's source atom, precomputed per local triplet row
            angles3 = geometry.triplet_angles_halo(R, id_c, id_a, batch["id3_reduce_ca"],
                                                   batch["trip_b_atom"])
        else:
            # the edges' R[a] - R[c] again, not the distances': each path's
            # part of -dE/dR then reaches R through its own gathers, as in
            # the JAX package; one shared difference sums them per edge
            # first, and that fp32 order alone takes the AGC trajectory of
            # tests/test_torch_tp.py past its gate against JAX
            angles3 = geometry.triplet_angles(geometry.edge_vectors(R, id_c, id_a, edge_sorts),
                                              batch["id3_reduce_ca"], batch["id3_expand_ba"],
                                              sorts.get("id3_reduce_ca"),
                                              sorts.get("id3_expand_ba"))

        # ---- basis: triplets ----
        rbf = self.rbf_basis(D_ca) * edge_mask[:, None].to(R.dtype)
        if harmonics:
            cbf3_env = rbf  # (E, R), shared by the S orders
            sph3 = self.cbf_basis3.cbf_cos(angles3)  # (T, S): rows feed kernel K1
        else:
            cbf3_env = self.cbf_basis3.rbf_env(D_ca, edge_mask)  # (E, S, R)
            sph3 = self.cbf_basis3.cbf(angles3)  # (T, S): rows feed kernel K1

        basis = {}
        if not cfg.triplets_only:
            masks.update(quad=batch["quad_mask"], intm_db=batch["intm_db_mask"],
                         int_edge=batch["int_edge_mask"])
            D_ab, _ = geometry.interatomic_vectors(
                R, batch["id4_int_b"], batch["id4_int_a"], masks["int_edge"])
            if halo:
                phi_cab, phi_abd, theta_cabd = geometry.quadruplet_angles_halo(
                    R, id_c, id_a, batch["id4_int_b"], batch["id4_reduce_intm_ca"],
                    batch["id4_reduce_intm_ab"], batch["id4_reduce_cab"],
                    batch["intm_ext_a_atom"], batch["intm_ext_b_atom"],
                    batch["intm_ext_d_atom"], batch["id4_expand_intm_db"].shape[0],
                    batch["id4_expand_abd"])
            else:
                phi_cab, phi_abd, theta_cabd = geometry.quadruplet_angles(
                    R, id_c, id_a, batch["id4_int_b"], batch["id4_int_a"],
                    batch["id4_expand_abd"], batch["id4_reduce_cab"],
                    batch["id4_expand_intm_db"], batch["id4_reduce_intm_ca"],
                    batch["id4_expand_intm_ab"], batch["id4_reduce_intm_ab"],
                    sorts.get("id4_expand_abd"), sorts.get("id4_reduce_cab"))
            # dense circular basis on the intermediate d->b space
            # (reference gemnet.py:517, basis_layers.py:133-147)
            cbf4_env = self.cbf_basis.rbf_env(D_ab, masks["int_edge"])  # (IE, S, R)
            cbf4_env_g = cbf4_env.reshape(cbf4_env.shape[0], -1)[batch["id4_expand_intm_ab"]]
            sph4 = self.cbf_basis.cbf(phi_abd)  # (intm, S)
            n_intm_rows = cbf4_env_g.shape[0]
            cbf4_dense = (
                cbf4_env_g.reshape(n_intm_rows, sph4.shape[1], -1) * sph4[:, :, None]
            ).reshape(n_intm_rows, -1)
            sbf_env = self.sbf_basis.rbf_env3(D_ca, edge_mask)  # (E, S^2, R)
            sph_sbf = self.sbf_basis.sbf(phi_cab, theta_cabd)  # (Q, S^2)
            if cdt is not None:
                cbf4_dense, sbf_env, sph_sbf = (
                    cbf4_dense.to(cdt), sbf_env.to(cdt), sph_sbf.to(cdt))
        if cdt is not None:
            rbf, cbf3_env, sph3 = rbf.to(cdt), cbf3_env.to(cdt), sph3.to(cdt)

        # ---- shared down-projections ----
        if not cfg.triplets_only:
            basis["rbf4"] = self.mlp_rbf4(rbf)
            basis["cbf4"] = self.mlp_cbf4(cbf4_dense)
            basis["sbf4"] = (self.mlp_sbf4(sbf_env), sph_sbf)
        basis["rbf3"] = self.mlp_rbf3(rbf)
        basis["cbf3"] = (self.mlp_cbf3(cbf3_env), sph3)
        basis["rbf_h"] = self.mlp_rbf_h(rbf)
        rbf_out = self.mlp_rbf_out(rbf)

        # ---- embeddings ----
        h = self.atom_emb(Z)
        m = self.edge_emb(h, rbf, id_c, id_a, edge_sorts)

        ind = {k: batch[k] for k in ("id_c", "id_a", "id_swap", "id3_expand_ba",
                                     "id3_reduce_ca", "id3_reduce_ca_plan")}
        ind["sorts"] = sorts
        if not cfg.triplets_only:
            ind.update({k: batch[k] for k in ("id4_reduce_ca", "id4_reduce_ca_plan",
                                              "id4_expand_intm_db", "id4_expand_abd")})
        group = self._out_group()
        if halo:
            ind["halo_group"] = group
            ind["edge_send"] = (batch["edge_halo_send_idx"], batch["edge_halo_send_mask"])
            if not cfg.triplets_only:
                ind["intm_send"] = (batch["intm_halo_send_idx"], batch["intm_halo_send_mask"])
        elif ep:
            ind["ep_group"] = self.group  # the bilinear outputs' psum

        E_a, F_ca = self.out_blocks[0](h, m, rbf_out, id_a, edge_mask, atom_mask, group)
        return dict(h=h, m=m, E_a=E_a, F_ca=F_ca, basis=basis, rbf_out=rbf_out, ind=ind,
                    masks=masks, V_ca=V_ca)

    def run_blocks(self, carry, consts: dict, start: int = 0, stop: int | None = None):
        """Interaction and output blocks `start` to `stop` (default all) of
        the block loop on the carried state `carry` = (h, m, E_a, F_ca);
        `consts` is the preamble's dict (basis, rbf_out, ind, masks).
        Returns the carry after them. `remat_blocks` recomputes each block
        in the backward, as JAX's pipeline stage does (`parallel/pp.py:83-84`)."""
        h, m, E_a, F_ca = carry
        basis, ind, masks = consts["basis"], consts["ind"], consts["masks"]
        rbf_out = consts["rbf_out"]
        group = self._out_group()
        run = _remat if self.cfg.remat_blocks else _call
        stop = self.cfg.num_blocks if stop is None else stop
        for i in range(start, stop):
            h, m = run(self.int_blocks[i], h, m, basis, ind, masks)
            E, F = run(self.out_blocks[i + 1], h, m, rbf_out, ind["id_a"], masks["edge"],
                       masks["atom"], group)
            E_a = E_a + E
            F_ca = F_ca + F
        return h, m, E_a, F_ca


def _call(block, *args):
    return block(*args)


# remat_blocks (module docstring)
_remat = functools.partial(checkpoint, use_reentrant=False, preserve_rng_state=False)


def finalize_outputs(cfg: ModelConfig, batch, E_a, F_ca, V_ca, group=None):
    """Per-molecule energy aggregation and the direct-force edge->atom
    mapping (reference gemnet.py:578-592); a halo model's F_atom is psum'd
    over `group` (JAX `models/gemnet.py:371-372`). The `id_undir` average
    is local: a shard owns both directions of its pairs."""
    atom_mask, edge_mask = batch["atom_mask"], batch["edge_mask"]
    n_mol = batch["mol_mask"].shape[0]
    if cfg.extensive:
        E_mol = masked_segment_sum(E_a, batch["batch_seg"], n_mol, mask=atom_mask)
    else:
        E_mol = masked_segment_mean(E_a, batch["batch_seg"], n_mol, mask=atom_mask)
    E_mol = E_mol.float()
    if cfg.direct_forces:
        if cfg.forces_coupled:
            # |F_ca| = |F_ac| via the undirected mean (reference gemnet.py:588-592)
            n_undir = batch["id_c"].shape[0] // 2
            F_und = masked_segment_mean(F_ca, batch["id_undir"], n_undir, mask=edge_mask)
            F_ca = F_und[batch["id_undir"]]
        F_ji = F_ca[:, :, None] * V_ca[:, None, :]  # (E, T, 3)
        F_atom = psum(masked_segment_sum(F_ji, batch["id_a"], batch["Z"].shape[0],
                                         mask=edge_mask), group)
        return E_mol, F_atom.float()
    return E_mol, F_ca.float()


def energy_and_forces(model: GemNet, batch: dict[str, torch.Tensor], create_graph: bool = False):
    """(E, F) with the variant's force path: the direct head, or
    F = -dE/dR through autograd (reference gemnet.py:598-613), shaped
    (n_atoms_pad, num_targets, 3).

    With num_targets > 1 (JAX `models/gemnet.py:415-430`): one forward, then
    one `torch.autograd.grad` of E[:, t].sum() per target, the graph
    retained for all but the last. Not `is_grads_batched`: it runs the
    backward under vmap, which the kernels' autograd Functions do not
    support.

    Serving passes create_graph=False and a model whose parameters do not
    require grad (`GemNetCalculator` freezes them), so no graph over the
    parameters is built; training (grad-of-grad) passes create_graph=True.

    A partitioned model (cfg.ep_axis: halo or rung 2a) returns E replicated
    and F exact and replicated on every rank: each energy sum is seeded with
    1/P on each of the P ranks, and the ranks' R-gradients are psum'd
    (`parallel/halo.py`, `parallel/ep.py`).
    """
    cfg = model.cfg
    if cfg.direct_forces:
        return model(batch)
    group = model.group if cfg.ep_axis is not None else None
    seed = 1.0 / mesh.world_size(group) if group is not None else None
    R = batch["R"].detach().requires_grad_(True)
    n_targets = cfg.num_targets
    with torch.enable_grad():
        E, _ = model(batch, R)
        dE_dR = [torch.autograd.grad(E[:, t].sum() if seed is None else E[:, t].sum() * seed, R,
                                     create_graph=create_graph,
                                     retain_graph=create_graph or t < n_targets - 1)[0]
                 for t in range(n_targets)]
    if not create_graph:
        E = E.detach()
    # one target: a view, no copy (the normal step's graph stays as it was)
    dE_dR = dE_dR[0][:, None, :] if n_targets == 1 else torch.stack(dE_dR, dim=1)
    return E, -psum(dE_dR, group)
