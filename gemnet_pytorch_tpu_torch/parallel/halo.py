"""The halo edge partition ("rung 2b" of the JAX package,
`gemnet_pytorch_tpu/parallel/halo.py`): each rank owns a slice of the edge
space and exchanges halo rows with its peers.

Ownership (the host partitioner, `build_halo_partition`, a numpy copy of the
JAX package's, array for array):

- **Edges** are owned by undirected PAIR, in contiguous ranges of the
  canonical pair order whose cut points balance triplet+quad row counts;
  each shard lays out its edges as [its lower halves ; its upper halves],
  so `id_swap` and the `id_undir` coupling stay shard-local.
- **Triplet/quad rows** live with their REDUCE edge (id3_reduce_ca /
  id4_reduce_ca): the bilinear's segment reduction (kernel K1) runs over
  local rows onto local edges, with local segment plans; its VJP (K2) too.
  No cross-shard combine of bilinear outputs.
- **Intermediate-db rows** live with their d->b edge, making the
  edge->intm activation gather local; **intermediate-ca rows** with their
  c->a edge, the quad reduce edge, so `id4_reduce_cab` is local too.
- **Atoms / molecules / interaction edges** are replicated (R is 3 floats an
  atom); per-atom reductions psum the small (nAtoms, emb) accumulators.

Cross-shard reads (the halo): the triplet expand `x_ba[id3_expand_ba]`
reads edge activations other shards own, the quad expand
`x_db[id4_expand_abd]` intermediate-db activations. The host precomputes
per (shard, owner) sorted request lists; at run time ONE all-to-all per
interaction block per space exchanges exactly the referenced halo rows
(`halo_exchange`), and the expand indices are pre-remapped to [local slots ;
halo slots]. Geometry never needs an exchange: per-row ATOM indices are
precomputed for owned and halo rows.

Gradients: JAX differentiates outside a `shard_map` with `check_vma=True`.
Here every collective is a Function whose backward is its transpose
(`collectives.py`), the energy sum of -dE/dR and the loss are seeded with
1/P on each of the P ranks, the R-gradient becomes F through `psum`, and the
parameter gradient is all-reduced once, as one flat buffer. Each rule is
the exact adjoint of the program unrolled over the ranks, so the gradients
equal the single-device ones up to summation order (tests/test_torch_halo.py).

A rank runs the model on its shard (`shard_halo_batch`, or
`local_halo_batch` for the host side of a captured step): the segment plans
of `data.to_torch` are built from the shard's own `id3_reduce_ca` and
`id4_reduce_ca`, at capacities `HaloPads` fixes, so every batch padded to
one `HaloPads` gives plans of one shape and a captured halo step replays
across batches. The shard carries no sort metadata: the halo model's
expand gathers are plain gathers (the JAX package's too,
`models/interaction.py:64-70`), so the sorted segment sum K3 is off this
path.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..data.batch import to_torch
from ..data.graph import GraphArrays
from ..data.padding import EDGE_BLOCK, ROW_BLOCK, _row_splits, round_up
from . import mesh
from .collectives import all_to_all, broadcast_

INT = np.int32

EP_AXIS = "ep"


@dataclasses.dataclass(frozen=True)
class HaloPads:
    """Static per-shard sizes of a halo partition.

    Mirrors data/padding.PadDims: padding every batch to one fixed HaloPads
    gives every shard's arrays and segment plans one shape, so a captured
    halo train step replays across batches. Each field
    is a lower bound — `build_halo_partition` uses max(natural, pad) per
    dimension and reports the sizes actually used under the host-only
    "halo_pads" batch key, so callers can detect outlier batches and grow.
    """

    half: int = 64        # owned edge PAIRS per shard (local edges = 2*half)
    h_e: int = 8          # edge-halo rows per peer
    t_loc: int = ROW_BLOCK   # local triplet rows
    ie: int = 64          # interaction edges (replicated space)
    i_ca: int = 64        # local intermediate-ca rows
    i_db: int = 64        # local intermediate-db rows
    h_i: int = 8          # intm-halo rows per peer
    q_loc: int = ROW_BLOCK   # local quadruplet rows
    n_mol: int = 1
    n_atoms: int = 16

    def grow_to(self, other: "HaloPads", headroom: float = 1.0) -> "HaloPads":
        """Elementwise max against `other` scaled by `headroom`, respecting
        each dimension's block granularity."""

        def up(a: int, b: int, block: int) -> int:
            need = max(a, int(np.ceil(b * headroom)))
            return int(round_up(max(need, block), block)) if need else 0

        return HaloPads(
            half=up(self.half, other.half, 64),
            h_e=up(self.h_e, other.h_e, 8),
            t_loc=up(self.t_loc, other.t_loc, ROW_BLOCK),
            ie=up(self.ie, other.ie, 64),
            i_ca=up(self.i_ca, other.i_ca, 64),
            i_db=up(self.i_db, other.i_db, 64),
            h_i=up(self.h_i, other.h_i, 8),
            q_loc=up(self.q_loc, other.q_loc, ROW_BLOCK),
            n_mol=max(self.n_mol, other.n_mol),
            n_atoms=up(self.n_atoms, other.n_atoms, 16),
        )

    def covers(self, other: "HaloPads") -> bool:
        return all(
            getattr(self, f.name) >= getattr(other, f.name)
            for f in dataclasses.fields(self)
        )


# ======================================================================
# host partitioner
# ======================================================================


def _balance_pairs(cost_per_pair: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous pair ranges with ~equal total cost; returns bounds
    (n_shards+1,) with bounds[0]=0, bounds[-1]=n_pairs."""
    n_pairs = len(cost_per_pair)
    cum = np.cumsum(cost_per_pair.astype(np.float64))
    total = cum[-1] if len(cum) else 0.0
    if total <= 0:
        bounds = np.linspace(0, n_pairs, n_shards + 1).round().astype(np.int64)
        return bounds
    targets = total * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [n_pairs]]).astype(np.int64)
    return np.maximum.accumulate(bounds)  # keep monotone for degenerate cases


def _chunked_rows(sorted_ids: np.ndarray, lo: int, hi: int) -> slice:
    """Row range [searchsorted(lo), searchsorted(hi)) of ids sorted asc."""
    return slice(
        int(np.searchsorted(sorted_ids, lo, side="left")),
        int(np.searchsorted(sorted_ids, hi, side="left")),
    )


class _HaloIndexer:
    """Build per-(shard, owner) request lists for one partitioned space and
    remap global refs to [local slot ; halo slot] addressing."""

    def __init__(self, owner: np.ndarray, local_slot: np.ndarray,
                 n_local_pad: int, n_shards: int):
        self.owner = owner          # (n_global,) shard owning each row
        self.local_slot = local_slot  # (n_global,) slot within the owner
        self.n_local_pad = n_local_pad
        self.n_shards = n_shards
        # requests[s][o] = sorted unique global ids shard s reads from o != s
        self.requests = [[None] * n_shards for _ in range(n_shards)]

    def collect(self, shard: int, refs: np.ndarray) -> None:
        refs = np.unique(refs)
        own = self.owner[refs]
        for o in range(self.n_shards):
            if o == shard:
                continue
            r = refs[own == o]
            prev = self.requests[shard][o]
            if prev is not None:
                r = np.union1d(prev, r)
            self.requests[shard][o] = r

    def finalize(self, h_pad: int | None = None):
        """Freeze request lists; returns (halo_size_per_peer, send_idx,
        send_mask, halo_real_counts). `h_pad` is a LOWER bound on the halo
        size (fixed-shape batching, HaloPads); the natural size wins if
        larger."""
        S = self.n_shards
        counts = np.zeros((S, S), np.int64)
        for s in range(S):
            for o in range(S):
                if self.requests[s][o] is not None:
                    counts[s, o] = len(self.requests[s][o])
        h = max(int(counts.max()), h_pad or 0)
        h = max(round_up(h, 8), 8)
        self.h = h
        # send_idx[s, o, j]: local slot (in shard s) of the j-th row shard o
        # requested FROM s; all_to_all then delivers, on shard s, peer o's
        # requests of s ... i.e. recv[o] on shard s == rows s requested from o.
        send_idx = np.zeros((S, S, h), INT)
        send_mask = np.zeros((S, S, h), np.bool_)
        for s in range(S):
            for o in range(S):
                req = self.requests[o][s]  # what o wants from s
                if req is None or len(req) == 0:
                    continue
                send_idx[s, o, : len(req)] = self.local_slot[req]
                send_mask[s, o, : len(req)] = True
        self.send_idx, self.send_mask, self.counts = send_idx, send_mask, counts
        return h, send_idx, send_mask, counts

    def remap(self, shard: int, refs: np.ndarray) -> np.ndarray:
        """Global ids -> [0, n_local_pad) local or halo slots
        n_local_pad + o*h + pos."""
        out = np.zeros(len(refs), INT)
        own = self.owner[refs]
        local = own == shard
        out[local] = self.local_slot[refs[local]]
        for o in range(self.n_shards):
            if o == shard:
                continue
            sel = own == o
            if not sel.any():
                continue
            req = self.requests[shard][o]
            pos = np.searchsorted(req, refs[sel])
            assert np.array_equal(req[pos], refs[sel]), "halo request mismatch"
            out[sel] = self.n_local_pad + o * self.h + pos
        return out


def _pad_rows(arrs: dict[str, np.ndarray], n: int, fills: dict[str, int]):
    out = {}
    for k, a in arrs.items():
        fill = fills.get(k, 0)
        p = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
        p[: len(a)] = a
        out[k] = p
    return out


def build_halo_partition(
    g: GraphArrays,
    Z: np.ndarray,
    R: np.ndarray,
    n_shards: int,
    E: np.ndarray | None = None,
    F: np.ndarray | None = None,
    triplets_only: bool = False,
    n_mol_pad: int | None = None,
    n_atoms_pad: int | None = None,
    pads: HaloPads | None = None,
) -> dict[str, np.ndarray]:
    """Partition one canonical batched graph across `n_shards` for the
    edge-partitioned (halo) execution mode.

    Returns a batch dict where per-shard arrays (SHARDED_KEYS) carry a
    leading (n_shards,) axis and atom/molecule-level arrays are replicated.
    `pads` gives per-dimension lower bounds so every batch of a training run
    shares one static shape (one capture); the host-only "halo_pads" key
    reports the sizes actually used (== `pads` whenever it covers the batch).
    """
    nE = g.n_edges
    nE2 = nE // 2
    n_mol = int(g.batch_seg.max()) + 1 if len(g.batch_seg) else 0
    n_atoms = len(Z)
    pads = pads or HaloPads(half=0, h_e=0, t_loc=0, ie=0, i_ca=0, i_db=0,
                            h_i=0, q_loc=0, n_mol=0, n_atoms=0)
    n_mol_pad = n_mol_pad or max(n_mol, pads.n_mol)
    n_atoms_pad = n_atoms_pad or max(round_up(n_atoms, 16), pads.n_atoms)

    # ---- pair ownership balanced by triplet+quad row count ----
    cost_e = np.bincount(g.id3_reduce_ca, minlength=nE).astype(np.float64)
    if not triplets_only and g.n_quads:
        cost_e += np.bincount(g.id4_reduce_ca, minlength=nE)
    cost_pair = cost_e[:nE2] + cost_e[nE2:] + 1.0  # +1: count the edges too
    bounds = _balance_pairs(cost_pair, n_shards)
    pairs_per = np.diff(bounds)
    half = max(round_up(int(pairs_per.max()), 64), 64, pads.half)
    E_loc = 2 * half

    pair_of = np.where(np.arange(nE) < nE2, np.arange(nE), np.arange(nE) - nE2)
    is_upper = (np.arange(nE) >= nE2).astype(np.int64)
    owner_pair = np.repeat(np.arange(n_shards), pairs_per)
    edge_owner = owner_pair[pair_of]
    edge_local = (pair_of - bounds[edge_owner] + is_upper * half).astype(INT)

    edge_ix = _HaloIndexer(edge_owner, edge_local, E_loc, n_shards)

    out: dict[str, np.ndarray] = {}
    # ---- replicated atom/molecule arrays (same as pad_batch) ----
    def pad1(a, n, fill=0):
        p = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
        p[: len(a)] = a
        return p

    out["Z"] = pad1(Z.astype(INT), n_atoms_pad, fill=1)
    out["R"] = pad1(R.astype(np.float32), n_atoms_pad)
    out["batch_seg"] = pad1(g.batch_seg, n_atoms_pad)
    out["atom_mask"] = (np.arange(n_atoms_pad) < n_atoms)
    out["mol_mask"] = (np.arange(n_mol_pad) < n_mol)
    if E is not None:
        out["E"] = pad1(E.reshape(n_mol, -1).astype(np.float32), n_mol_pad)
    if F is not None:
        out["F"] = pad1(F.astype(np.float32), n_atoms_pad)

    # ---- per-shard edge arrays ----
    S = n_shards
    id_c_l = np.zeros((S, E_loc), INT)
    id_a_l = np.zeros((S, E_loc), INT)
    edge_mask_l = np.zeros((S, E_loc), np.bool_)
    for s in range(S):
        np_s = int(pairs_per[s])
        lo_pairs = np.arange(bounds[s], bounds[s + 1])
        for base, rows in ((0, lo_pairs), (half, lo_pairs + nE2)):
            id_c_l[s, base : base + np_s] = g.id_c[rows]
            id_a_l[s, base : base + np_s] = g.id_a[rows]
            edge_mask_l[s, base : base + np_s] = True
    out["id_c"], out["id_a"], out["edge_mask"] = id_c_l, id_a_l, edge_mask_l
    j = np.arange(E_loc)
    swap = np.where(j < half, j + half, j - half).astype(INT)
    real = edge_mask_l
    out["id_swap"] = np.where(real, swap[None, :], j[None, :]).astype(INT)
    out["id_undir"] = np.where(real, (j % half)[None, :], 0).astype(INT)

    # ---- triplet rows: two contiguous chunks of the globally sorted space ----
    trip_rows_per_shard = []
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        c1 = _chunked_rows(g.id3_reduce_ca, lo, hi)
        c2 = _chunked_rows(g.id3_reduce_ca, nE2 + lo, nE2 + hi)
        rows = np.concatenate([np.arange(c1.start, c1.stop),
                               np.arange(c2.start, c2.stop)])
        trip_rows_per_shard.append(rows)
        if len(rows):
            edge_ix.collect(s, g.id3_expand_ba[rows])
    h_e, esend_idx, esend_mask, ecounts = edge_ix.finalize(h_pad=pads.h_e)
    out["edge_halo_send_idx"] = esend_idx      # (S, S, h_e)
    out["edge_halo_send_mask"] = esend_mask

    T_loc = max(
        round_up(max((len(r) for r in trip_rows_per_shard), default=1), ROW_BLOCK),
        ROW_BLOCK,
        pads.t_loc,
    )
    trip_arrs = {
        "id3_reduce_ca": np.zeros((S, T_loc), INT),
        "id3_expand_ba": np.zeros((S, T_loc), INT),
        "trip_b_atom": np.zeros((S, T_loc), INT),
        "trip_mask": np.zeros((S, T_loc), np.bool_),
        "trip_row_splits": np.zeros((S, E_loc // EDGE_BLOCK + 1), INT),
    }
    for s in range(S):
        rows = trip_rows_per_shard[s]
        n = len(rows)
        red = edge_local[g.id3_reduce_ca[rows]]
        trip_arrs["id3_reduce_ca"][s, :n] = red
        trip_arrs["id3_reduce_ca"][s, n:] = E_loc - 1  # keeps sortedness
        trip_arrs["id3_expand_ba"][s, :n] = edge_ix.remap(
            s, g.id3_expand_ba[rows])
        trip_arrs["trip_b_atom"][s, :n] = g.id_c[g.id3_expand_ba[rows]]
        trip_arrs["trip_mask"][s, :n] = True
        assert np.all(np.diff(red) >= 0), "local triplet rows must stay sorted"
        trip_arrs["trip_row_splits"][s] = _row_splits(
            trip_arrs["id3_reduce_ca"][s], E_loc)
    out.update(trip_arrs)

    out["halo_meta"] = np.array(
        [E_loc, h_e, T_loc], INT
    )  # static sizes (host side; not shipped to device)

    if triplets_only:
        out["halo_pads"] = HaloPads(
            half=half, h_e=h_e, t_loc=T_loc, ie=0, i_ca=0, i_db=0, h_i=0,
            q_loc=0, n_mol=n_mol_pad, n_atoms=n_atoms_pad,
        )
        return out

    # ---- quadruplet hierarchy ----
    nIE = g.n_int_edges
    IE_pad = max(round_up(nIE, 64), 64, pads.ie)
    out["id4_int_a"] = pad1(g.id4_int_a, IE_pad)
    out["id4_int_b"] = pad1(g.id4_int_b, IE_pad)
    out["int_edge_mask"] = (np.arange(IE_pad) < nIE)

    # intm_ca rows live with their c->a edge (arbitrary subset, order kept)
    ca_owner = edge_owner[g.id4_reduce_intm_ca]
    ca_rows_per_shard = [np.nonzero(ca_owner == s)[0] for s in range(S)]
    I_ca = max(
        round_up(max((len(r) for r in ca_rows_per_shard), default=1), 64), 64,
        pads.i_ca)
    ca_local = np.zeros(g.n_intm, np.int64)
    for s in range(S):
        ca_local[ca_rows_per_shard[s]] = np.arange(len(ca_rows_per_shard[s]))

    # intm_db rows live with their d->b edge
    db_owner = edge_owner[g.id4_expand_intm_db]
    db_rows_per_shard = [np.nonzero(db_owner == s)[0] for s in range(S)]
    I_db = max(
        round_up(max((len(r) for r in db_rows_per_shard), default=1), 64), 64,
        pads.i_db)
    db_local = np.zeros(len(g.id4_expand_intm_db), np.int64)
    for s in range(S):
        db_local[db_rows_per_shard[s]] = np.arange(len(db_rows_per_shard[s]))
    intm_ix = _HaloIndexer(db_owner, db_local.astype(INT), I_db, n_shards)

    # quad rows live with their reduce edge ca: two contiguous chunks
    quad_rows_per_shard = []
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        c1 = _chunked_rows(g.id4_reduce_ca, lo, hi)
        c2 = _chunked_rows(g.id4_reduce_ca, nE2 + lo, nE2 + hi)
        rows = np.concatenate([np.arange(c1.start, c1.stop),
                               np.arange(c2.start, c2.stop)])
        quad_rows_per_shard.append(rows)
        if len(rows):
            intm_ix.collect(s, g.id4_expand_abd[rows])
    h_i, isend_idx, isend_mask, icounts = intm_ix.finalize(h_pad=pads.h_i)
    out["intm_halo_send_idx"] = isend_idx
    out["intm_halo_send_mask"] = isend_mask

    Q_loc = max(
        round_up(max((len(r) for r in quad_rows_per_shard), default=1),
                 ROW_BLOCK),
        ROW_BLOCK,
        pads.q_loc,
    )

    # per-shard intm_ca arrays (basis/geometry only; no activations)
    ca_arrs = {
        "id4_reduce_intm_ca": np.zeros((S, I_ca), INT),  # -> local edge slot
        "id4_reduce_intm_ab": np.zeros((S, I_ca), INT),  # -> int edge (global)
        "intm_ca_mask": np.zeros((S, I_ca), np.bool_),
    }
    for s in range(S):
        rows = ca_rows_per_shard[s]
        n = len(rows)
        ca_arrs["id4_reduce_intm_ca"][s, :n] = edge_local[g.id4_reduce_intm_ca[rows]]
        ca_arrs["id4_reduce_intm_ab"][s, :n] = g.id4_reduce_intm_ab[rows]
        ca_arrs["intm_ca_mask"][s, :n] = True
    out.update(ca_arrs)

    # per-shard intm_db arrays; activation gather edge->intm is LOCAL by
    # construction; halo slots (for the intm->quad exchange) also get atom
    # indices so their geometry is locally computable — EXT length I_db + S*h_i
    I_ext = I_db + S * h_i
    db_arrs = {
        "id4_expand_intm_db": np.zeros((S, I_db), INT),  # -> local edge slot
        "id4_expand_intm_ab": np.zeros((S, I_db), INT),  # -> int edge (global)
        "intm_db_mask": np.zeros((S, I_db), np.bool_),
        # atoms of (a - b <- d) for EXT rows: dihedral projection everywhere
        "intm_ext_a_atom": np.zeros((S, I_ext), INT),
        "intm_ext_b_atom": np.zeros((S, I_ext), INT),
        "intm_ext_d_atom": np.zeros((S, I_ext), INT),
    }
    g_a_atom = g.id4_int_a[g.id4_expand_intm_ab]
    g_b_atom = g.id4_int_b[g.id4_expand_intm_ab]
    g_d_atom = g.id_c[g.id4_expand_intm_db]
    for s in range(S):
        rows = db_rows_per_shard[s]
        n = len(rows)
        db_arrs["id4_expand_intm_db"][s, :n] = edge_local[g.id4_expand_intm_db[rows]]
        db_arrs["id4_expand_intm_ab"][s, :n] = g.id4_expand_intm_ab[rows]
        db_arrs["intm_db_mask"][s, :n] = True
        db_arrs["intm_ext_a_atom"][s, :n] = g_a_atom[rows]
        db_arrs["intm_ext_b_atom"][s, :n] = g_b_atom[rows]
        db_arrs["intm_ext_d_atom"][s, :n] = g_d_atom[rows]
        for o in range(S):
            req = intm_ix.requests[s][o]
            if req is None or len(req) == 0:
                continue
            base = I_db + o * h_i
            db_arrs["intm_ext_a_atom"][s, base : base + len(req)] = g_a_atom[req]
            db_arrs["intm_ext_b_atom"][s, base : base + len(req)] = g_b_atom[req]
            db_arrs["intm_ext_d_atom"][s, base : base + len(req)] = g_d_atom[req]
    out.update(db_arrs)

    # per-shard quadruplet arrays
    quad_arrs = {
        "id4_reduce_ca": np.zeros((S, Q_loc), INT),   # -> local edge slot
        "id4_reduce_cab": np.zeros((S, Q_loc), INT),  # -> local intm_ca slot
        "id4_expand_abd": np.zeros((S, Q_loc), INT),  # -> ext intm_db slot
        "quad_mask": np.zeros((S, Q_loc), np.bool_),
        "quad_row_splits": np.zeros((S, E_loc // EDGE_BLOCK + 1), INT),
    }
    for s in range(S):
        rows = quad_rows_per_shard[s]
        n = len(rows)
        red = edge_local[g.id4_reduce_ca[rows]]
        quad_arrs["id4_reduce_ca"][s, :n] = red
        quad_arrs["id4_reduce_ca"][s, n:] = E_loc - 1
        quad_arrs["id4_reduce_cab"][s, :n] = ca_local[g.id4_reduce_cab[rows]]
        quad_arrs["id4_expand_abd"][s, :n] = intm_ix.remap(
            s, g.id4_expand_abd[rows])
        quad_arrs["quad_mask"][s, :n] = True
        assert np.all(np.diff(red) >= 0), "local quad rows must stay sorted"
        quad_arrs["quad_row_splits"][s] = _row_splits(
            quad_arrs["id4_reduce_ca"][s], E_loc)
    out.update(quad_arrs)

    out["halo_meta"] = np.array([E_loc, h_e, T_loc, I_ca, I_db, h_i, Q_loc], INT)
    out["halo_pads"] = HaloPads(
        half=half, h_e=h_e, t_loc=T_loc, ie=IE_pad, i_ca=I_ca, i_db=I_db,
        h_i=h_i, q_loc=Q_loc, n_mol=n_mol_pad, n_atoms=n_atoms_pad,
    )
    return out


def estimate_halo_pads(
    raw_batches,
    n_shards: int,
    triplets_only: bool = False,
    headroom: float = 1.25,
    n_mol: int | None = None,
) -> HaloPads:
    """Size static HaloPads from sample batches (the halo analog of
    data/padding.estimate_pad_dims). `raw_batches` yields (g, Z, R, ...)
    tuples (extra elements ignored)."""
    pads = None
    for tup in raw_batches:
        g, Z, R = tup[0], tup[1], tup[2]
        p = build_halo_partition(
            g, Z, R, n_shards, triplets_only=triplets_only
        )["halo_pads"]
        pads = p if pads is None else pads.grow_to(p)
    assert pads is not None, "estimate_halo_pads needs at least one batch"
    pads = pads.grow_to(pads, headroom=headroom)
    if n_mol is not None:
        pads = dataclasses.replace(pads, n_mol=max(pads.n_mol, n_mol))
    return pads


def agree_halo_pads(pads: HaloPads, group) -> HaloPads:
    """The field-wise max of every rank's `pads` (one small all-reduce).

    JAX partitions each batch once, on its one controller. Here every rank
    partitions the same batch itself, in its own prefetch threads, so a
    rank whose threads met an outlier batch first holds grown pads while
    its peers do not; shards of one batch at two HaloPads exchange blocks
    of two shapes, which hangs or corrupts the all-to-all. Agreeing on
    the pads before each step removes the dependence on thread timing."""
    return mesh.agree_max(pads, group)


# ======================================================================
# exchange and the rank's shard
# ======================================================================

# batch keys with a leading (n_shards,) axis
SHARDED_KEYS = (
    "id_c", "id_a", "edge_mask", "id_swap", "id_undir",
    "id3_reduce_ca", "id3_expand_ba", "trip_b_atom", "trip_mask",
    "trip_row_splits", "edge_halo_send_idx", "edge_halo_send_mask",
    "id4_reduce_intm_ca", "id4_reduce_intm_ab", "intm_ca_mask",
    "id4_expand_intm_db", "id4_expand_intm_ab", "intm_db_mask",
    "intm_ext_a_atom", "intm_ext_b_atom", "intm_ext_d_atom",
    "intm_halo_send_idx", "intm_halo_send_mask",
    "id4_reduce_ca", "id4_reduce_cab", "id4_expand_abd", "quad_mask",
    "quad_row_splits",
)
HOST_ONLY_KEYS = ("halo_meta", "halo_pads")
# the reduce id columns a shard's segment plans are built from
_REDUCE_KEYS = ("id3_reduce_ca", "id4_reduce_ca")


def halo_exchange(x, send_idx, send_mask, group):
    """One all-to-all: the (n_peers*h, F) halo rows this shard requested,
    in request order; padded request slots are zero.

    x: (n_local_pad, F) local rows; send_idx/send_mask: (n_peers, h).
    recv[o] = rows THIS shard requested from peer o (peer o sends
    x_o[send_idx_o[self]], which the host arranged to be exactly this
    shard's request list to o). The send rows' gather transposes to a
    scatter-add, the all-to-all to the reverse all-to-all."""
    buf = x[send_idx] * send_mask[..., None].to(x.dtype)  # (P, h, F)
    return all_to_all(buf, group).reshape(-1, x.shape[-1])


def halo_extend(x, send_idx, send_mask, group):
    """[local rows ; halo rows]: the gather source for remapped expand ids."""
    return torch.cat([x, halo_exchange(x, send_idx, send_mask, group)])


def device_batch_halo(batch: dict) -> dict:
    """The partition without its host-only keys."""
    return {k: v for k, v in batch.items() if k not in HOST_ONLY_KEYS}


def local_halo_batch(batch: dict, shard: int) -> dict:
    """Shard `shard`'s numpy batch: its row of every SHARDED_KEYS array and
    the replicated arrays, without the host-only keys. Its reduce ids must
    be ascending (rows live with their reduce edge, each shard's rows are
    two contiguous chunks of the globally sorted space): the segment plans
    are built from them."""
    out = {k: (v[shard] if k in SHARDED_KEYS else v)
           for k, v in device_batch_halo(batch).items()}
    for key in _REDUCE_KEYS:
        if key in out and np.any(np.diff(out[key]) < 0):
            raise ValueError(f"shard {shard}'s {key} is not ascending")
    return out


def shard_halo_batch(batch: dict, group, device="cuda") -> dict:
    """This rank's shard of a halo partition as tensors on `device`, with the
    segment plans of its own reduce ids (`data.to_torch`). Every process
    holds the same full partition (the partitioner is deterministic) and
    takes its own shard, as the JAX package's multi-process contract does."""
    return to_torch(local_halo_batch(batch, mesh.rank(group)), device)


# ======================================================================
# the halo model and its steps
# ======================================================================


def halo_model(model, group):
    """`model` (a GemNet) run in halo mode over `group`: a view that shares
    every parameter, buffer and submodule with `model` (the trainer's flat
    buffer and EMA rebinding reach it), with ep_axis="ep", ep_halo=True and
    the group (JAX: `make_model(replace(cfg, ep_axis=EP_AXIS, ep_halo=True))`
    with the same variables)."""
    if model.cfg.ep_halo:
        raise ValueError("the model is already a halo model")
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, ep_axis=EP_AXIS, ep_halo=True)
    view.group = group
    return view


def make_halo_apply(model, group):
    """(halo shard batch) -> (E, F), replicated on every rank and equal to
    the single-device model's (F = -dE/dR, or the direct head psum'd)."""
    from ..models.gemnet import energy_and_forces

    hm = halo_model(model, group)
    return lambda batch: energy_and_forces(hm, batch)


def make_halo_loss_and_grad(model, group, loss_fn):
    """(halo shard batch) -> (loss, grads): `loss_fn(E, F, batch)` over the
    replicated outputs, and its gradient per parameter (`model.parameters()`
    order), exact and equal on every rank, from the training step's own
    gradient (`training.trainer.flat_gradient`: the loss seeded with 1/P,
    the flat gradient all-reduced once)."""
    from ..models.gemnet import energy_and_forces
    from ..training.trainer import flat_gradient

    hm = halo_model(model, group)

    def loss_and_grad(batch):
        params = list(model.parameters())
        E, F = energy_and_forces(hm, batch, create_graph=True)
        loss = loss_fn(E, F, batch)
        flat = flat_gradient(loss, params, group, replicated=group)
        return loss.detach(), [v.view_as(p) for v, p in
                               zip(flat.split([p.numel() for p in params]), params)]

    return loss_and_grad


def make_halo_eval_step(trainer, group):
    """(state, batch, use_ema=False) -> (metrics, counts) of the halo model
    on this rank's shard, the same on every rank (JAX's eval over the halo
    mesh, used for the EMA validation of --halo). `batch` is what the
    trainer's `eval_step_fn()` takes (the shard's host batch, its packed
    row, or its tensors on a CPU or gloo trainer); on an NCCL group it is
    captured.

    The metrics come from the replicated E and F, which every rank computes
    alike but for the order of float atomics (`index_add` on the card sums
    a replicated E_a into E_mol in any order), so the ranks' metrics may
    differ in their last bits. They drive the run's decisions (best model,
    plateau, early stopping), which the ranks must take alike, so rank 0's
    are broadcast to all."""
    step = trainer.eval_step_fn(model=halo_model(trainer.model, group))

    def eval_step(state, batch, use_ema=False):
        metrics, counts = step(state, batch, use_ema)
        return broadcast_metrics(metrics, group), counts

    return eval_step


def broadcast_metrics(metrics: dict, group) -> dict:
    """Rank 0's metrics (of `group`) on every rank of it, in one broadcast:
    the metrics that drive the run's decisions, which the ranks must take
    alike (`make_halo_eval_step`)."""
    keys = sorted(metrics)
    values = broadcast_(torch.stack([metrics[k].float() for k in keys]), group)
    return dict(zip(keys, values.unbind()))


def make_halo_train_step(trainer, group):
    """(state, batch, lr_scale) -> (state, metrics): one training step of the
    halo model on this rank's shard, with exact gradients (see the module
    docstring), then the trainer's optimizer, EMA and metric accumulation,
    the same on every rank. On an NCCL group it is a captured step (the
    collectives inside the CUDA graph) that replays for every batch of one
    HaloPads; on a gloo group or the CPU the eager step."""
    step = trainer.train_step_fn(model=halo_model(trainer.model, group))

    def halo_step(state, batch, lr_scale):
        state, metrics, _ = step(state, batch, lr_scale)
        return state, metrics

    return halo_step
