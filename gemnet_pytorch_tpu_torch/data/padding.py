"""Static-shape padding of batched graphs (this package's copy of
`gemnet_pytorch_tpu/data/padding.py`; `pad_batch` output is equal to the JAX
package's array for array).

Padding convention (load-bearing, used throughout the model):

- All index arrays stay in bounds (padded entries point at row 0 of their
  target space). Correctness comes from masks: every scatter is a segment
  sum whose source rows are pre-multiplied by the source mask.
- Real edges stay contiguous at [0, nE); padding sits at [nE, P). Padded
  triplet/quad rows carry reduce id min(nE, P-1), so the reduce columns stay
  sorted, which the CUDA segment kernels require.
- Periodic batches carry ``edge_offset`` (int8, (P, 3), padded rows 0),
  ``cell`` (float32, (n_mol, 3, 3), padded systems zero) and, where the
  container has tags, ``free_mask`` (padded atoms False).
- The ``*_perm``/``*_sorted`` sort metadata (`data.batch.SORT_META_KEYS`,
  derived from its table `SORTED_GATHERS`) is a single-device layout
  contract: any re-slicing of a row space invalidates it and must strip it
  (`data.batch.strip_sort_metadata`). So is the edges' (EDGE_SORT_KEYS),
  which `data.batch` derives from a padded batch, not `pad_batch`.

Left out of the copy: the TPU-only Pallas segment-block choice
(``seg_block3``/``seg_block4`` and their shape carriers).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from ..perf import spans
from .graph import GraphArrays, INT

EDGE_BLOCK = 32   # segment ids per `*_row_splits` entry (batch layout contract)
ROW_BLOCK = 512   # rounding unit of the padded triplet/quad row spaces


def round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


@dataclass(frozen=True)
class PadDims:
    """Static sizes of a padded batch."""

    n_mol: int
    n_atoms: int
    n_edges: int  # must be even
    n_triplets: int
    kmax3: int
    n_int_edges: int = 0
    n_intm: int = 0
    n_quads: int = 0
    kmax4: int = 0

    def __post_init__(self):
        assert self.n_edges % 2 == 0, "padded edge count must be even"

    def fits(self, g: GraphArrays, n_mol: int, n_atoms: int) -> bool:
        return (
            n_mol <= self.n_mol
            and n_atoms <= self.n_atoms
            and g.n_edges <= self.n_edges
            and g.n_triplets <= self.n_triplets
            and g.kmax3 <= self.kmax3
            and g.n_int_edges <= self.n_int_edges
            and g.n_intm <= self.n_intm
            and g.n_quads <= self.n_quads
            and g.kmax4 <= self.kmax4
        )

    def grow_to(self, g: GraphArrays, n_mol: int, n_atoms: int) -> "PadDims":
        """Smallest PadDims (with mild rounding) covering both self and g."""
        return PadDims(
            n_mol=max(self.n_mol, n_mol),
            n_atoms=max(self.n_atoms, round_up(n_atoms, 16)),
            n_edges=max(self.n_edges, 2 * round_up(g.n_edges // 2 + g.n_edges % 2, 64)),
            n_triplets=max(self.n_triplets, round_up(g.n_triplets, ROW_BLOCK)),
            kmax3=max(self.kmax3, round_up(g.kmax3, 4)),
            n_int_edges=max(self.n_int_edges, round_up(g.n_int_edges, 64))
            if g.n_int_edges
            else self.n_int_edges,
            n_intm=max(self.n_intm, round_up(g.n_intm, ROW_BLOCK)) if g.n_intm else self.n_intm,
            n_quads=max(self.n_quads, round_up(g.n_quads, ROW_BLOCK))
            if g.n_quads
            else self.n_quads,
            kmax4=max(self.kmax4, round_up(g.kmax4, 4)) if g.kmax4 else self.kmax4,
        )


def _row_splits(sorted_ids: np.ndarray, n_segments: int) -> np.ndarray:
    """First row index for every EDGE_BLOCK of segment ids."""
    bounds = np.arange(0, n_segments + EDGE_BLOCK, EDGE_BLOCK)
    return np.searchsorted(sorted_ids, bounds, side="left").astype(INT)


def _pad1(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full((n,) + a.shape[1:], fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


# int16 downcast only below this array length (the JAX package's transfer
# layout; kept so both packages see the same batch)
_SHRINK_MAX_LEN = 32768


def _shrink_ids(out: dict[str, np.ndarray], dims: PadDims) -> dict[str, np.ndarray]:
    """Downcast index arrays to int16 where the static target space allows."""
    families = {
        ("Z", "batch_seg", "id_c", "id_a", "id4_int_a", "id4_int_b"): dims.n_atoms,
        ("id_undir", "id_swap", "id3_reduce_ca", "id3_expand_ba",
         "id4_reduce_ca", "id4_expand_db", "id4_reduce_intm_ca",
         "id4_expand_intm_db"): dims.n_edges,
        ("id4_reduce_cab", "id4_expand_abd", "id4_reduce_intm_ab",
         "id4_expand_intm_ab"): max(dims.n_intm, dims.n_int_edges),
        ("Kidx3", "Kidx4"): max(dims.kmax3, dims.kmax4),
    }
    for keys, bound in families.items():
        if bound < 32767:
            for k in keys:
                if k in out and out[k].size <= _SHRINK_MAX_LEN:
                    out[k] = out[k].astype(np.int16)
    return out


def pad_batch(
    g: GraphArrays,
    Z: np.ndarray,
    R: np.ndarray,
    dims: PadDims,
    E: Optional[np.ndarray] = None,
    F: Optional[np.ndarray] = None,
    triplets_only: bool = False,
) -> dict[str, np.ndarray]:
    """Pad one canonical batch to static shapes: a dict of numpy arrays
    (model inputs, optional targets, masks, sort metadata). Counts the
    triplet and quadruplet rows before and after padding."""
    with spans.span("pad"):
        out = _pad_batch(g, Z, R, dims, E, F, triplets_only)
    spans.count("pad.real_rows", g.n_triplets + g.n_quads)
    spans.count("pad.padded_rows", dims.n_triplets + (0 if triplets_only else dims.n_quads))
    return out


def _pad_batch(g, Z, R, dims, E, F, triplets_only) -> dict[str, np.ndarray]:
    n_mol = int(g.batch_seg.max()) + 1 if len(g.batch_seg) else 0
    n_atoms = len(Z)
    assert dims.fits(g, n_mol, n_atoms), (
        f"batch exceeds pad dims: {g.n_edges} edges/{g.n_triplets} trip/"
        f"{g.n_quads} quad vs {dims}"
    )

    P = dims.n_edges
    nE = g.n_edges
    nE2 = nE // 2
    trip_pad_id = min(nE, P - 1)  # keeps sorted reduce ids sorted after padding

    out: dict[str, np.ndarray] = {}
    out["Z"] = _pad1(Z.astype(INT), dims.n_atoms, fill=1)  # padded atoms: H (masked)
    out["R"] = _pad1(R.astype(np.float32), dims.n_atoms)
    out["batch_seg"] = _pad1(g.batch_seg, dims.n_atoms)
    out["atom_mask"] = (np.arange(dims.n_atoms) < n_atoms).astype(np.bool_)
    out["mol_mask"] = (np.arange(dims.n_mol) < n_mol).astype(np.bool_)
    out["n_mol"] = np.array(n_mol, dtype=INT)

    j = np.arange(P, dtype=INT)
    out["id_c"] = _pad1(g.id_c, P)
    out["id_a"] = _pad1(g.id_a, P)
    out["id_undir"] = np.where(j < nE, j % max(nE2, 1), 0).astype(INT)
    swap = np.where(j < nE2, j + nE2, j - nE2)
    out["id_swap"] = np.where(j < nE, swap, j).astype(INT)
    out["edge_mask"] = j < nE

    out["id3_reduce_ca"] = _pad1(g.id3_reduce_ca, dims.n_triplets, fill=trip_pad_id)
    out["id3_expand_ba"] = _pad1(g.id3_expand_ba, dims.n_triplets)
    out["Kidx3"] = _pad1(g.Kidx3, dims.n_triplets)
    out["trip_mask"] = (np.arange(dims.n_triplets) < g.n_triplets).astype(np.bool_)
    out["trip_row_splits"] = _row_splits(out["id3_reduce_ca"], P)
    # sort metadata of the expand gather x_ba[id3_expand_ba], over the PADDED
    # column (padded rows point at edge 0 and carry zero cotangents)
    perm = np.argsort(out["id3_expand_ba"], kind="stable").astype(np.int32)
    out["trip_ba_perm"] = perm
    out["trip_ba_sorted"] = out["id3_expand_ba"][perm].astype(np.int32)
    out["kmax3_static"] = np.zeros(dims.kmax3, np.bool_)

    if g.edge_offset is not None:
        # periodic systems: padded edges take offset 0, padded systems a cell of zeros
        out["edge_offset"] = _pad1(g.edge_offset.astype(np.int8), P)
        out["cell"] = _pad1(g.cell.astype(np.float32), dims.n_mol)
    if g.free is not None:
        out["free_mask"] = _pad1(g.free.astype(np.bool_), dims.n_atoms)

    if E is not None:
        out["E"] = _pad1(E.reshape(n_mol, -1).astype(np.float32), dims.n_mol)
    if F is not None:
        out["F"] = _pad1(F.astype(np.float32), dims.n_atoms)

    if triplets_only:
        return _shrink_ids(out, dims)

    out["id4_int_a"] = _pad1(g.id4_int_a, dims.n_int_edges)
    out["id4_int_b"] = _pad1(g.id4_int_b, dims.n_int_edges)
    out["int_edge_mask"] = (np.arange(dims.n_int_edges) < g.n_int_edges).astype(
        np.bool_
    )
    out["id4_reduce_intm_ca"] = _pad1(g.id4_reduce_intm_ca, dims.n_intm)
    out["id4_expand_intm_db"] = _pad1(g.id4_expand_intm_db, dims.n_intm)
    out["id4_reduce_intm_ab"] = _pad1(g.id4_reduce_intm_ab, dims.n_intm)
    out["id4_expand_intm_ab"] = _pad1(g.id4_expand_intm_ab, dims.n_intm)
    out["intm_ca_mask"] = (np.arange(dims.n_intm) < len(g.id4_reduce_intm_ca)).astype(
        np.bool_
    )
    out["intm_db_mask"] = (np.arange(dims.n_intm) < len(g.id4_expand_intm_db)).astype(
        np.bool_
    )
    out["id4_reduce_ca"] = _pad1(g.id4_reduce_ca, dims.n_quads, fill=trip_pad_id)
    out["id4_expand_db"] = _pad1(g.id4_expand_db, dims.n_quads)
    out["id4_reduce_cab"] = _pad1(g.id4_reduce_cab, dims.n_quads)
    out["id4_expand_abd"] = _pad1(g.id4_expand_abd, dims.n_quads)
    out["Kidx4"] = _pad1(g.Kidx4, dims.n_quads)
    out["quad_mask"] = (np.arange(dims.n_quads) < g.n_quads).astype(np.bool_)
    out["quad_row_splits"] = _row_splits(out["id4_reduce_ca"], P)
    for src, tag in (("id4_expand_abd", "abd"), ("id4_reduce_cab", "cab")):
        perm = np.argsort(out[src], kind="stable").astype(np.int32)
        out[f"quad_{tag}_perm"] = perm
        out[f"quad_{tag}_sorted"] = out[src][perm].astype(np.int32)
    perm = np.argsort(out["id4_expand_intm_db"], kind="stable").astype(np.int32)
    out["intm_db_perm"] = perm
    out["intm_db_sorted"] = out["id4_expand_intm_db"][perm].astype(np.int32)
    out["kmax4_static"] = np.zeros(dims.kmax4, np.bool_)
    return _shrink_ids(out, dims)


def estimate_pad_dims(
    graphs: list[GraphArrays],
    n_mol: int,
    n_atoms_list: list[int],
    triplets_only: bool = False,
    headroom: float = 1.1,
) -> PadDims:
    """Derive PadDims covering a sample of batches with headroom."""
    dims = PadDims(
        n_mol=n_mol,
        n_atoms=16,
        n_edges=128,
        n_triplets=256,
        kmax3=4,
        n_int_edges=0 if triplets_only else 64,
        n_intm=0 if triplets_only else 256,
        n_quads=0 if triplets_only else 512,
        kmax4=0 if triplets_only else 4,
    )
    for g, na in zip(graphs, n_atoms_list):
        scaled = replace(
            dims,
            n_atoms=max(dims.n_atoms, round_up(int(na * headroom), 16)),
        )
        dims = scaled.grow_to(scale_graph_dims(g, headroom), n_mol, int(na * headroom))
    return dims


class _DimView:
    """Stand-in exposing scaled counts for grow_to."""

    def __init__(self, g: GraphArrays, s: float):
        self.n_edges = int(np.ceil(g.n_edges * s / 2) * 2)
        self.n_triplets = int(g.n_triplets * s)
        self.n_quads = int(g.n_quads * s)
        self.n_int_edges = int(g.n_int_edges * s)
        self.n_intm = int(g.n_intm * s)
        self.kmax3 = int(np.ceil(g.kmax3 * s))
        self.kmax4 = int(np.ceil(g.kmax4 * s))


def scale_graph_dims(g: GraphArrays, s: float) -> _DimView:
    """A graph's counts scaled by `s` (headroom), as `grow_to` takes them."""
    return _DimView(g, s)
