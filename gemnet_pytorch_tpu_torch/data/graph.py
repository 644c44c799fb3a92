"""Batched molecular-graph index construction (host side).

This package's copy of `gemnet_pytorch_tpu/data/graph.py`: the atom -> edge
-> triplet -> quadruplet index hierarchy with the reference's canonical
undirected edge order, triplets sorted by their reduce edge, and the
two-level "intermediate triplet" quadruplet construction
(reference gemnet/training/data_container.py:156-489). `build_graph` runs
the native C++ builder (`native.py`); `build_graph_numpy` is the numpy/scipy
builder it is held against, with the same arrays. The output arrays are
unpadded; `padding.py` turns them into static-shape masked batches.

Index vocabulary (the interchange schema, identical to the reference):

- ``id_c``/``id_a``: source/target atom of each directed edge c->a.
- ``id_undir``: undirected-pair id; ``id_swap``: position of the reverse edge.
- ``id3_reduce_ca``/``id3_expand_ba``: the two edges of each triplet
  b->a<-c, sorted by ``id3_reduce_ca``; ``Kidx3`` the rank within a group.
- ``id4_*``: the quadruplet hierarchy c->a-b<-d over the interaction edges
  a-b and the two intermediate triplet spaces, sorted by ``id4_reduce_ca``.

Periodic systems (a ``cell`` per system, OCP's GemNetT graph; triplets
only): an edge s -> t runs from the image of s at R[s] + o.cell, ``o`` its
integer cell offset (``edge_offset``); the search covers the image shells
that each cell vector's height asks for, so a cell narrower than the cutoff
gives edges to images two and more cells away, and an atom's edges to its
own images. ``max_neighbors`` keeps each target's nearest, ties broken by
(distance, source index, offset). The shells are searched around the
atoms' positions wrapped into the cell, so an atom outside it finds every
image as well; the offsets are from the atoms' own positions, so moving an
atom by a lattice vector changes its edges' offsets and nothing else.
Then OCP's symmetric selection (``GemNetT.reorder_symmetric_edges``): an
edge is kept where s < t, or s == t and o is lexicographically negative,
and the reverse (t -> s, -o) of every kept edge follows, so ``id_swap``
keeps its meaning. Triplets pair
two distinct edges sharing a target: b == c through two images is one.
The span ``graph.neighbours`` covers the search, the cap and the
selection; the counters ``graph.cap_candidates``, ``graph.cap_dropped``
and ``graph.image_edges`` count the edges within the cutoff, those the cap
removed and the kept edges with a non-zero offset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..perf import spans

INT = np.int32


def repeat_blocks(sizes: np.ndarray, repeats: np.ndarray) -> np.ndarray:
    """Tile consecutive index blocks: block i is ``arange(start_i, start_i+sizes[i])``
    repeated ``repeats[i]`` times (reference data_container.py:520-546).

    >>> repeat_blocks(np.array([1,3,2]), np.array([3,2,3]))
    array([0, 0, 0, 1, 2, 3, 1, 2, 3, 4, 5, 4, 5, 4, 5], dtype=int32)
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    repeats = np.asarray(repeats, dtype=np.int64)
    counts = sizes * repeats
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=INT)
    block_starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    out_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    block_of = np.repeat(np.arange(len(sizes)), counts)
    within = np.arange(total) - out_starts[block_of]
    local = within % np.maximum(sizes[block_of], 1)
    return (block_starts[block_of] + local).astype(INT)


def ragged_range(sizes: np.ndarray) -> np.ndarray:
    """Concatenation of ``arange(size)`` for each size
    (reference data_container.py:548-565).

    >>> ragged_range(np.array([1,3,2]))
    array([0, 0, 1, 2, 0, 1], dtype=int32)
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=INT)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    block_of = np.repeat(np.arange(len(sizes)), sizes)
    return (np.arange(total) - starts[block_of]).astype(INT)


@dataclass
class GraphArrays:
    """Canonical (unpadded) batched-graph index arrays."""

    batch_seg: np.ndarray
    id_c: np.ndarray
    id_a: np.ndarray
    id_undir: np.ndarray
    id_swap: np.ndarray
    id3_expand_ba: np.ndarray
    id3_reduce_ca: np.ndarray
    Kidx3: np.ndarray
    id4_int_b: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_int_a: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_reduce_ca: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_expand_db: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_reduce_cab: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_expand_abd: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    Kidx4: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_reduce_intm_ca: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_expand_intm_db: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_reduce_intm_ab: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    id4_expand_intm_ab: np.ndarray = field(default_factory=lambda: np.zeros(0, INT))
    # periodic systems: each edge's source image offset (int8, (nEdges, 3)),
    # each system's cell (float32, (nMol, 3, 3), rows the cell vectors)
    edge_offset: Optional[np.ndarray] = None
    cell: Optional[np.ndarray] = None
    # each atom's free flag (OC20's tags > 0), set by the container
    free: Optional[np.ndarray] = None

    @property
    def n_edges(self) -> int:
        return len(self.id_c)

    @property
    def n_triplets(self) -> int:
        return len(self.id3_reduce_ca)

    @property
    def n_quads(self) -> int:
        return len(self.id4_reduce_ca)

    @property
    def n_int_edges(self) -> int:
        return len(self.id4_int_a)

    @property
    def n_intm(self) -> int:
        return len(self.id4_reduce_intm_ca)

    @property
    def kmax3(self) -> int:
        return int(self.Kidx3.max()) + 1 if len(self.Kidx3) else 0

    @property
    def kmax4(self) -> int:
        return int(self.Kidx4.max()) + 1 if len(self.Kidx4) else 0


def _batched_adjacency(R: np.ndarray, N: np.ndarray, cutoff: float):
    """Directed edge list (target, source) of the block-diagonal batch graph,
    target-major per molecule (reference data_container.py:244-274)."""
    t_all, s_all = [], []
    offset = 0
    for n in N:
        n = int(n)
        Rm = R[offset : offset + n]
        D = np.linalg.norm(Rm[:, None, :] - Rm[None, :, :], axis=-1)
        adj = (D <= cutoff) & ~np.eye(n, dtype=bool)
        t, s = np.nonzero(adj)
        t_all.append(t + offset)
        s_all.append(s + offset)
        offset += n
    return (
        np.concatenate(t_all).astype(np.int64),
        np.concatenate(s_all).astype(np.int64),
    )


def _check_sizes(R, N) -> np.ndarray:
    N = np.asarray(N, dtype=np.int64)
    if np.shape(R) != (int(N.sum()), 3):
        raise ValueError(f"R has shape {np.shape(R)}, N holds {int(N.sum())} atoms")
    return N


def build_graph(
    R: np.ndarray,
    N: np.ndarray,
    cutoff: float,
    int_cutoff: float | None = None,
    triplets_only: bool = False,
    cell: np.ndarray | None = None,
    max_neighbors: int | None = None,
) -> GraphArrays:
    """Build the full index hierarchy for a batch of molecules with the
    native C++ builder (`native.py`, built at first use; a failed build
    raises, nothing falls back to numpy).

    R: (nAtoms, 3) concatenated positions; N: (nMolecules,) atoms per
    molecule; cutoff: edge cutoff; int_cutoff: quadruplet interaction cutoff;
    cell: (nMolecules, 3, 3) periodic cells (module docstring), with
    max_neighbors the cap of edges a target atom (a cap needs a cell).
    """
    N = _check_sizes(R, N)
    with spans.span("graph.build"):
        if cell is None and max_neighbors is None:
            return _build_graph_native(R, N, cutoff, int_cutoff, triplets_only)
        return _build_periodic(R, N, _check_cell(cell, N), cutoff, max_neighbors,
                               triplets_only)


def build_graph_numpy(
    R: np.ndarray,
    N: np.ndarray,
    cutoff: float,
    int_cutoff: float | None = None,
    triplets_only: bool = False,
) -> GraphArrays:
    """`build_graph`'s arrays from numpy and scipy for molecules: the
    reference the native builder is held against, array for array (the
    periodic graph's is the benchmark's `reference/graph_pbc.py`)."""
    N = _check_sizes(R, N)
    n_atoms = int(N.sum())
    batch_seg = np.repeat(np.arange(len(N), dtype=INT), N)

    idx_t, idx_s = _batched_adjacency(R, N, cutoff)
    if len(idx_t) == 0:
        e = np.zeros(0, INT)
        return GraphArrays(batch_seg, e, e, e, e, e, e, e)

    # canonical undirected ordering (reference data_container.py:287-308)
    mask = idx_t < idx_s
    lower_t, lower_s = idx_t[mask], idx_s[mask]
    n_undir = len(lower_t)
    id_a = np.concatenate([lower_t, lower_s]).astype(INT)
    id_c = np.concatenate([lower_s, lower_t]).astype(INT)
    ind = np.arange(n_undir, dtype=INT)
    id_undir = np.concatenate([ind, ind])
    id_swap = np.concatenate([ind + n_undir, ind])

    n_edges = 2 * n_undir
    idx_t, idx_s = id_a.astype(np.int64), id_c.astype(np.int64)
    edge_ids = sp.csr_matrix(
        (np.arange(n_edges, dtype=np.int64), (idx_t, idx_s)),
        shape=(n_atoms, n_atoms),
    )
    adj = sp.csr_matrix(
        (np.ones(n_edges, dtype=np.int64), (idx_t, idx_s)), shape=(n_atoms, n_atoms)
    )

    # triplets b->a<-c (reference data_container.py:317-338,410-425)
    rows = edge_ids[idx_s]
    id3_expand_ba = rows.data.astype(INT)
    id3_reduce_ca = rows.tocoo().row.astype(INT)
    keep = idx_t[id3_reduce_ca] != idx_s[id3_expand_ba]
    id3_expand_ba = id3_expand_ba[keep]
    id3_reduce_ca = id_swap[id3_reduce_ca[keep]]
    if len(id3_reduce_ca) > 0:
        order = np.argsort(id3_reduce_ca, kind="stable")
        id3_reduce_ca = id3_reduce_ca[order]
        id3_expand_ba = id3_expand_ba[order]
        _, K = np.unique(id3_reduce_ca, return_counts=True)
        Kidx3 = ragged_range(K)
    else:
        Kidx3 = np.zeros(0, INT)

    g = GraphArrays(
        batch_seg=batch_seg, id_c=id_c, id_a=id_a, id_undir=id_undir,
        id_swap=id_swap, id3_expand_ba=id3_expand_ba,
        id3_reduce_ca=id3_reduce_ca, Kidx3=Kidx3,
    )
    if triplets_only:
        return g

    # quadruplets c->a-b<-d (reference data_container.py:351-489)
    assert int_cutoff is not None
    int_t, int_s = _batched_adjacency(R, N, int_cutoff)
    id4_int_a = int_t.astype(INT)
    id4_int_b = int_s.astype(INT)
    nb_t = np.asarray(adj[int_t].sum(axis=1)).ravel().astype(np.int64)
    nb_s = np.asarray(adj[int_s].sum(axis=1)).ravel().astype(np.int64)
    id4_reduce_intm_ca = edge_ids[int_t].data.astype(INT)
    id4_expand_intm_db = edge_ids[int_s].data.astype(INT)
    id4_reduce_intm_ab = np.repeat(np.arange(len(int_t)), nb_t).astype(INT)
    id4_expand_intm_ab = np.repeat(np.arange(len(int_t)), nb_s).astype(INT)

    id4_reduce_cab = repeat_blocks(nb_t, nb_s)
    id4_reduce_ca = id4_reduce_intm_ca[id4_reduce_cab]
    rep = np.repeat(nb_t, nb_s)
    id4_expand_abd = np.repeat(np.arange(len(id4_expand_intm_db)), rep).astype(INT)
    id4_expand_db = id4_expand_intm_db[id4_expand_abd]

    # drop quadruplets with repeated atoms (c!=b, a!=d, c!=d)
    idx_c = idx_s[id4_reduce_ca]
    idx_a = idx_t[id4_reduce_ca]
    idx_b = idx_t[id4_expand_db]
    idx_d = idx_s[id4_expand_db]
    keep4 = (idx_c != idx_b) & (idx_a != idx_d) & (idx_c != idx_d)
    id4_reduce_ca = id4_reduce_ca[keep4]
    id4_expand_db = id4_expand_db[keep4]
    id4_reduce_cab = id4_reduce_cab[keep4]
    id4_expand_abd = id4_expand_abd[keep4]

    if len(id4_reduce_ca) > 0:
        order = np.argsort(id4_reduce_ca, kind="stable")
        id4_reduce_ca = id4_reduce_ca[order]
        id4_expand_db = id4_expand_db[order]
        id4_reduce_cab = id4_reduce_cab[order]
        id4_expand_abd = id4_expand_abd[order]
        _, K4 = np.unique(id4_reduce_ca, return_counts=True)
        Kidx4 = ragged_range(K4)
    else:
        Kidx4 = np.zeros(0, INT)

    g.id4_int_a = id4_int_a
    g.id4_int_b = id4_int_b
    g.id4_reduce_ca = id4_reduce_ca.astype(INT)
    g.id4_expand_db = id4_expand_db.astype(INT)
    g.id4_reduce_cab = id4_reduce_cab.astype(INT)
    g.id4_expand_abd = id4_expand_abd.astype(INT)
    g.Kidx4 = Kidx4
    g.id4_reduce_intm_ca = id4_reduce_intm_ca
    g.id4_expand_intm_db = id4_expand_intm_db
    g.id4_reduce_intm_ab = id4_reduce_intm_ab
    g.id4_expand_intm_ab = id4_expand_intm_ab
    return g


def _build_graph_native(R, N, cutoff, int_cutoff, triplets_only) -> GraphArrays:
    """The native C++ builder's arrays as GraphArrays (JAX `graph.py:324-354`)."""
    from .native import build_graph_native

    raw = build_graph_native(R, N, cutoff, int_cutoff or 0.0, triplets_only)
    batch_seg = np.repeat(np.arange(len(N), dtype=INT), N)
    n_undir = len(raw["id_c"]) // 2
    ind = np.arange(n_undir, dtype=INT)
    g = GraphArrays(
        batch_seg=batch_seg,
        id_c=raw["id_c"],
        id_a=raw["id_a"],
        id_undir=np.concatenate([ind, ind]),
        id_swap=np.concatenate([ind + n_undir, ind]),
        id3_expand_ba=raw["id3_expand_ba"],
        id3_reduce_ca=raw["id3_reduce_ca"],
        Kidx3=raw["Kidx3"],
    )
    if not triplets_only:
        for key in ("id4_int_a", "id4_int_b", "id4_reduce_ca", "id4_expand_db",
                    "id4_reduce_cab", "id4_expand_abd", "Kidx4", "id4_reduce_intm_ca",
                    "id4_expand_intm_db", "id4_reduce_intm_ab", "id4_expand_intm_ab"):
            setattr(g, key, raw[key])
    return g


# ------------------------------------------------------------ periodic systems


def _check_cell(cell, N) -> np.ndarray:
    """The cells as float32 (nMol, 3, 3)."""
    if cell is None:
        raise ValueError("max_neighbors caps the periodic graph: pass the systems' cells")
    cell = np.asarray(cell, np.float32)
    if cell.shape != (len(N), 3, 3):
        raise ValueError(f"cell has shape {cell.shape}, N holds {len(N)} systems")
    return cell


def _build_periodic(R, N, cell, cutoff, max_neighbors, triplets_only) -> GraphArrays:
    from .native import edge_triplets, pbc_neighbours

    if not triplets_only:
        raise NotImplementedError("periodic systems build triplets only")
    n_atoms = int(N.sum())
    with spans.span("graph.neighbours"):
        e = pbc_neighbours(R, N, cell, cutoff, max_neighbors)
    spans.count("graph.cap_candidates", e["candidates"])
    spans.count("graph.cap_dropped", e["dropped"])
    spans.count("graph.image_edges", int(np.any(e["offset"] != 0, axis=1).sum()))
    t = edge_triplets(e["id_c"], e["id_a"], n_atoms)
    n_undir = len(e["id_c"]) // 2
    ind = np.arange(n_undir, dtype=INT)
    return GraphArrays(
        batch_seg=np.repeat(np.arange(len(N), dtype=INT), N),
        id_c=e["id_c"], id_a=e["id_a"],
        id_undir=np.concatenate([ind, ind]), id_swap=np.concatenate([ind + n_undir, ind]),
        id3_expand_ba=t["id3_expand_ba"], id3_reduce_ca=t["id3_reduce_ca"], Kidx3=t["Kidx3"],
        edge_offset=e["offset"], cell=cell)
