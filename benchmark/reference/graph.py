"""The GemNet index hierarchy of a batch of molecules, rebuilt from Z and R
in numpy and scipy, unpadded.

A frozen copy of the canonical construction (TUM-DAML gemnet_pytorch,
gemnet/training/data_container.py:244-489): directed edges c->a within
`cutoff` in the reference's undirected order, triplets b->a<-c sorted by
their reduce edge, and the quadruplets c->a-b<-d over the interaction edges
a-b within `int_cutoff`, built through the two intermediate triplet spaces
and with repeated atoms dropped. Every array is real: no padding, no masks.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

INT = np.int64


def _repeat_blocks(sizes, repeats):
    """Block i, arange(start_i, start_i + sizes[i]), repeated repeats[i] times."""
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
    return block_starts[block_of] + within % np.maximum(sizes[block_of], 1)


def _adjacency(R, N, cutoff):
    """(target, source) of every directed pair within `cutoff`, per molecule."""
    t_all, s_all, offset = [], [], 0
    for n in N:
        n = int(n)
        Rm = R[offset:offset + n].astype(np.float64)
        D = np.linalg.norm(Rm[:, None, :] - Rm[None, :, :], axis=-1)
        t, s = np.nonzero((D <= cutoff) & ~np.eye(n, dtype=bool))
        t_all.append(t + offset)
        s_all.append(s + offset)
        offset += n
    return np.concatenate(t_all).astype(INT), np.concatenate(s_all).astype(INT)


def build(R: np.ndarray, N: np.ndarray, cutoff: float, int_cutoff: float,
          triplets_only: bool) -> dict[str, np.ndarray]:
    """The index arrays of the batch: `batch_seg`, `id_c`, `id_a`, `id_swap`,
    `id3_reduce_ca`, `id3_expand_ba` and, with quadruplets, `id4_int_a`,
    `id4_int_b`, `id4_reduce_ca`, `id4_reduce_cab`, `id4_expand_abd`,
    `id4_reduce_intm_ca`, `id4_expand_intm_db`, `id4_reduce_intm_ab`,
    `id4_expand_intm_ab`."""
    N = np.asarray(N, dtype=np.int64)
    n_atoms = int(N.sum())
    out = {"batch_seg": np.repeat(np.arange(len(N)), N).astype(INT)}
    t, s = _adjacency(R, N, cutoff)
    lower = t < s
    lt, ls = t[lower], s[lower]
    n_undir = len(lt)
    id_a = np.concatenate([lt, ls])
    id_c = np.concatenate([ls, lt])
    ind = np.arange(n_undir, dtype=INT)
    id_swap = np.concatenate([ind + n_undir, ind])
    out.update(id_c=id_c, id_a=id_a, id_swap=id_swap)
    n_edges = 2 * n_undir
    edge_ids = sp.csr_matrix((np.arange(n_edges), (id_a, id_c)), shape=(n_atoms, n_atoms))
    adj = sp.csr_matrix((np.ones(n_edges, dtype=np.int64), (id_a, id_c)),
                        shape=(n_atoms, n_atoms))

    # triplets b->a<-c: every edge into the source of c->a, but the reverse
    rows = edge_ids[id_c]
    expand_ba = rows.data.astype(INT)
    reduce_ca = rows.tocoo().row.astype(INT)
    keep = id_a[reduce_ca] != id_c[expand_ba]
    expand_ba, reduce_ca = expand_ba[keep], id_swap[reduce_ca[keep]]
    order = np.argsort(reduce_ca, kind="stable")
    out.update(id3_reduce_ca=reduce_ca[order], id3_expand_ba=expand_ba[order])
    if triplets_only:
        return out

    # quadruplets c->a-b<-d
    int_t, int_s = _adjacency(R, N, int_cutoff)
    nb_t = np.asarray(adj[int_t].sum(axis=1)).ravel().astype(np.int64)
    nb_s = np.asarray(adj[int_s].sum(axis=1)).ravel().astype(np.int64)
    reduce_intm_ca = edge_ids[int_t].data.astype(INT)
    expand_intm_db = edge_ids[int_s].data.astype(INT)
    reduce_intm_ab = np.repeat(np.arange(len(int_t)), nb_t).astype(INT)
    expand_intm_ab = np.repeat(np.arange(len(int_t)), nb_s).astype(INT)
    reduce_cab = _repeat_blocks(nb_t, nb_s)
    reduce_ca = reduce_intm_ca[reduce_cab]
    expand_abd = np.repeat(np.arange(len(expand_intm_db)), np.repeat(nb_t, nb_s)).astype(INT)
    expand_db = expand_intm_db[expand_abd]
    keep = ((id_c[reduce_ca] != id_a[expand_db]) & (id_a[reduce_ca] != id_c[expand_db])
            & (id_c[reduce_ca] != id_c[expand_db]))
    reduce_ca, reduce_cab, expand_abd = reduce_ca[keep], reduce_cab[keep], expand_abd[keep]
    order = np.argsort(reduce_ca, kind="stable")
    out.update(
        id4_int_a=int_t, id4_int_b=int_s, id4_reduce_ca=reduce_ca[order],
        id4_reduce_cab=reduce_cab[order], id4_expand_abd=expand_abd[order],
        id4_reduce_intm_ca=reduce_intm_ca, id4_expand_intm_db=expand_intm_db,
        id4_reduce_intm_ab=reduce_intm_ab, id4_expand_intm_ab=expand_intm_ab)
    return out


def counts(g: dict) -> dict[str, int]:
    """Real rows of each space of a built batch."""
    return {
        "atoms": len(g["batch_seg"]),
        "edges": len(g["id_c"]),
        "triplets": len(g["id3_reduce_ca"]),
        "int_edges": len(g.get("id4_int_a", ())),
        "intm": len(g.get("id4_reduce_intm_ca", ())),
        "quads": len(g.get("id4_reduce_ca", ())),
    }
