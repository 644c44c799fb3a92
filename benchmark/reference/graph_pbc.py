"""The periodic graph of OCP's GemNet-T in plain numpy: the reference of
the program's periodic builder (`data/graph.py` with a cell).

OCP (ocpmodels/common/utils.py radius_graph_pbc, get_max_neighbors_mask;
ocpmodels/models/gemnet/gemnet.py GemNetT.reorder_symmetric_edges,
get_triplets), brute force, one target atom at a time:
- every source image R[s] + o.cell within the cutoff of R[t], over the
  image shells ceil(cutoff / height) of each cell vector around the
  atoms' positions wrapped into the cell (so an atom outside it finds
  every image too; o is from the atoms' own positions), a squared
  distance in (1e-4, cutoff^2] (in double: (R[s] - R[t]) + o.cell, o.cell
  summed over the cell vectors in order);
- each target's `max_neighbors` nearest, ties broken by (distance, source,
  offset in lexicographic order);
- the symmetric selection: an edge is kept where s < t, or s == t and o is
  lexicographically negative; the kept edges in (target, source, offset)
  order, then the reverse (t -> s, -o) of each;
- the triplets: for each edge c -> a in order, every other edge b -> a of
  its target, in (source, edge) order; b == c is a triplet where the two
  edges differ.

Departures from OCP: OCP's cap keeps every edge tied with the last one
kept within 0.01 A unless told to be strict; this one is strict, with the
tie-break above. OCP searches around the atoms' own positions, which finds
the same edges where the atoms lie in the cell, and may miss some of an
atom outside it. Arrays are int32 (edges, triplets)
and int8 (offsets), in the order the program's builder gives them.
"""

from __future__ import annotations

import itertools

import numpy as np


def shells(cell: np.ndarray, R: np.ndarray, cutoff: float):
    """(shells, wrap): ceil(cutoff / the cell's height) along each cell
    vector, and each atom's integer cell, the floor of its fractional
    coordinates (the shells are searched around the wrapped positions)."""
    C = cell.astype(np.float64)
    reps, wrap = [], np.zeros((len(R), 3), np.int64)
    for ax in range(3):
        a, b = C[(ax + 1) % 3], C[(ax + 2) % 3]
        cr = np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                       a[0] * b[1] - a[1] * b[0]])
        vol = C[ax][0] * cr[0] + C[ax][1] * cr[1] + C[ax][2] * cr[2]
        if vol == 0:
            reps.append(0)
            continue
        reps.append(int(np.ceil(cutoff * np.sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2])
                                / abs(vol))))
        for i, r in enumerate(R.astype(np.float64)):
            wrap[i, ax] = int(np.floor((r[0] * cr[0] + r[1] * cr[1] + r[2] * cr[2]) / vol))
    return reps, wrap


def _negative(o) -> bool:
    return o[0] < 0 or (o[0] == 0 and (o[1] < 0 or (o[1] == 0 and o[2] < 0)))


def neighbours(R, N, cell, cutoff, max_neighbors):
    """(kept edges [(t, s, o)] in order, candidates, dropped) of the batch."""
    kept, n_cand, n_drop = [], 0, 0
    off = 0
    for m, n in enumerate(N):
        n = int(n)
        C = cell[m].astype(np.float64)
        Rm = R[off:off + n].astype(np.float64)
        reps, wrap = shells(cell[m], R[off:off + n], cutoff)
        images = np.array(list(itertools.product(*[range(-r, r + 1) for r in reps])), np.int64)
        for t in range(n):
            # every source s and image of its wrapped position, with its
            # offset from s's own position
            o = images[None, :, :] - (wrap - wrap[t])[:, None, :]  # [s, k]
            of = o.astype(np.float64)
            shift = of[..., 0:1] * C[0] + of[..., 1:2] * C[1] + of[..., 2:3] * C[2]
            d = (Rm - Rm[t])[:, None, :] + shift
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            s, k = np.nonzero((d2 > 1e-4) & (d2 <= cutoff * cutoff))
            n_cand += len(s)
            if max_neighbors is not None and len(s) > max_neighbors:
                n_drop += len(s) - max_neighbors
                nearest = np.lexsort((o[s, k, 2], o[s, k, 1], o[s, k, 0], s, d2[s, k]))
                nearest = np.sort(nearest[:max_neighbors])
                s, k = s[nearest], k[nearest]
            for si, ki in zip(s.tolist(), k.tolist()):
                if si < t or (si == t and _negative(o[si, ki])):
                    kept.append((off + t, off + si, tuple(o[si, ki])))
        off += n
    return kept, n_cand, n_drop


def build(R, N, cell, cutoff, max_neighbors=None) -> dict:
    """The periodic batch graph: batch_seg, id_c, id_a, id_swap,
    edge_offset, id3_reduce_ca, id3_expand_ba, and the counts of candidate
    and capped-off edges."""
    N = np.asarray(N, np.int64)
    kept, n_cand, n_drop = neighbours(np.asarray(R), N, np.asarray(cell), cutoff,
                                      max_neighbors)
    t = np.array([e[0] for e in kept], np.int32)
    s = np.array([e[1] for e in kept], np.int32)
    o = np.array([e[2] for e in kept], np.int8).reshape(-1, 3)
    half = len(kept)
    id_c, id_a = np.concatenate([s, t]), np.concatenate([t, s])
    # each atom's incoming edges in (source, edge) order
    order = sorted(range(2 * half), key=lambda e: (id_a[e], id_c[e], e))
    incoming = {a: np.array(list(edges), np.int32)
                for a, edges in itertools.groupby(order, key=lambda e: int(id_a[e]))}
    expand = [incoming[a][incoming[a] != r] for r, a in enumerate(id_a.tolist())]
    reduce = [np.full(len(x), r, np.int32) for r, x in enumerate(expand)]
    return {
        "batch_seg": np.repeat(np.arange(len(N), dtype=np.int32), N),
        "id_c": id_c, "id_a": id_a,
        "id_swap": np.concatenate([np.arange(half) + half, np.arange(half)]).astype(np.int32),
        "edge_offset": np.concatenate([o, -o]),
        "id3_reduce_ca": np.concatenate(reduce or [np.zeros(0, np.int32)]),
        "id3_expand_ba": np.concatenate(expand or [np.zeros(0, np.int32)]),
        "candidates": n_cand, "dropped": n_drop,
    }


def counts(g: dict) -> dict:
    """Real rows of each space, as the readers of the traced steps take them."""
    return {"atoms": len(g["batch_seg"]), "edges": len(g["id_c"]),
            "triplets": len(g["id3_reduce_ca"]), "intm": 0, "quads": 0}
