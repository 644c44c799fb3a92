"""The port's periodic graph (`data/graph.py` with a cell: OCP's GemNetT
graph): the native builder equals the benchmark's brute-force reference
(`benchmark/reference/graph_pbc.py`) array for array,
on cells narrower than the cutoff, with an atom's edges to its own images,
caps that bind and that do not, and b == c triplets through two images;
and without a cell the arrays are the JAX package's, bit for bit."""

import numpy as np
import pytest

from benchmark.reference import graph_pbc
from gemnet_pytorch_tpu_torch.data import graph
from gemnet_pytorch_tpu_torch.perf import spans

KEYS = ("id_c", "id_a", "id_swap", "edge_offset", "id3_reduce_ca", "id3_expand_ba")


def _hex_cell(d, n, m, height):
    return np.array([[n * d, 0, 0], [0.5 * m * d, 0.5 * np.sqrt(3) * m * d, 0], [0, 0, height]],
                    np.float32)


def _systems(seed):
    """Three systems: a 1x1 surface cell of one atom (2.5 A wide: images two
    and more cells away, edges to its own images only), a 2x2 cell of 3
    atoms, and a 3x3 two-layer slab (cap binds at 12, not at 80)."""
    rng = np.random.default_rng(seed)
    cells, Rs = [], []
    for d, (n, m), atoms in ((2.5, (1, 1), 1), (2.6, (2, 2), 3), (2.7, (3, 3), 18)):
        cell = _hex_cell(d, n, m, 16.0)
        frac = rng.random((atoms, 3)) * [1, 1, 0.2]
        cells.append(cell)
        Rs.append((frac @ cell).astype(np.float32) + rng.normal(scale=0.1, size=(atoms, 3)))
    N = np.array([len(r) for r in Rs])
    return np.concatenate(Rs).astype(np.float32), N, np.stack(cells)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cap", [None, 12, 80])
def test_native_numpy_and_reference_agree(seed, cap):
    """The native builder against the reference, array for array, and
    each triplet's rank within its reduce edge's group."""
    R, N, cell = _systems(seed)
    g = graph.build_graph(R, N, 6.0, None, True, cell=cell, max_neighbors=cap)
    ref = graph_pbc.build(R, N, cell, 6.0, cap)
    for k in KEYS:
        a, c = getattr(g, k), ref[k]
        assert a.dtype == c.dtype, k
        np.testing.assert_array_equal(a, c, err_msg=k)
    starts = np.searchsorted(g.id3_reduce_ca, g.id3_reduce_ca)
    np.testing.assert_array_equal(g.Kidx3, np.arange(len(g.id3_reduce_ca)) - starts)
    assert g.cell.shape == (3, 3, 3) and g.edge_offset.shape == (g.n_edges, 3)


def test_graph_properties():
    """What the model relies on: each edge's reverse is its id_swap with the
    negated offset, the offsets reach two and more cells on the narrow cell,
    atoms have edges to their own images, the cap holds, and b == c
    triplets (two images of one atom) are there."""
    R, N, cell = _systems(0)
    g = graph.build_graph(R, N, 6.0, None, True, cell=cell, max_neighbors=12)
    sw = g.id_swap
    np.testing.assert_array_equal(g.id_c[sw], g.id_a)
    np.testing.assert_array_equal(g.edge_offset[sw], -g.edge_offset)
    assert np.abs(g.edge_offset[g.batch_seg[g.id_a] == 0]).max() >= 2
    assert (g.id_c == g.id_a).any()
    same_source = g.id_c[g.id3_reduce_ca] == g.id_c[g.id3_expand_ba]
    assert same_source.any() and (g.id3_reduce_ca != g.id3_expand_ba).all()
    # every target keeps at most 12 of its own candidates; the selection
    # adds reverses, so count the kept half by target
    half = g.n_edges // 2
    assert np.bincount(g.id_a[:half]).max() <= 12
    # the vectors of an edge and its reverse are opposite
    V = (R[g.id_a] - R[g.id_c] - np.einsum("ei,eij->ej", g.edge_offset.astype(np.float32),
                                              cell[g.batch_seg[g.id_a]]))
    np.testing.assert_allclose(V[sw], -V, atol=1e-5)
    assert (np.linalg.norm(V, axis=1) <= 6.0 + 1e-5).all()


def test_counters_and_span():
    R, N, cell = _systems(1)
    before = dict(spans.counters())
    g = graph.build_graph(R, N, 6.0, None, True, cell=cell, max_neighbors=12)
    ref = graph_pbc.build(R, N, cell, 6.0, 12)
    after = spans.counters()

    def grew(k):
        return after.get(k, 0) - before.get(k, 0)

    assert grew("graph.cap_candidates") == ref["candidates"]
    assert grew("graph.cap_dropped") == ref["dropped"] > 0
    assert grew("graph.image_edges") == int(np.any(g.edge_offset != 0, axis=1).sum()) > 0


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_no_cell_is_the_jax_graph(triplets_only):
    """Without a cell or a cap the arrays are those of the JAX package's
    builder (the molecules' graph as it was), bit for bit, and carry no
    periodic fields."""
    import dataclasses

    from gemnet_pytorch_tpu.data.graph import build_graph as jax_build
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(5)
    mols = [random_molecule(rng, int(rng.integers(4, 11))) for _ in range(5)]
    R = np.concatenate([r for _, r in mols])
    N = np.array([len(z) for z, _ in mols])
    g = graph.build_graph(R, N, 5.0, 10.0, triplets_only=triplets_only)
    ref = jax_build(R, N, 5.0, 10.0, triplets_only=triplets_only, backend="numpy")
    for f in dataclasses.fields(ref):
        a, b = getattr(g, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert g.edge_offset is None and g.cell is None and g.free is None


def test_quadruplets_refuse_a_cell():
    R, N, cell = _systems(0)
    with pytest.raises(NotImplementedError):
        graph.build_graph(R, N, 6.0, 6.0, False, cell=cell)


def test_a_cap_needs_a_cell():
    """The cap is the periodic graph's (OCP's max_neighbors): molecules
    without cells refuse it."""
    R, N, _ = _systems(0)
    with pytest.raises(ValueError, match="cells"):
        graph.build_graph(R, N, 6.0, None, True, max_neighbors=12)
