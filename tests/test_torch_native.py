"""The port's native C++ graph builder (`data/native.py`) against the JAX
package's native and numpy builders: every array equal, dtype included,
for seeds x GemNet-T/Q (after tests/test_native_builder.py); empty and
single-molecule batches; and a failed build raises instead of falling
back to numpy."""

import dataclasses

import numpy as np
import pytest


def _batch(seed, n_mol=6, lo=4, hi=11):
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(seed)
    mols = [random_molecule(rng, int(rng.integers(lo, hi))) for _ in range(n_mol)]
    return np.concatenate([r for _, r in mols]), np.array([len(z) for z, _ in mols])


def _assert_same_graph(port, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_native_equals_jax_builders(seed, triplets_only):
    from gemnet_pytorch_tpu.data.graph import build_graph as jax_build
    from gemnet_pytorch_tpu.data.graph import check_invariants
    from gemnet_pytorch_tpu_torch.data.graph import build_graph, build_graph_numpy

    R, N = _batch(seed)
    g = build_graph(R, N, 5.0, 10.0, triplets_only=triplets_only)  # native
    check_invariants(g)
    for backend in ("native", "numpy"):
        _assert_same_graph(g, jax_build(R, N, 5.0, 10.0, triplets_only=triplets_only,
                                        backend=backend))
    _assert_same_graph(build_graph_numpy(R, N, 5.0, 10.0, triplets_only=triplets_only), g)


def test_native_empty_and_single():
    from gemnet_pytorch_tpu.data.graph import build_graph as jax_build
    from gemnet_pytorch_tpu_torch.data.graph import build_graph

    # single atom: no edges; two atoms in range: one pair, no triplets; no
    # molecule at all (JAX's numpy builder takes no empty batch)
    cases = [(np.zeros((1, 3), np.float32), np.array([1]), ("native", "numpy")),
             (np.array([[0, 0, 0], [1.2, 0, 0]], np.float32), np.array([2]),
              ("native", "numpy")),
             (np.zeros((0, 3), np.float32), np.zeros(0, np.int64), ("native",))]
    for (R, N, backends), edges in zip(cases, (0, 2, 0)):
        g = build_graph(R, N, 5.0, 10.0)
        assert g.n_edges == edges and g.n_triplets == 0 and g.n_quads == 0
        for backend in backends:
            _assert_same_graph(g, jax_build(R, N, 5.0, 10.0, backend=backend))
    # one molecule of the bench's size
    R, N = _batch(7, n_mol=1, lo=12, hi=13)
    _assert_same_graph(build_graph(R, N, 5.0, 10.0),
                       jax_build(R, N, 5.0, 10.0, backend="numpy"))


def test_bad_inputs_raise():
    from gemnet_pytorch_tpu_torch.data.graph import build_graph, build_graph_numpy

    R, N = _batch(0)
    for build in (build_graph, build_graph_numpy):
        with pytest.raises(ValueError, match="atoms"):
            build(R[:-1], N, 5.0, 10.0)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a missing compiler and a source that does not compile
    each raise a RuntimeError (the second with g++'s message), and the
    numpy builder is not run in their place."""
    from gemnet_pytorch_tpu_torch.data import graph, native

    R, N = _batch(0)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(graph.sp, "csr_matrix", None)  # the numpy builder would fail here
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        graph.build_graph(R, N, 5.0, 10.0)
    monkeypatch.setattr(native, "CXX", "g++")
    broken = tmp_path / "graphbuild.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="failed to build(.|\n)*error"):
        graph.build_graph(R, N, 5.0, 10.0)
    assert not list((tmp_path / "_build").glob("*.so"))  # no partial library left
