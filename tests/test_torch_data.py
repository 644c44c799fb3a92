"""The PyTorch port's data pipeline against the JAX package's: pad_batch and
Molecule.get equal array for array (GemNet-Q and -T), the dtypes and segment
pointers of the torch boundary, and the config defaults."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dims_kwargs(g, n_atoms, n_mol, triplets_only):
    return dict(
        n_mol=n_mol + 2, n_atoms=n_atoms + 10, n_edges=g.n_edges + 64,
        n_triplets=g.n_triplets + 64, kmax3=g.kmax3 + 2,
        n_int_edges=0 if triplets_only else g.n_int_edges + 16,
        n_intm=0 if triplets_only else g.n_intm + 32,
        n_quads=0 if triplets_only else g.n_quads + 64,
        kmax4=0 if triplets_only else g.kmax4 + 2,
    )


def _assert_equal_batches(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k].dtype == ref[k].dtype, k
        assert port[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_pad_batch_equals_jax(synthetic_npz, triplets_only):
    from gemnet_pytorch_tpu.data.containers import DataContainer as JaxContainer
    from gemnet_pytorch_tpu.data.padding import PadDims as JaxDims
    from gemnet_pytorch_tpu_torch.data import DataContainer, PadDims

    idx = [0, 1, 2, 3, 7]
    c = DataContainer(synthetic_npz, 5.0, 10.0, triplets_only=triplets_only)
    jc = JaxContainer(synthetic_npz, 5.0, 10.0, triplets_only=triplets_only)
    g, Z, *_ = c.build(idx)
    kw = _dims_kwargs(g, len(Z), len(idx), triplets_only)
    _assert_equal_batches(c.get_padded(idx, PadDims(**kw)), jc.get_padded(idx, JaxDims(**kw)))


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_molecule_get_equals_jax(triplets_only):
    from gemnet_pytorch_tpu.data.containers import Molecule as JaxMolecule
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    Z, R = random_molecule(np.random.default_rng(3), 9)
    mol = Molecule(R, Z, 5.0, 10.0, triplets_only=triplets_only)
    jmol = JaxMolecule(R, Z, 5.0, 10.0, triplets_only=triplets_only)
    for step in range(2):  # the second geometry reuses the grown dims
        _assert_equal_batches(mol.get(), jmol.get())
        R = R + np.float32(0.03) * (step + 1)
        mol.update(R)
        jmol.update(R)


def test_estimate_pad_dims_equals_jax(synthetic_npz):
    """The same dims as the JAX package's, less its TPU-only seg_block choice."""
    from gemnet_pytorch_tpu.data.containers import DataContainer as JaxContainer
    from gemnet_pytorch_tpu.data.padding import estimate_pad_dims as jax_estimate
    from gemnet_pytorch_tpu_torch.data import DataContainer, estimate_pad_dims

    c = DataContainer(synthetic_npz, 5.0, 10.0)
    jc = JaxContainer(synthetic_npz, 5.0, 10.0)
    batches = [[0, 1, 2], [3, 4, 5, 6], [8, 9]]
    graphs = [c.build(b)[0] for b in batches]
    n_atoms = [int(c.N[b].sum()) for b in batches]
    port = dataclasses.asdict(estimate_pad_dims(graphs, 4, n_atoms))
    ref = dataclasses.asdict(jax_estimate([jc.build(b)[0] for b in batches], 4, n_atoms))
    ref.pop("seg_block3")
    ref.pop("seg_block4")
    assert port == ref


def _padded(synthetic_npz, triplets_only=False):
    from gemnet_pytorch_tpu_torch.data import DataContainer, PadDims

    c = DataContainer(synthetic_npz, 5.0, 10.0, triplets_only=triplets_only)
    idx = [0, 1, 2, 3]
    g, Z, *_ = c.build(idx)
    return c.get_padded(idx, PadDims(**_dims_kwargs(g, len(Z), len(idx), triplets_only)))


def test_to_torch_dtypes_and_plans(synthetic_npz):
    from gemnet_pytorch_tpu_torch.data import SORT_META_KEYS, SegmentPlan, to_torch
    from gemnet_pytorch_tpu_torch.data.batch import EDGE_SORT_KEYS, SEGMENT_PLANS

    batch = _padded(synthetic_npz)
    assert batch["Z"].dtype == np.int16 and batch["id3_reduce_ca"].dtype == np.int16
    tb = to_torch(batch, "cpu")
    for k, v in batch.items():
        if k in SORT_META_KEYS:
            assert tb[k].dtype == torch.int32, k
        elif np.issubdtype(v.dtype, np.integer):
            assert tb[k].dtype == torch.int64, k  # int16 columns widened for indexing
        elif v.dtype == np.bool_:
            assert tb[k].dtype == torch.bool, k
        else:
            assert tb[k].dtype == torch.float32, k
        np.testing.assert_array_equal(tb[k].numpy(), v, err_msg=k)
    for k in EDGE_SORT_KEYS:  # derived by to_torch, kernel inputs
        assert tb[k].dtype == torch.int32, k
    for key, (ids_key, size_key, _) in SEGMENT_PLANS.items():
        plan = tb[key]
        assert isinstance(plan, SegmentPlan)
        assert plan.items.dtype == plan.merge_ptr.dtype == plan.merge_seg.dtype == torch.int32
        assert plan.arrivals.dtype == torch.int32
        np.testing.assert_array_equal(plan.arrivals.numpy(), np.zeros(plan.merge_seg.numel()))
        assert plan.n_segments == len(batch[size_key])
        ids = tb[ids_key].numpy()
        np.testing.assert_array_equal(
            _plan_segment_sum(plan, np.ones((len(ids), 1))).ravel(),
            np.bincount(ids.astype(np.int64), minlength=plan.n_segments))


def _plan_segment_sum(plan, x):
    """numpy model of the kernels' two passes over a plan: per-item sums into
    the output or the partial slots, then the split segments' merge; the
    padding items and merges of a capacity plan (segment -1) skipped."""
    items = plan.items.numpy()
    out = np.full((plan.n_segments, x.shape[1]), np.nan)
    partial = np.full((plan.n_partials, x.shape[1]), np.nan)
    for seg, r0, r1, slot in items[items[:, 0] >= 0]:
        (out if slot < 0 else partial)[seg if slot < 0 else slot] = x[r0:r1].sum(0)
    mp = plan.merge_ptr.numpy()
    for j, seg in enumerate(plan.merge_seg.numpy()):
        if seg >= 0:
            out[seg] = partial[mp[j]:mp[j + 1]].sum(0)
    return out


@pytest.mark.parametrize("item_rows", [1, 3, 32, 128])
def test_segment_plan_covers_every_row_once(item_rows):
    """Every row in exactly one item, items of at most item_rows rows, every
    segment (empty ones too) written exactly once, one long segment split."""
    from gemnet_pytorch_tpu_torch.data import segment_plan

    rng = np.random.default_rng(item_rows)
    ids = np.sort(np.concatenate([rng.integers(0, 40, 200), np.full(300, 17)]))
    plan = segment_plan(ids, 45, item_rows, "cpu", capacity=False)
    items = plan.items.numpy()
    assert np.all(items[:, 2] - items[:, 1] <= item_rows)
    covered = np.concatenate([np.arange(r0, r1) for _, r0, r1, _ in items])
    np.testing.assert_array_equal(np.sort(covered), np.arange(len(ids)))
    assert np.all(ids[covered] == np.repeat(items[:, 0], items[:, 2] - items[:, 1]))
    x = rng.normal(size=(len(ids), 3))
    ref = np.zeros((45, 3))
    np.add.at(ref, ids, x)
    np.testing.assert_allclose(_plan_segment_sum(plan, x), ref, atol=1e-12)
    assert 17 in plan.merge_seg.numpy()


@pytest.mark.parametrize("key", ["trip_ba_plan", "id4_reduce_ca_plan", "id3_reduce_ca_plan"])
def test_segment_plan_long_and_empty_segments(key):
    """At the item size of a K3 plan and of a K1/K2 plan: a 10 000-row
    segment (the padded rows'), empty segments and 1-row segments. Every row
    lies in exactly one item, a split segment's slots are consecutive and in
    row order, `merge_ptr` delimits them, and `arrivals` is one int32 zero
    per split segment."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS

    item_rows = SEGMENT_PLANS[key][2]
    rng = np.random.default_rng(item_rows)
    n_seg = 500
    ids = np.sort(np.concatenate([np.zeros(10_000, np.int64), rng.integers(3, 400, 2000),
                                  np.arange(450, 460)]))  # ids 1, 2, 400-449, 460- stay empty
    plan = segment_plan(ids, n_seg, item_rows, "cpu", capacity=False)
    items = plan.items.numpy()
    seg, r0, r1, slot = items.T
    np.testing.assert_array_equal(r0[1:], r1[:-1])  # items tile the rows in order
    assert r0[0] == 0 and r1[-1] == len(ids) and np.all(r1 - r0 <= item_rows)
    np.testing.assert_array_equal(ids, np.repeat(seg, r1 - r0))  # each row in its segment
    np.testing.assert_array_equal(np.unique(seg), np.arange(n_seg))  # empty ones too
    assert np.sum(seg == 0) == -(-10_000 // item_rows)
    split = slot >= 0
    np.testing.assert_array_equal(slot[split], np.arange(plan.n_partials))  # row order
    mp = plan.merge_ptr.numpy()
    for j, e in enumerate(plan.merge_seg.numpy()):
        np.testing.assert_array_equal(slot[seg == e], np.arange(mp[j], mp[j + 1]))
    assert 0 in plan.merge_seg.numpy()
    assert plan.arrivals.dtype == torch.int32
    np.testing.assert_array_equal(plan.arrivals.numpy(), np.zeros(len(mp) - 1))
    x = rng.normal(size=(len(ids), 2))
    ref = np.zeros((n_seg, 2))
    np.add.at(ref, ids, x)
    np.testing.assert_allclose(_plan_segment_sum(plan, x), ref, atol=1e-9)
    with pytest.raises(ValueError):
        segment_plan(np.concatenate([ids, [n_seg]]), n_seg, item_rows, "cpu")


def _tree_segment_sum(plan, x):
    """numpy model of the K4 forward over a plan: per-item sums into the
    output or the item's partial slot, then the merge tree's nodes, each
    adding its children in slot order into its slot or the output."""
    out = np.full((plan.n_segments, x.shape[1]), np.nan)
    partial = np.full((plan.n_tree_slots, x.shape[1]), np.nan)
    for seg, r0, r1, slot in plan.items.numpy():
        (out if slot < 0 else partial)[seg if slot < 0 else slot] = x[r0:r1].sum(0)
    for first, end, slot, seg in plan.tree_nodes.numpy():
        assert not np.isnan(partial[first:end]).any()  # every child is written before
        (out if slot < 0 else partial)[seg if slot < 0 else slot] = partial[first:end].sum(0)
    return out


def _check_merge_tree(rows, item_rows):
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.data.batch import MERGE_FAN

    rng = np.random.default_rng(rows)
    n_seg = 300
    ids = np.sort(np.concatenate([rng.integers(0, 250, 3000), np.full(rows, 260),
                                  np.full(300, 7)]))  # 261-299 stay empty
    plan = segment_plan(ids, n_seg, item_rows, "cpu", capacity=False)
    nodes, parent = plan.tree_nodes.numpy(), plan.tree_parent.numpy()
    first, end, out_slot, seg = nodes.T
    assert np.all(end - first >= 1) and np.all(end - first <= MERGE_FAN)
    assert plan.n_tree_slots == len(parent) >= plan.n_partials
    children = np.concatenate([np.arange(f, e) for f, e in zip(first, end)])
    np.testing.assert_array_equal(np.sort(children), np.arange(plan.n_tree_slots))
    for i, (f, e) in enumerate(zip(first, end)):
        np.testing.assert_array_equal(parent[f:e], i)
    inner = out_slot >= 0
    np.testing.assert_array_equal(np.sort(out_slot[inner]),
                                  np.arange(plan.n_partials, plan.n_tree_slots))
    assert np.all(seg[inner] == seg[parent[out_slot[inner]]])  # a node feeds its own segment
    np.testing.assert_array_equal(np.sort(seg[~inner]), plan.merge_seg.numpy())
    levels = int(np.ceil(np.log(-(-rows // item_rows)) / np.log(MERGE_FAN) - 1e-9))
    assert np.sum(seg == 260) == sum(-(-(-(-rows // item_rows)) // MERGE_FAN**k) for k in
                                     range(1, levels + 1))
    assert plan.tree_arrivals.dtype == torch.int32
    np.testing.assert_array_equal(plan.tree_arrivals.numpy(), np.zeros(len(nodes)))
    x = rng.normal(size=(len(ids), 2))
    ref = np.zeros((n_seg, 2))
    np.add.at(ref, ids, x)
    np.testing.assert_allclose(_tree_segment_sum(plan, x), ref, atol=1e-9)


@pytest.mark.parametrize("rows", [129, 2048, 2049, 9600, 32768, 40000])
def test_segment_plan_merge_tree(rows):
    """The merge tree of K1 and the K4 forward for a long segment (9600
    rows: the padded rows' at the bench quad shape) beside short and empty
    ones, at the item sizes of the quadruplet and the triplet plans: every
    partial slot feeds exactly one node, no node adds more than MERGE_FAN
    children, a node's children are consecutive slots, one root per split
    segment writes its output, the counters are int32 zeros, and the tree's
    sums equal the segment sums."""
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS

    for key in ("id4_reduce_ca_plan", "id3_reduce_ca_plan"):
        _check_merge_tree(rows, SEGMENT_PLANS[key][2])


def test_kernel_id_columns_are_sorted(synthetic_npz):
    """The segment kernels' precondition (checked here, not on the hot path):
    every column they reduce over is ascending, padded rows included; the
    edges' one column sorts both id_a and id_c."""
    from gemnet_pytorch_tpu_torch.data.batch import SEGMENT_PLANS, with_edge_sort_metadata

    batch = with_edge_sort_metadata(_padded(synthetic_npz))
    for ids_key, _, _ in SEGMENT_PLANS.values():
        assert np.all(np.diff(batch[ids_key].astype(np.int64)) >= 0), ids_key
    for tag, src in (("trip_ba", "id3_expand_ba"), ("intm_db", "id4_expand_intm_db"),
                     ("quad_abd", "id4_expand_abd"), ("quad_cab", "id4_reduce_cab"),
                     ("edge_a", "id_a"), ("edge_c", "id_c")):
        srt = batch["edge_sorted"] if tag.startswith("edge") else batch[f"{tag}_sorted"]
        np.testing.assert_array_equal(srt, batch[src][batch[f"{tag}_perm"]])


def test_segment_plan_rejects_out_of_range_ids():
    from gemnet_pytorch_tpu_torch.data import segment_plan

    assert segment_plan(np.array([0, 0, 2]), 4, 8, "cpu", capacity=False).items.shape == (4, 4)
    # at capacity: 4 segments + ceil(3 / 8) items
    assert segment_plan(np.array([0, 0, 2]), 4, 8, "cpu").items.shape == (5, 4)
    with pytest.raises(ValueError):
        segment_plan(np.array([0, 1, 4]), 4, 8, "cpu")


def test_model_config_defaults_equal_config_yaml():
    """chip_smoke builds ModelConfig() from its defaults; they are the model
    section of config.yaml (scale_file names a file, not a width)."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, load_yaml_config

    loaded = ModelConfig.from_dict(load_yaml_config(os.path.join(REPO, "config.yaml")))
    assert dataclasses.replace(loaded, scale_file=None) == ModelConfig()


def test_model_config_fields_equal_jax():
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    # the port's fields are JAX's, but bilinear_implementation (the tensor's
    # device picks the kernels here), and the periodic GemNet-dT ones (OCP's
    # bases and neighbour cap), whose defaults keep JAX's model
    port, ref = dataclasses.asdict(ModelConfig()), dataclasses.asdict(JaxConfig())
    ref.pop("bilinear_implementation")
    assert {k: v for k, v in port.items() if k in ref} == ref
    assert {k: v for k, v in port.items() if k not in ref} == dict(
        rbf="bessel", cbf="bessel", max_neighbors=None)
