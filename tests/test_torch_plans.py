"""Capacity segment plans (`data.batch.plan_capacity`): their shapes depend
on the row count, the segment count and the item size alone; the bounds
`plan_capacity` derives from `merge_tree` hold for every plan drawn; and a numpy
emulation of the kernels' item and merge semantics (a padding item or merge,
segment -1, skipped) sums to the same fp32 bits over the capacity plan as
over the exact one. `merge_tree` builds every split segment's tree at once;
`_merge_tree_loop`, one segment at a time, is the oracle of its numbering,
held array for array and through the packer's words."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

ITEM_ROWS = (16, 64, 128)


@st.composite
def segment_lengths(draw):
    """1-50 segments of 0-300 rows each, and an item size of the plans'."""
    lengths = draw(st.lists(st.integers(0, 300), min_size=1, max_size=50))
    return np.array(lengths), draw(st.sampled_from(ITEM_ROWS))


def _ids(lengths):
    return np.repeat(np.arange(len(lengths)), lengths)


def _plan(lengths, item_rows, capacity):
    from gemnet_pytorch_tpu_torch.data.batch import plan_arrays

    return plan_arrays(_ids(lengths), len(lengths), item_rows, capacity)


def _items_sum(arrays, n_partials, n_segments, x):
    """fp32 rows of each item summed in row order into the output (an
    unsplit segment) or the item's partial slot; padding items skipped."""
    out = np.full((n_segments, x.shape[1]), np.nan, np.float32)
    partial = np.full((n_partials, x.shape[1]), np.nan, np.float32)
    for seg, r0, r1, slot in arrays["items"]:
        if seg < 0:
            continue
        acc = np.zeros(x.shape[1], np.float32)
        for r in range(r0, r1):
            acc = acc + x[r]
        (out if slot < 0 else partial)[seg if slot < 0 else slot] = acc
    return out, partial


def _add_in_order(rows):
    acc = np.zeros(rows.shape[1], np.float32)
    for r in rows:
        acc = acc + r
    return acc


def _k3_sum(arrays, n_partials, n_segments, x):
    """K3's semantics: items, then each split segment's slots added in slot
    order by the last of its items (padding merges, segment -1, skipped)."""
    out, partial = _items_sum(arrays, n_partials, n_segments, x)
    mp, ms = arrays["merge_ptr"], arrays["merge_seg"]
    for j, seg in enumerate(ms):
        if seg >= 0:
            out[seg] = _add_in_order(partial[mp[j]:mp[j + 1]])
    return out


def _tree_sum(arrays, n_partials, n_tree_slots, n_segments, x):
    """K1's and the K4 forward's semantics: items, then the merge tree's
    nodes in order (children before parents), each adding its children in
    slot order into its slot or the output. A padding node (segment -1)
    has no children, so no finished child ever reaches it."""
    out, partial = _items_sum(arrays, n_partials, n_segments, x)
    slots = np.full((n_tree_slots, x.shape[1]), np.nan, np.float32)
    slots[:n_partials] = partial
    for first, end, slot, seg in arrays["tree_nodes"]:
        if seg < 0:
            assert first == end
            continue
        acc = _add_in_order(slots[first:end])
        assert not np.isnan(acc).any()  # every child was written before
        if slot < 0:
            out[seg] = acc
        else:
            slots[slot] = acc
    return out


def test_capacity_is_a_function_of_the_shapes():
    """Two batches of one padded shape (the same rows, segments and item
    size, other lengths) give plans of identical shapes and Python ints."""
    from gemnet_pytorch_tpu_torch.data.batch import plan_arrays, plan_capacity

    rng = np.random.default_rng(0)
    n_rows, n_seg = 4000, 300
    for item_rows in ITEM_ROWS:
        shapes = set()
        for trial in range(4):
            real = rng.integers(0, n_seg - 1, int(rng.integers(100, 3000)))
            ids = np.sort(np.concatenate([real, np.full(n_rows - len(real), n_seg - 1)]))
            arrays, n_partials, n_tree_slots = plan_arrays(ids, n_seg, item_rows)
            shapes.add((tuple((k, v.shape) for k, v in arrays.items()), n_partials,
                        n_tree_slots))
        assert len(shapes) == 1
        cap = plan_capacity(n_rows, n_seg, item_rows)
        ((shape, n_partials, n_tree_slots),) = shapes
        assert dict(shape) == {"items": (cap.items, 4), "merge_ptr": (cap.merges + 1,),
                               "merge_seg": (cap.merges,), "tree_nodes": (cap.nodes, 4),
                               "tree_parent": (cap.tree_slots,)}
        assert (n_partials, n_tree_slots) == (cap.partials, cap.tree_slots)


@settings(max_examples=150, deadline=None)
@given(segment_lengths())
def test_the_exact_plan_stays_within_capacity(drawn):
    """The stated bounds: items <= n_segments + ceil(n_rows / r), partials
    <= min(items, 2 floor(n_rows / r)), merges <= partials // 2, inner tree
    nodes <= partials // 4 (so tree slots and nodes within theirs)."""
    from gemnet_pytorch_tpu_torch.data.batch import plan_capacity

    lengths, item_rows = drawn
    n_rows, n_seg = int(lengths.sum()), len(lengths)
    exact, n_partials, n_tree_slots = _plan(lengths, item_rows, capacity=False)
    cap = plan_capacity(n_rows, n_seg, item_rows)
    assert len(exact["items"]) <= n_seg + -(-n_rows // item_rows) == cap.items
    assert n_partials <= cap.partials == min(cap.items, 2 * (n_rows // item_rows))
    assert len(exact["merge_seg"]) <= cap.merges
    assert n_tree_slots - n_partials <= cap.partials // 4
    assert n_tree_slots <= cap.tree_slots and len(exact["tree_nodes"]) <= cap.nodes


@settings(max_examples=60, deadline=None)
@given(segment_lengths(), st.integers(0, 2**31 - 1))
def test_capacity_plan_sums_bit_equal_to_the_exact_plan(drawn, seed):
    """The kernels' item and merge semantics, emulated in fp32 over the
    capacity plan and over the exact plan: the same bits, for K3's merge
    and for K1's merge tree; the capacity plan is the exact one followed by
    padding entries."""
    lengths, item_rows = drawn
    n_seg = len(lengths)
    x = np.random.default_rng(seed).normal(size=(int(lengths.sum()), 3)).astype(np.float32)
    exact, p_ex, t_ex = _plan(lengths, item_rows, capacity=False)
    cap, p_cap, t_cap = _plan(lengths, item_rows, capacity=True)
    n_items = len(exact["items"])
    np.testing.assert_array_equal(cap["items"][:n_items], exact["items"])
    assert np.all(cap["items"][n_items:] == [-1, 0, 0, -1])
    assert np.all(cap["merge_seg"][len(exact["merge_seg"]):] == -1)
    for fn, args_ex, args_cap in ((_k3_sum, (p_ex,), (p_cap,)),
                                  (_tree_sum, (p_ex, t_ex), (p_cap, t_cap))):
        a = fn(exact, *args_ex, n_seg, x)
        b = fn(cap, *args_cap, n_seg, x)
        assert not np.isnan(a).any()
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("item_rows", ITEM_ROWS)
def test_capacity_bounds_are_reached_or_near(item_rows):
    """One long segment (the padded rows') beside empty ones: the items fill
    the capacity's segment term plus the rows' items, and the partials come
    within one item of the rows' term."""
    from gemnet_pytorch_tpu_torch.data.batch import plan_capacity

    n_seg, n_rows = 40, 5000
    lengths = np.zeros(n_seg, np.int64)
    lengths[-1] = n_rows
    exact, n_partials, _ = _plan(lengths, item_rows, capacity=False)
    cap = plan_capacity(n_rows, n_seg, item_rows)
    assert len(exact["items"]) == n_seg - 1 + -(-n_rows // item_rows) <= cap.items
    assert n_partials == -(-n_rows // item_rows) <= cap.partials


def _merge_tree_loop(merge_ptr, merge_seg, n_partials):
    """`merge_tree`'s (nodes, parent), one split segment and one level at a
    time: the oracle of its numbering (segment by segment, level by level,
    group by group; the non-root slots in the same order)."""
    from gemnet_pytorch_tpu_torch.data.batch import MERGE_FAN

    nodes, parent = [], np.full(n_partials, -1, np.int64)
    next_slot = n_partials
    for j, seg in enumerate(merge_seg):
        level = np.arange(merge_ptr[j], merge_ptr[j + 1])
        while True:
            groups = [level[i:i + MERGE_FAN] for i in range(0, len(level), MERGE_FAN)]
            root = len(groups) == 1
            outs = np.arange(next_slot, next_slot + (0 if root else len(groups)))
            next_slot += len(outs)
            parent = np.concatenate([parent, np.full(len(outs), -1)])
            for k, grp in enumerate(groups):
                parent[grp] = len(nodes)
                nodes.append((grp[0], grp[-1] + 1, -1 if root else outs[k], seg))
            if root:
                break
            level = outs
    return np.asarray(nodes, np.int64).reshape(-1, 4), parent


def _split_segments(items):
    """(merge_ptr, merge_seg, n_partials) of split segments of `items` items
    each, as `plan_arrays` lays them out: segment ids ascending with gaps
    (the unsplit segments between them), every item slot in a segment."""
    merge_ptr = np.concatenate([[0], np.cumsum(np.asarray(items, np.int64))])
    merge_seg = 3 * np.arange(len(items), dtype=np.int64) + 1
    return merge_ptr, merge_seg, int(merge_ptr[-1])


def _assert_trees_equal(merge_ptr, merge_seg, n_partials):
    from gemnet_pytorch_tpu_torch.data.batch import merge_tree

    got = merge_tree(merge_ptr, merge_seg, n_partials)
    ref = _merge_tree_loop(merge_ptr, merge_seg, n_partials)
    for name, a, b in zip(("nodes", "parent"), got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# md128's id3_reduce_ca plan: 7,920 real edge segments of 2-9 items and the
# padded rows' segment of 8,659 items, the last
_MD128_ID3 = np.concatenate([np.random.default_rng(0).integers(2, 10, 7920), [8659]])
MERGE_CASES = {"no_split": [], "k2": [2], "k16": [16], "k17": [17], "k256": [256],
               "k257": [257], "k4097": [4097], "md128_id3_reduce_ca": _MD128_ID3}


@pytest.mark.parametrize("items", list(MERGE_CASES.values()), ids=list(MERGE_CASES))
def test_merge_tree_matches_the_loop(items):
    """The trees built for all segments at once: the loop's nodes and
    parents, array for array, at the level boundaries (16, 256, 4096 items
    and one past) and at md128's triplet plan."""
    _assert_trees_equal(*_split_segments(items))


@settings(max_examples=100, deadline=None)
@given(st.lists(st.one_of(st.integers(2, 40), st.integers(2, 5000)), max_size=40))
def test_merge_tree_matches_the_loop_drawn(items):
    """Drawn item counts, many small segments beside a few deep trees."""
    _assert_trees_equal(*_split_segments(items))


def test_packer_words_match_the_loops_trees(monkeypatch):
    """A dense triplet batch (a random 48-atom cluster, most edge segments
    split in the 16-row plan): `BatchPacker.pack` gives the same int32
    words with `merge_tree` as with the loop's trees in its place."""
    from gemnet_pytorch_tpu_torch.data import batch as batch_module
    from gemnet_pytorch_tpu_torch.data.containers import Molecule
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker

    rng = np.random.default_rng(3)
    n_atoms = 48
    R = rng.uniform(0.0, 6.0, (n_atoms, 3)).astype(np.float32)
    Z = rng.integers(1, 10, n_atoms).astype(np.int32)
    batch = Molecule(R, Z, cutoff=5.0, int_cutoff=10.0, triplets_only=True).get()
    arrays, _, _ = batch_module.plan_arrays(batch["id3_reduce_ca"], len(batch["id_c"]), 16)
    assert (arrays["merge_seg"] >= 0).sum() > batch["edge_mask"].sum() // 2
    words = BatchPacker().pack(batch)
    monkeypatch.setattr(batch_module, "merge_tree", _merge_tree_loop)
    loop_words = BatchPacker().pack(batch)
    assert words.dtype == loop_words.dtype == np.int32
    np.testing.assert_array_equal(words, loop_words)
