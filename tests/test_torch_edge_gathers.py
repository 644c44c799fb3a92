"""The gathers of atom rows to edge rows and of edge rows to triplet rows,
whose backwards run as the sorted segment sum K3 (and x[id_swap]'s as the
swap itself), against the plain gathers they replace, on the CPU:

- the triplet angles from the edges' R[c] - R[a] equal those from the atom
  gathers bit for bit on the real rows, GemNet-T and -Q molecule batches;
- E, -dE/dR and the parameter gradients of a loss on them (grad-of-grad)
  within fp32 summation-order tolerance of the model with every gather
  plain, and every site on the sorted route in a single-device step;
- id_c[id_swap] == id_a and id_swap an involution on molecule and periodic
  batches, so one argsort serves both edge columns; a batch whose reverse
  edges are not at id_swap, or whose id_swap is no involution, is refused;
- the table of sorted gathers (`data.batch.SORTED_GATHERS`): a single-device
  GemNet-T or -Q batch gives every site of its columns with the batch's own
  arrays, a halo or ep shard none, `strip_sort_metadata` drops exactly the
  table's sort keys, and the key lists derived from it keep their order.

The halo and ep models on their shards (plain gathers) are checked in
tests/test_torch_halo.py and tests/test_torch_ep.py."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_remat import WIDTHS, _batch, _loss_grads

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _periodic_batch():
    """Three small OC20-like slabs (the oc20slab32 mix at its smallest), padded."""
    from benchmark import workload_slab
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider
    from gemnet_pytorch_tpu_torch.data.padding import pad_batch

    with open(os.path.join(ROOT, "benchmark/configs/gemnet-dt-oc20.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "benchmark/traffic/oc20slab32.json")) as f:
        mix = {**json.load(f), "pool": 3, "surface": [2, 3], "layers": [2, 3],
               "adsorbate": [1, 3]}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pool.npz")
        np.savez(path, **workload_slab.pool(mix))
        cont = DataContainer(path, cfg["cutoff"], cfg["int_cutoff"], True,
                             max_neighbors=cfg["max_neighbors"])
    dims = DataProvider(cont, 3, 0, 3, seed=0, shuffle=False).pad_dims
    g, Z, R, E, F = cont.build([0, 1, 2])
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=True)


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_triplet_angles_equal_the_atom_gathers(triplets_only):
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.data.batch import gather_sorts
    from gemnet_pytorch_tpu_torch.ops import geometry

    b = to_torch(_batch(triplets_only), "cpu")
    R, id_c, id_a = b["R"], b["id_c"], b["id_a"]
    ca, ba = b["id3_reduce_ca"], b["id3_expand_ba"]
    sorts = gather_sorts(b)
    got = geometry.triplet_angles(
        geometry.edge_vectors(R, id_c, id_a, (sorts["id_c"], sorts["id_a"])), ca, ba,
        sorts["id3_reduce_ca"], sorts["id3_expand_ba"])
    Ra = R[id_a[ca]]
    ref = geometry.neighbor_angles(R[id_c[ca]] - Ra, R[id_c[ba]] - Ra)
    real = b["trip_mask"]
    assert real.sum() > 0 and (~real).sum() > 0
    np.testing.assert_array_equal(got[real].numpy(), ref[real].numpy())
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_sorted_gathers_match_plain_gathers(triplets_only, monkeypatch):
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, interaction, layers
    from gemnet_pytorch_tpu_torch.ops import geometry
    from gemnet_pytorch_tpu_torch.perf import spans

    cfg = ModelConfig(**WIDTHS, triplets_only=triplets_only, direct_forces=False)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    batch = to_torch(_batch(triplets_only), "cpu")
    before = spans.counters()
    E, F, grads = _loss_grads(model, batch)
    after = spans.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0) for k in ("gather.sorted", "gather.plain")}
    # per forward: the edges' 2 + the triplet geometry's 4 + the embedding's
    # 2, and per block the triplet gather, the concat layer's 2 and the
    # swap(s); GemNet-Q adds the quadruplet geometry's 2 and per block 2,
    # and its interaction edges' R gathers stay plain
    per_block = 4 if triplets_only else 7
    assert counted == {"gather.sorted": 8 + (0 if triplets_only else 2)
                       + per_block * cfg.num_blocks,
                       "gather.plain": 0 if triplets_only else 2}

    def plain(x, idx, sort=None):
        return x[idx]

    for module in (geometry, layers, interaction):
        monkeypatch.setattr(module, "gather", plain)
    monkeypatch.setattr(interaction, "swap_rows", lambda x, swap: x[swap])
    E0, F0, grads0 = _loss_grads(model, batch)
    np.testing.assert_allclose(E, E0, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(F, F0, rtol=1e-5, atol=1e-6 * np.abs(F0).max())
    for name, g in grads0.items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-5, atol=1e-6 * np.abs(g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["molecule", "periodic"])
def test_one_sort_serves_both_edge_columns(kind):
    from gemnet_pytorch_tpu_torch.data.batch import edge_sort_metadata

    b = _batch(True) if kind == "molecule" else _periodic_batch()
    id_c, id_a, swap = (b[k].astype(np.int64) for k in ("id_c", "id_a", "id_swap"))
    np.testing.assert_array_equal(swap[swap], np.arange(len(swap)))
    np.testing.assert_array_equal(id_c[swap], id_a)
    meta = edge_sort_metadata(b)
    np.testing.assert_array_equal(meta["edge_c_perm"], swap[meta["edge_a_perm"]])
    np.testing.assert_array_equal(id_c[meta["edge_c_perm"]], meta["edge_sorted"])
    np.testing.assert_array_equal(id_a[meta["edge_a_perm"]], meta["edge_sorted"])
    assert np.all(np.diff(meta["edge_sorted"]) >= 0)


def test_edge_sort_refusals():
    from gemnet_pytorch_tpu_torch.data.batch import edge_sort_metadata

    b = _batch(True)
    n = int(b["edge_mask"].sum())
    # the reverse edges reordered: id_c[id_swap] != id_a
    moved = {k: b[k].astype(np.int64) for k in ("id_c", "id_a", "id_swap")}
    order = np.arange(len(moved["id_c"]))
    order[n // 2:n] = order[n // 2:n][::-1]
    moved["id_c"], moved["id_a"] = moved["id_c"][order], moved["id_a"][order]
    assert not np.array_equal(moved["id_c"][moved["id_swap"]], moved["id_a"])
    with pytest.raises(ValueError, match="reverse"):
        edge_sort_metadata(moved)
    # an id_swap that is no involution
    cycle = dict(moved, id_swap=np.roll(moved["id_swap"], 1))
    with pytest.raises(ValueError, match="involution"):
        edge_sort_metadata(cycle)


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_single_device_batch_gives_every_site(triplets_only):
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.data.batch import SORTED_GATHERS, gather_sorts

    b = to_torch(_batch(triplets_only), "cpu")
    sorts = gather_sorts(b)
    columns = ["id3_reduce_ca", "id3_expand_ba", "id_a", "id_c"] + (
        [] if triplets_only else ["id4_expand_intm_db", "id4_expand_abd", "id4_reduce_cab"])
    assert sorted(sorts) == sorted(columns)
    for column, (perm, ids, plan) in sorts.items():
        keys = SORTED_GATHERS[column]
        assert perm is (None if keys[0] is None else b[keys[0]]), column
        assert ids is b[keys[1]] and plan is b[keys[2]], column
        # the sorted ids are the column in the perm's order
        order = torch.arange(len(ids)) if perm is None else perm.long()
        np.testing.assert_array_equal(b[column][order].numpy(), ids.numpy(), err_msg=column)
    assert sorts["id3_reduce_ca"][0] is None


@pytest.mark.parametrize("kind", ["halo", "ep"])
def test_shards_give_no_sites(kind):
    from gemnet_pytorch_tpu_torch.data import build_graph, to_torch
    from gemnet_pytorch_tpu_torch.data.batch import gather_sorts, sort_keys
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule
    from gemnet_pytorch_tpu_torch.parallel import ep, halo

    if kind == "halo":
        Z, R = random_molecule(np.random.default_rng(0), 8)
        g = build_graph(R, np.array([8]), 5.0, 10.0, triplets_only=False)
        part = halo.build_halo_partition(g, Z, R, 2, n_mol_pad=1, n_atoms_pad=16)
        shard = to_torch(halo.local_halo_batch(part, 1), "cpu")
    else:
        shard = to_torch(ep.local_ep_batch(ep.partition_batch(_batch(False), 2), 1), "cpu")
    assert "id3_expand_ba" in shard and "id4_expand_abd" in shard
    assert gather_sorts(shard) == {}
    # the only table keys left: the ascending reduce column and its plan
    assert set(sort_keys(shard)) & set(shard) == {"id3_reduce_ca", "id3_reduce_ca_plan"}


def test_strip_removes_exactly_the_table_keys():
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.data.batch import (
        EDGE_SORT_KEYS, INT32_KEYS, SORT_META_KEYS, SORTED_GATHERS, strip_sort_metadata)

    assert SORT_META_KEYS == ("trip_ba_perm", "trip_ba_sorted", "intm_db_perm",
                              "intm_db_sorted", "quad_abd_perm", "quad_abd_sorted",
                              "quad_cab_perm", "quad_cab_sorted")
    assert EDGE_SORT_KEYS == ("edge_a_perm", "edge_c_perm", "edge_sorted")
    assert INT32_KEYS == frozenset(SORT_META_KEYS + EDGE_SORT_KEYS)
    b = to_torch(_batch(False), "cpu")
    sorted_keys = {k for perm, ids, plan in SORTED_GATHERS.values() if perm is not None
                   for k in (perm, ids, plan)}
    assert sorted_keys <= set(b)
    stripped = strip_sort_metadata(dict(b))
    assert set(b) - set(stripped) == sorted_keys
    assert set(SORT_META_KEYS + EDGE_SORT_KEYS) < sorted_keys
