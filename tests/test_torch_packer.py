"""`data.packer.BatchPacker`, the counterpart of the JAX package's
`BatchPacker` (trainer.py:56-153), on the CPU: `unpack(pack(b))` equals
`to_torch(b)` key for key and bit for bit, the capacity plans' fields
included; the layout's key order is the JAX packer's on the same batch;
the version is bumped when the pad dims grow; `zero_masks` clears the mask
keys as JAX's does; and the provider packs in its prefetch threads."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train import _provider

torch.set_num_threads(2)


def _batch(npz, triplets_only=False):
    return next(_provider(npz, triplets_only, False).get_dataset("train", prefetch_workers=0))


def _assert_equal_batches(got, ref):
    from gemnet_pytorch_tpu_torch.data.batch import SegmentPlan

    for key, r in ref.items():
        g = got[key]
        if isinstance(r, SegmentPlan):
            for field in SegmentPlan._fields:
                a, b = getattr(g, field), getattr(r, field)
                if isinstance(b, torch.Tensor):
                    assert a.dtype == b.dtype and a.shape == b.shape, (key, field)
                    assert torch.equal(a, b), (key, field)
                else:
                    assert a == b, (key, field)
        else:
            assert g.dtype == r.dtype and g.shape == r.shape, key
            assert torch.equal(g, r), key


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_unpack_of_pack_equals_to_torch(synthetic_npz, triplets_only):
    """Every key to_torch gives the model, at its dtype, bit for bit, and
    every field of the six (or two) capacity plans; the tensors are views
    of the one buffer."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.data.packer import UNUSED_DEVICE_KEYS, BatchPacker

    batch = _batch(synthetic_npz, triplets_only)
    packer = BatchPacker()
    row = packer.pack(batch)
    assert row.dtype == np.int32 and row.shape == (packer.total,)
    words = torch.from_numpy(row)
    got = packer.unpack(words)
    ref = to_torch(batch, "cpu")
    assert set(got) == set(ref) - UNUSED_DEVICE_KEYS
    _assert_equal_batches(got, {k: v for k, v in ref.items() if k not in UNUSED_DEVICE_KEYS})
    base = words.untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in got.values()
               if isinstance(v, torch.Tensor))
    assert got["trip_ba_plan"].items.untyped_storage().data_ptr() == base


def test_key_order_matches_the_jax_packer(synthetic_npz):
    """The batch's keys lie in the JAX packer's order (sorted, the unused
    keys skipped), the edges' derived sort metadata and the plans' arrays
    after them; every key aligned as the caching allocator aligns a tensor."""
    from gemnet_pytorch_tpu.training.trainer import BatchPacker as JaxPacker
    from gemnet_pytorch_tpu.training.trainer import UNUSED_DEVICE_KEYS as JAX_UNUSED
    from gemnet_pytorch_tpu_torch.data.batch import EDGE_SORT_KEYS, PLAN_ARRAYS, SEGMENT_PLANS
    from gemnet_pytorch_tpu_torch.data.packer import ALIGN, UNUSED_DEVICE_KEYS, BatchPacker

    assert UNUSED_DEVICE_KEYS == JAX_UNUSED
    batch = _batch(synthetic_npz)
    jax_packer, packer = JaxPacker(), BatchPacker()
    jax_packer.pack(batch)
    packer.pack(batch)
    keys = [k for k, *_ in packer.layout]
    assert ALIGN % 16 == 0  # the kernels' 16-byte loads of the plans' items
    n = len(jax_packer.layout)
    assert keys[:n] == [k for k, *_ in jax_packer.layout]
    assert keys[n:] == list(EDGE_SORT_KEYS) + [f"{p}.{a}" for p in SEGMENT_PLANS
                                               for a in PLAN_ARRAYS]
    assert all(off % ALIGN == 0 for _, off, *_ in packer.layout)


def test_version_bumps_when_the_pad_dims_grow(synthetic_npz):
    """A batch of larger pad dims re-freezes the layout (version 1), its
    row unpacks to its own to_torch, and the first shape again bumps it."""
    from gemnet_pytorch_tpu_torch.data import pad_batch, to_torch
    from gemnet_pytorch_tpu_torch.data.packer import UNUSED_DEVICE_KEYS, BatchPacker

    provider = _provider(synthetic_npz, False, False)
    batch = _batch(synthetic_npz)
    packer = BatchPacker()
    first = packer.pack(batch)
    assert packer.version == 0
    packer.pack(batch)
    assert packer.version == 0
    grown = dataclasses.replace(provider.pad_dims, n_triplets=2 * provider.pad_dims.n_triplets,
                                n_quads=2 * provider.pad_dims.n_quads)
    g, Z, R, E, F = provider.data_container.build(np.arange(4))
    big = pad_batch(g, Z, R, grown, E=E, F=F)
    row = packer.pack(big)
    assert packer.version == 1 and row.shape != first.shape
    ref = {k: v for k, v in to_torch(big, "cpu").items() if k not in UNUSED_DEVICE_KEYS}
    _assert_equal_batches(packer.unpack(torch.from_numpy(row)), ref)
    packer.pack(batch)
    assert packer.version == 2


def test_zero_masks_matches_jax(synthetic_npz):
    """zero_masks: the mask keys all False, as JAX's unpack reads them from
    its own zero_masks; every other key as packed."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.training.trainer import BatchPacker as JaxPacker
    from gemnet_pytorch_tpu_torch.data.packer import MASK_KEYS, BatchPacker

    batch = _batch(synthetic_npz)
    jax_packer, packer = JaxPacker(), BatchPacker()
    jax_zero = jax_packer.unpack(jnp.asarray(jax_packer.zero_masks(jax_packer.pack(batch))))
    row = packer.pack(batch)
    zero = packer.unpack(torch.from_numpy(packer.zero_masks(row)))
    full = packer.unpack(torch.from_numpy(row))
    for key in MASK_KEYS:
        np.testing.assert_array_equal(zero[key].numpy(), np.asarray(jax_zero[key]))
        assert not zero[key].any() and full[key].any()
    for key, value in full.items():
        if key not in MASK_KEYS and isinstance(value, torch.Tensor):
            assert torch.equal(zero[key], value), key


def test_provider_packs_in_its_prefetch_threads(synthetic_npz):
    """get_dataset(transform=packer.pack): the rows of the prefetching
    iterator equal the packed batches of the plain one."""
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker

    packer = BatchPacker()
    provider = _provider(synthetic_npz, False, False)
    plain = provider.get_dataset("train", prefetch_workers=0)
    packed = provider.get_dataset("train", prefetch_workers=2, transform=packer.pack)
    try:
        for _ in range(3):
            np.testing.assert_array_equal(next(packed), packer.pack(next(plain)))
    finally:
        packed.close()
