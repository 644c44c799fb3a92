"""The row-gather probe kernels P1/P2 (`ops/row_gather.py`) on the CPU, where
their plain versions run: bit for bit against `jnp.take` (the JAX probe's
gather) and `table[idx]`, at the probe's shape and small ones; the
wrappers' input checks; and the probe driver's inputs and bound."""

import numpy as np
import pytest
import torch

from gemnet_pytorch_tpu_torch.scripts import gather_probe

SHAPES = [(gather_probe.N_TAB, gather_probe.M, gather_probe.R), (100, 8, 1000), (7, 64, 33)]


def _inputs(N, M, R, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)).bfloat16()
    idx = torch.from_numpy(rng.integers(0, N, R).astype(np.int32))
    return table, idx


@pytest.mark.parametrize("N,M,R", SHAPES)
def test_gather_rows_matches_jax_take(N, M, R):
    import jax.numpy as jnp

    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops import row_gather as rg

    table, idx = _inputs(N, M, R)
    jtable = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jnp.take(jtable, jnp.asarray(idx.numpy()), axis=0)).view(np.uint16)
    _cuda.reset_launches()
    out = rg.gather_rows(table, idx)
    out_fm = rg.gather_rows_fm(table.t().contiguous(), idx)
    assert _cuda.LAUNCHES == {}  # a CPU tensor never reaches the kernels
    assert out.dtype == out_fm.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy().view(np.uint16), ref)
    np.testing.assert_array_equal(out_fm.t().contiguous().view(torch.int16).numpy().view(np.uint16),
                                  ref)
    assert torch.equal(out, table[idx.long()])
    assert torch.equal(out_fm, table.t()[:, idx.long()])


@pytest.mark.parametrize("bad", ["fp32 table", "int64 idx", "1-D table", "2-D idx"])
def test_row_gather_input_checks(bad):
    from gemnet_pytorch_tpu_torch.ops import row_gather as rg

    table, idx = _inputs(10, 8, 20)
    table, idx = {"fp32 table": (table.float(), idx), "int64 idx": (table, idx.long()),
                  "1-D table": (table[:, 0].contiguous(), idx),
                  "2-D idx": (table, idx.reshape(4, 5))}[bad]
    for fn in (rg.gather_rows, rg.gather_rows_fm):
        with pytest.raises(TypeError):
            fn(table, idx)


def test_gather_probe_inputs_and_bound():
    """The bench quad shape of the JAX probe (scripts/gather_probe.py:34-41):
    a (29184, 32) bf16 table from seed 0, 192512 int32 indices; the bound
    is the 15.0 MB it must move (indices and table read once, result written
    once) over 3.35 TB/s; without a card it refuses."""
    import jax.numpy as jnp

    table, tableT, idx = gather_probe.inputs("cpu")
    assert table.shape == (29184, 32) and table.dtype == torch.bfloat16
    assert torch.equal(tableT, table.t())
    assert idx.shape == (192512,) and idx.dtype == torch.int32
    rng = np.random.default_rng(0)  # the JAX probe's draws, in its order
    ref = jnp.asarray(rng.standard_normal((29184, 32)).astype(np.float32)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(table.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(ref).view(np.uint16))
    np.testing.assert_array_equal(idx.numpy(), rng.integers(0, 29184, 192512).astype(np.int32))
    assert gather_probe.bound_ms() == pytest.approx(
        ((4 + 2 * 32) * 192512 + 2 * 29184 * 32) / 3.35e12 * 1e3)
    assert 0.00446 < gather_probe.bound_ms() < 0.00447
    with pytest.raises(RuntimeError):
        gather_probe.main("cpu")
