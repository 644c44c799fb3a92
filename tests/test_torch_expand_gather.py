"""The port's expand_gather and sorted segment sum (K3) on the CPU (the plain
version) against the JAX package's `expand_gather`, under its XLA path and
its Pallas kernel in interpret mode: value, first derivative and
grad-of-grad, at row widths 3, 4, 32 and 64."""

import numpy as np
import pytest
import torch

from gemnet_pytorch_tpu.ops.pallas import expand_gather as eg

torch.set_num_threads(2)


def _case(n_src, M, n_rows=3000, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n_src - 1, n_rows).astype(np.int32)
    idx[-400:] = 0  # padded rows point at row 0 of their source
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    table = rng.standard_normal((n_src, M)).astype(np.float32)
    cot = rng.standard_normal((n_rows, M)).astype(np.float32)
    return table, idx, perm, idx[perm], cot


def _port_args(idx, perm, srt, n_src):
    from gemnet_pytorch_tpu_torch.data import segment_plan

    return (torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(perm),
            torch.from_numpy(srt), segment_plan(srt, n_src, 32, "cpu"))


def _use_jax_impl(monkeypatch, impl):
    """tests/test_expand_gather.py's pattern: force the JAX package onto its
    XLA path or its Pallas kernel (interpret mode on the CPU)."""
    if impl == "pallas":
        orig = eg._segsum_pallas
        monkeypatch.setattr(eg, "_segsum_pallas",
                            lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        monkeypatch.setattr(eg, "_use_pallas", lambda _: True)
    else:
        monkeypatch.setattr(eg, "_use_pallas", lambda _: False)


# n_src 1000 is no multiple of 128; the JAX package's Pallas kernel takes only
# multiples of 128 (it falls back to XLA otherwise), so its case uses 1024
@pytest.mark.parametrize("M", [3, 4, 32, 64])
@pytest.mark.parametrize("impl,n_src", [("xla", 1000), ("pallas", 1024)])
def test_expand_gather_matches_jax(monkeypatch, impl, n_src, M):
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu_torch.ops.expand_gather import expand_gather

    _use_jax_impl(monkeypatch, impl)
    table, idx, perm, srt, cot = _case(n_src, M, seed=M)
    jargs = tuple(map(jnp.asarray, (idx, perm, srt)))
    jcot = jnp.asarray(cot)

    def f_jax(t):  # second derivative is non-zero: the output enters squared
        return jnp.sum(eg.expand_gather(t, *jargs, n_src, impl) ** 2 * jcot)

    g_ref = jax.grad(f_jax)(jnp.asarray(table))
    h_ref = jax.grad(lambda t: jnp.sum(jax.grad(f_jax)(t) ** 2))(jnp.asarray(table))

    targs = _port_args(idx, perm, srt, n_src)
    tt = torch.from_numpy(table).requires_grad_(True)
    out = expand_gather(tt, *targs)
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    (g,) = torch.autograd.grad((out**2 * torch.from_numpy(cot)).sum(), tt, create_graph=True)
    (h,) = torch.autograd.grad((g**2).sum(), tt)
    # fp32 sums of the same terms in another order (the JAX tolerances)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=3e-5, atol=3e-4)


@pytest.mark.parametrize("M", [3, 24])
def test_sorted_segsum_matches_jax_kernel(M):
    """The plain K3 against the Pallas kernel (interpret) and the XLA contract."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu_torch.ops.expand_gather import sorted_segsum

    table, idx, perm, srt, cot = _case(1536, M, n_rows=6000, seed=7)
    xp = jnp.asarray(cot)[perm]
    ref_pallas = np.asarray(eg._segsum_pallas(xp, jnp.asarray(srt), 1536, interpret=True))
    ref_xla = np.asarray(eg._segsum_xla(xp, jnp.asarray(srt), 1536))
    tidx, tperm, tsrt, plan = _port_args(idx, perm, srt, 1536)
    out = sorted_segsum(torch.from_numpy(cot), tperm, tsrt, plan, tidx).numpy()
    np.testing.assert_allclose(out, ref_xla, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, ref_pallas, rtol=2e-5, atol=2e-5)


def test_sorted_segsum_grad_is_expand_gather():
    """SortedSegsum's VJP is ExpandGather: d/dx sum(segsum(x) * w) = w[idx]."""
    from gemnet_pytorch_tpu_torch.ops.expand_gather import sorted_segsum

    table, idx, perm, srt, cot = _case(700, 4, n_rows=2000, seed=3)
    tidx, tperm, tsrt, plan = _port_args(idx, perm, srt, 700)
    x = torch.from_numpy(cot).requires_grad_(True)
    (g,) = torch.autograd.grad((sorted_segsum(x, tperm, tsrt, plan, tidx)
                                * torch.from_numpy(table)).sum(), x)
    np.testing.assert_array_equal(g.numpy(), table[idx])
