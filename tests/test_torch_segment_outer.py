"""The port's segment_outer_sum (K1) and segment_gather_contract (K2) on the
CPU (their plain versions) against the JAX package: the XLA contract and the
Pallas kernels in interpret mode, in value, first-order VJP and grad-of-grad,
on the `_make_case` inputs of tests/test_segment_outer.py."""

import numpy as np
import pytest
import torch

from test_segment_outer import _make_case

torch.set_num_threads(2)


def _torch_case(a, b, ids, n_segments):
    from gemnet_pytorch_tpu_torch.data import segment_plan

    return (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ids.astype(np.int64)),
            segment_plan(ids, n_segments, 128, "cpu"))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_outer_sum_matches_jax(rng, impl):
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas import segment_outer as so
    from gemnet_pytorch_tpu_torch.ops import _cuda
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_outer_sum

    a, b, ids, splits, E = _make_case(rng)
    ja, jb, jids, jsp = map(jnp.asarray, (a, b, ids, splits))
    if impl == "xla":
        ref = so.segment_outer_sum(ja, jb, jids, jsp, E, "xla")
        tol = 1e-5  # same fp32 products, another summation order
    else:
        ref = so._outer_sum_pallas(ja, jb, jids, jsp, E, interpret=True)
        tol = 1e-4  # the JAX package's own Pallas-vs-XLA tolerance
    _cuda.reset_launches()
    out = segment_outer_sum(*_torch_case(a, b, ids, E))
    assert _cuda.LAUNCHES == {}  # a CPU tensor never reaches the kernel
    assert out.shape == (a.shape[1], E, b.shape[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_gather_contract_matches_jax(rng, impl):
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas import segment_outer as so
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_gather_contract

    a, b, ids, splits, E = _make_case(rng)
    cot = rng.normal(size=(a.shape[1], E, b.shape[1])).astype(np.float32)
    ja, jb, jids, jsp, jcot = map(jnp.asarray, (a, b, ids, splits, cot))
    if impl == "xla":
        ref = so.segment_gather_contract(jcot, ja, jb, jids, jsp, "xla")
        tol = 1e-5
    else:
        ref = so._gather_contract_pallas(jcot, ja, jb, jids, jsp, interpret=True)
        tol = 1e-4
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    da, db = segment_gather_contract(torch.from_numpy(cot), ta, tb, tids, plan)
    np.testing.assert_allclose(da.numpy(), np.asarray(ref[0]), rtol=tol, atol=tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref[1]), rtol=tol, atol=tol)


def test_outer_sum_vjp_matches_jax_grad(rng):
    """First order: d/d(a, b) of sum(out * w) through the autograd pair
    (backward = K2) equals jax.grad of the JAX custom VJP."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas.segment_outer import segment_outer_sum as jax_sos
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_outer_sum

    a, b, ids, splits, E = _make_case(rng, n_rows=300, pad_to=512, n_segments=64)
    w = rng.normal(size=(a.shape[1], E, b.shape[1])).astype(np.float32)
    jids, jsp, jw = jnp.asarray(ids), jnp.asarray(splits), jnp.asarray(w)
    ref = jax.grad(lambda a, b: jnp.sum(jax_sos(a, b, jids, jsp, E, "xla") * jw),
                   argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))

    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    ta.requires_grad_(True)
    tb.requires_grad_(True)
    loss = (segment_outer_sum(ta, tb, tids, plan) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, (ta, tb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_gather_contract_vjp_matches_jax_grad(rng):
    """First order of K2 itself (backward = K1 twice + K2): gradients of
    sum(da * u) + sum(db * v) w.r.t. cot, a and b."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas.segment_outer import segment_gather_contract as jax_sgc
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_gather_contract

    a, b, ids, splits, E = _make_case(rng, n_rows=300, pad_to=512, n_segments=64, S=5, M=8)
    cot = rng.normal(size=(a.shape[1], E, b.shape[1])).astype(np.float32)
    u = rng.normal(size=a.shape).astype(np.float32)
    v = rng.normal(size=b.shape).astype(np.float32)
    jids, jsp = jnp.asarray(ids), jnp.asarray(splits)

    def f(cot, a, b):
        da, db = jax_sgc(cot, a, b, jids, jsp, "xla")
        return jnp.sum(da * u) + jnp.sum(db * v)

    ref = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(cot), jnp.asarray(a), jnp.asarray(b))
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    tcot = torch.from_numpy(cot).requires_grad_(True)
    ta.requires_grad_(True)
    tb.requires_grad_(True)
    da, db = segment_gather_contract(tcot, ta, tb, tids, plan)
    loss = (da * torch.from_numpy(u)).sum() + (db * torch.from_numpy(v)).sum()
    got = torch.autograd.grad(loss, (tcot, ta, tb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_grad_of_grad_matches_jax(rng):
    """Second order through the autograd pair (the force-training path), as
    tests/test_segment_outer.py::test_second_order_differentiation."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas.segment_outer import segment_outer_sum as jax_sos
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_outer_sum

    a, b, ids, splits, E = _make_case(rng, n_rows=100, pad_to=128, n_segments=32, S=3, M=4)
    jb, jids, jsp = jnp.asarray(b), jnp.asarray(ids), jnp.asarray(splits)

    def loss_jax(a):
        g = jax.grad(lambda a2: jnp.sum(jax_sos(a2, jb, jids, jsp, E, "xla") ** 2))(a)
        return jnp.sum(g**2)

    ref = jax.grad(loss_jax)(jnp.asarray(a))
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    ta.requires_grad_(True)
    (g,) = torch.autograd.grad((segment_outer_sum(ta, tb, tids, plan) ** 2).sum(), ta,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), ta)
    np.testing.assert_allclose(gg.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("op", ["outer_sum", "gather_contract"])
def test_non_float32_inputs_raise(rng, op):
    """fp32 and bf16 streams only (tests/test_torch_bf16.py holds bf16): a
    float16 stream raises instead of running."""
    from gemnet_pytorch_tpu_torch.ops.segment_outer import (
        segment_gather_contract, segment_outer_sum)

    a, b, ids, splits, E = _make_case(rng, n_rows=50, pad_to=64, n_segments=16, S=2, M=4)
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    with pytest.raises(TypeError):
        if op == "outer_sum":
            segment_outer_sum(ta.half(), tb, tids, plan)
        else:
            segment_gather_contract(torch.zeros(2, E, 4), ta, tb.half(), tids, plan)
