"""bilinear_implementation in the port: "xla" (the plain versions, asked
for) is bit-equal to "auto" on the CPU, forward, -dE/dR and the loss
gradient, and its census holds only the geometry's K3s, which stay "auto"
as in the JAX package; "xla" is refused on a CUDA device, "pallas" (the
hand-written kernels) on a CPU tensor; an unknown value is refused; and
`ops.bilinear.hadamard` matches the JAX package's within rtol 1e-5."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_remat import WIDTHS, _batch, _loss_grads

torch.set_num_threads(2)


def _model(cfg, implementation):
    from gemnet_pytorch_tpu_torch.models import GemNet

    return GemNet(dataclasses.replace(cfg, bilinear_implementation=implementation),
                  generator=torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_xla_bit_equal_to_auto_on_cpu(triplets_only):
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.perf import roofline

    cfg = ModelConfig(**WIDTHS, triplets_only=triplets_only)
    batch = to_torch(_batch(triplets_only), "cpu")
    out, census = {}, {}
    for impl in ("auto", "xla"):
        model = _model(cfg, impl)
        census[impl] = roofline.kernel_census(lambda: out.__setitem__(
            impl, _loss_grads(model, batch)))
    (E0, F0, g0), (E1, F1, g1) = out["auto"], out["xla"]
    np.testing.assert_array_equal(E1, E0)
    np.testing.assert_array_equal(F1, F0)
    for name in g0:
        np.testing.assert_array_equal(g1[name], g0[name], err_msg=name)
    kernels = collections.Counter(r["kernel"] for r in census["auto"])
    assert kernels["K1"] > 0 and kernels["K2"] > 0 and kernels["K3"] > 0
    # the two geometry gathers of the quadruplet angles, in -dE/dR
    assert collections.Counter(r["kernel"] for r in census["xla"]) == (
        {} if triplets_only else {"K3": 2})


def test_xla_raises_on_cuda_device():
    from gemnet_pytorch_tpu_torch.ops import _cuda

    with pytest.raises(ValueError, match="'xla'"):
        _cuda.use_kernel("xla", torch.device("cuda", 0))
    assert _cuda.use_kernel("auto", torch.device("cuda", 0))
    assert _cuda.use_kernel("pallas", torch.device("cuda", 0))
    assert not _cuda.use_kernel("xla", torch.device("cpu"))


def test_pallas_raises_on_cpu():
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.ops import expand_gather, segment_outer

    cfg = ModelConfig(**WIDTHS, triplets_only=False)
    batch = to_torch(_batch(False), "cpu")
    with pytest.raises(ValueError, match="pallas"):
        energy_and_forces(_model(cfg, "pallas"), batch)
    plan = batch["id4_reduce_ca_plan"]
    ids = batch["id4_reduce_ca"]
    a, b = torch.ones(len(ids), 3), torch.ones(len(ids), 4)
    with pytest.raises(ValueError, match="pallas"):
        segment_outer.segment_outer_sum(a, b, ids, plan, implementation="pallas")
    with pytest.raises(ValueError, match="pallas"):
        segment_outer.gather_contract(torch.ones(3, plan.n_segments, 4), a, b, ids, plan,
                                      implementation="pallas")
    with pytest.raises(ValueError, match="pallas"):
        expand_gather.sorted_segsum_values(torch.ones(len(ids), 4), batch["quad_abd_perm"],
                                           batch["quad_abd_sorted"], batch["quad_abd_plan"],
                                           implementation="pallas")
    with pytest.raises(ValueError, match="one of"):
        _model(dataclasses.replace(cfg, bilinear_implementation="triton"), "triton")


def test_hadamard_matches_jax():
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.bilinear import hadamard as jax_hadamard
    from gemnet_pytorch_tpu_torch.data.batch import segment_plan
    from gemnet_pytorch_tpu_torch.ops.bilinear import hadamard

    rng = np.random.default_rng(0)
    n_edges, S, emb, interm, n_rows = 12, 5, 6, 4, 18
    id_reduce = np.sort(rng.integers(0, n_edges, size=n_rows))
    rbf_W1 = rng.normal(size=(n_edges, interm, S)).astype(np.float32)
    sph_rows = rng.normal(size=(n_rows, S)).astype(np.float32)
    m = rng.normal(size=(n_rows, emb)).astype(np.float32)
    weight = rng.normal(size=(emb, 1, interm)).astype(np.float32)
    mask = rng.random(n_rows) > 0.2
    splits = np.searchsorted(id_reduce, np.arange(0, n_edges + 32, 32)).astype(np.int32)
    ref = np.asarray(jax_hadamard(jnp.asarray(rbf_W1), jnp.asarray(sph_rows), jnp.asarray(m),
                                  jnp.asarray(id_reduce), jnp.asarray(splits),
                                  jnp.asarray(weight), mask=jnp.asarray(mask),
                                  implementation="xla"))
    ids = torch.from_numpy(id_reduce)
    for impl in ("auto", "xla"):
        y = hadamard(torch.from_numpy(rbf_W1), torch.from_numpy(sph_rows), torch.from_numpy(m),
                     ids, segment_plan(id_reduce, n_edges, 16, "cpu"),
                     torch.from_numpy(weight), mask=torch.from_numpy(mask),
                     implementation=impl)
        assert y.shape == (n_edges, emb)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
