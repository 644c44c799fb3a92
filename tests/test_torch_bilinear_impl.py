"""The kernels or their plain versions in the port: the tensor's device alone
picks them (`ops._cuda.use_kernel`: the kernel on a CUDA device, the plain
version on the CPU, any other device refused), and `ops.bilinear.hadamard`
matches the JAX package's within rtol 1e-5."""

import numpy as np
import pytest
import torch


def test_use_kernel_follows_the_device():
    from gemnet_pytorch_tpu_torch.ops import _cuda

    assert _cuda.use_kernel(torch.device("cuda", 0))
    assert not _cuda.use_kernel(torch.device("cpu"))
    with pytest.raises(ValueError, match="meta"):
        _cuda.use_kernel(torch.device("meta"))


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
    y = hadamard(torch.from_numpy(rbf_W1), torch.from_numpy(sph_rows), torch.from_numpy(m),
                 torch.from_numpy(id_reduce), segment_plan(id_reduce, n_edges, 16, "cpu"),
                 torch.from_numpy(weight), mask=torch.from_numpy(mask))
    assert y.shape == (n_edges, emb)
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
