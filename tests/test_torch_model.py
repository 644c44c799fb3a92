"""The PyTorch port's model stack against the JAX package on the CPU: bases,
geometry (padded and collinear rows), masked segment ops, weight transfer,
and GemNet-Q (-dE/dR) and GemNet-dT (direct forces) end to end with weights
carried over by `state_dict_from_jax` and non-unit scale factors."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# the SMALL config of tests/test_model_parity.py
SMALL = dict(
    num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32, emb_size_edge=32,
    emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=16, num_before_skip=1, num_after_skip=1,
    num_concat=1, num_atom=2, cutoff=5.0, int_cutoff=10.0, envelope_exponent=5,
    extensive=True, output_init="HeOrthogonal", activation="swish",
)
VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------- bases

def _basis_inputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.8, 6.0, n).astype(np.float32)  # some beyond the 5 A cutoff
    mask = rng.random(n) > 0.2
    d = np.where(mask, d, 1.0).astype(np.float32)  # padded rows carry the guard d=1
    alpha = rng.uniform(0, np.pi, n).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return d, mask, alpha, theta


def test_bases_match_jax():
    """num_spherical=7, num_radial=6: every basis output within fp32 rounding
    of the JAX package's (sin/cos/pow implementations differ in the last ulps)."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.models import basis as jb
    from gemnet_pytorch_tpu_torch.models import basis as tb

    S, R, c = 7, 6, 5.0
    d, mask, alpha, theta = _basis_inputs()
    jd, jm = jnp.asarray(d), jnp.asarray(mask)

    def close(port, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0))

    rad = tb.RadialBasis(R, c)
    jrad = jb.RadialBasis(R, c)
    close(rad(_t(d)), jrad(jnp.asarray(jrad.init_frequencies()), jd))
    cb, jcb = tb.CircularBasis(S, R, c), jb.CircularBasis(S, R, c)
    close(cb.rbf_env(_t(d), _t(mask)), jcb.rbf_env(jd, jm))
    close(cb.cbf(_t(alpha)), jcb.cbf(jnp.asarray(alpha)))
    sb, jsb = tb.SphericalBasis(S, R, c), jb.SphericalBasis(S, R, c)
    close(sb.rbf_env3(_t(d), _t(mask)), jsb.rbf_env3(jd, jm))
    close(sb.sbf(_t(alpha), _t(theta)), jsb.sbf(jnp.asarray(alpha), jnp.asarray(theta)))
    assert rad.state_dict().keys() == {"frequencies"}  # tables stay out of the state dict
    assert sb.state_dict() == {}


# ---------------------------------------------------------------- geometry

def _grad(f, x):
    x = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(f(x), x, create_graph=True)
    (h,) = torch.autograd.grad((g**2).sum(), x)
    return g.detach().numpy(), h.numpy()


def _jax_grad(f, x):
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    return (np.asarray(jax.grad(f)(x)),
            np.asarray(jax.grad(lambda y: jnp.sum(jax.grad(f)(y) ** 2))(x)))


def test_interatomic_vectors_padded_rows_match_jax():
    """Padded self-edges: finite, equal first and second derivatives
    (tests/test_ops.py::test_interatomic_vectors_grad_finite_on_padding)."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops import geometry as jg
    from gemnet_pytorch_tpu_torch.ops import geometry as tg

    R = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    id_s, id_t = np.array([0, 1, 0, 0]), np.array([1, 2, 0, 0])
    mask = np.array([True, True, False, False])
    w = np.array([1.0, 1.0, 0.0, 0.0], np.float32)

    def f_port(R):
        D, V = tg.interatomic_vectors(R, _t(id_s), _t(id_t), _t(mask))
        return (D * _t(w)).sum() + (V * _t(w)[:, None]).sum()

    def f_jax(R):
        D, V = jg.interatomic_vectors(R, jnp.asarray(id_s), jnp.asarray(id_t), jnp.asarray(mask))
        return jnp.sum(D * w) + jnp.sum(V * w[:, None])

    for port, ref in zip(_grad(f_port, R), _jax_grad(f_jax, R)):
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_neighbor_angles_and_rejection_degenerate_rows_match_jax():
    """Collinear pairs (the |u x v| clamp) and a zero normal (the guarded
    denominator): finite values and gradients equal to the JAX package's."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops import geometry as jg
    from gemnet_pytorch_tpu_torch.ops import geometry as tg

    a = np.array([[1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.5, -0.2, 0.3]], np.float32)
    b = np.array([[2.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    for port_fn, jax_fn in ((tg.neighbor_angles, jg.neighbor_angles),
                            (tg.vector_rejection, jg.vector_rejection)):
        np.testing.assert_allclose(port_fn(_t(a), _t(b)).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-6, atol=1e-6)
        port = _grad(lambda x: (port_fn(x, _t(b)) ** 2).sum(), a)
        ref = _jax_grad(lambda x: jnp.sum(jax_fn(x, jnp.asarray(b)) ** 2), a)
        for p, r in zip(port, ref):
            assert np.isfinite(p).all()
            np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-5)


def test_masked_segment_ops_match_jax():
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops import segment as js
    from gemnet_pytorch_tpu_torch.ops import segment as ts

    rng = np.random.default_rng(1)
    data = rng.normal(size=(50, 3, 2)).astype(np.float32)
    ids = rng.integers(0, 7, 50)
    mask = rng.random(50) > 0.3
    for port_fn, jax_fn in ((ts.masked_segment_sum, js.masked_segment_sum),
                            (ts.masked_segment_mean, js.masked_segment_mean)):
        np.testing.assert_allclose(
            port_fn(_t(data), _t(ids), 9, _t(mask)).numpy(),
            np.asarray(jax_fn(jnp.asarray(data), jnp.asarray(ids), 9, jnp.asarray(mask))),
            rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- model

def _padded_batch(synthetic_npz, triplets_only):
    from gemnet_pytorch_tpu_torch.data import DataContainer, PadDims

    c = DataContainer(synthetic_npz, 5.0, 10.0, triplets_only=triplets_only)
    idx = [0, 1, 2, 3]
    g, Z, *_ = c.build(idx)
    dims = PadDims(
        n_mol=len(idx) + 2, n_atoms=len(Z) + 10, n_edges=g.n_edges + 64,
        n_triplets=g.n_triplets + 64, kmax3=g.kmax3 + 2,
        n_int_edges=0 if triplets_only else g.n_int_edges + 16,
        n_intm=0 if triplets_only else g.n_intm + 32,
        n_quads=0 if triplets_only else g.n_quads + 64,
        kmax4=0 if triplets_only else g.kmax4 + 2,
    )
    return c.get_padded(idx, dims), dict(mol=len(idx), atoms=len(Z))


@pytest.fixture(scope="session", params=list(VARIANTS))
def jax_run(request, synthetic_npz):
    """One JAX model.init per variant: its variables as numpy (with non-unit
    scale factors from a numpy seed) and its E, F on the batch."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model

    variant = VARIANTS[request.param]
    batch, n_real = _padded_batch(synthetic_npz, variant["triplets_only"])
    jcfg = JaxConfig(num_targets=1, **variant, **SMALL)
    model = make_model(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), jbatch))
    rng = np.random.default_rng(11)
    # non-unit scales: a misplaced factor would be invisible at 1.0
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])
    E, F = jax.jit(lambda v, b: energy_and_forces(model, v, b)[:2])(variables, jbatch)
    return dict(name=request.param, variant=variant, batch=batch, n_real=n_real,
                variables=variables, E=np.asarray(E), F=np.asarray(F), jcfg=jcfg)


def _port_model(jax_run):
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    cfg = ModelConfig(num_targets=1, **jax_run["variant"], **SMALL)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_run["variables"], cfg), strict=True)
    return model.requires_grad_(False)


def test_model_matches_jax(jax_run):
    """E within 2e-4 and F within 5e-4 (-dE/dR) / 2e-4 (direct), the
    tolerances of tests/test_model_parity.py."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    E, F = energy_and_forces(_port_model(jax_run), to_torch(jax_run["batch"], "cpu"))
    n = jax_run["n_real"]
    np.testing.assert_allclose(E.numpy()[: n["mol"]], jax_run["E"][: n["mol"]],
                               rtol=2e-4, atol=2e-4)
    f_tol = 2e-4 if jax_run["variant"]["direct_forces"] else 5e-4
    assert F.shape == jax_run["F"].shape
    np.testing.assert_allclose(F.numpy()[: n["atoms"]], jax_run["F"][: n["atoms"]],
                               rtol=f_tol, atol=f_tol)


def test_state_dict_from_jax_matches_export(jax_run):
    """Key for key the reference schema of export_reference_state_dict, less
    its `.linear.` and `seq_energy` aliases, with the same values."""
    from gemnet_pytorch_tpu.compat.torch_export import export_reference_state_dict
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    cfg = ModelConfig(num_targets=1, **jax_run["variant"], **SMALL)
    port = state_dict_from_jax(jax_run["variables"], cfg)
    ref = {k: v for k, v in export_reference_state_dict(jax_run["variables"], jax_run["jcfg"]).items()
           if ".linear." not in k and ".seq_energy." not in k}
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    assert sorted(port) == sorted(_port_model(jax_run).state_dict())


def test_scale_factor_names_and_json(jax_run, tmp_path):
    import json

    from gemnet_pytorch_tpu.models.scaling import scale_names_in_creation_order as jax_names
    from gemnet_pytorch_tpu_torch.models.scaling import (
        load_scales_from_json, scale_names_in_creation_order, scaling_factors)

    def scales_to_dict(model):
        return {name: float(m.scale_factor) for name, m in scaling_factors(model).items()}

    model = _port_model(jax_run)
    names = scale_names_in_creation_order(model.cfg)
    assert names == jax_names(jax_run["jcfg"])
    assert sorted(scales_to_dict(model)) == sorted(names)
    path = tmp_path / "scaling_factors.json"
    path.write_text(json.dumps({n: 0.25 + i for i, n in enumerate(names)}))
    load_scales_from_json(model, str(path))
    assert scales_to_dict(model) == {n: 0.25 + i for i, n in enumerate(names)}


@pytest.mark.parametrize("knob,value", [
    ("compute_dtype", "float16"), ("matmul_precision", "tensorfloat32"), ("ep_axis", "ep"), ("ep_halo", True),
])
def test_unsupported_knobs_raise(knob, value):
    """What the port still refuses: fp16 and TF32. The partitioned modes are
    ported (tests/test_torch_halo.py, tests/test_torch_ep.py): ep_axis alone
    (rung 2a) and ep_halo=True with its axis build a model that raises at
    the forward without its process group, and ep_halo needs its axis."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    cfg = dataclasses.replace(ModelConfig(**SMALL), **{knob: value})
    if knob in ("ep_axis", "ep_halo"):
        if knob == "ep_halo":
            with pytest.raises(ValueError, match="ep_halo needs ep_axis"):
                GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
            cfg = dataclasses.replace(cfg, ep_axis="ep")
        model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match="process group"):
            model({})
        return
    with pytest.raises(NotImplementedError, match=knob):
        GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def test_missing_sort_metadata_raises(synthetic_npz):
    """The sorted gathers need the sort metadata: no plain-gather fallback."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import strip_sort_metadata, to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    batch, _ = _padded_batch(synthetic_npz, False)
    model = GemNet(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(KeyError, match="trip_ba_perm"):
        energy_and_forces(model, to_torch(strip_sort_metadata(batch), "cpu"))
