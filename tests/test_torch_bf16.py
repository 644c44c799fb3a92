"""The PyTorch port's bf16 mode (ModelConfig.compute_dtype="bfloat16") on
the CPU: the plain versions of K1, K2, K3 on bf16 streams against the JAX
package's XLA contract in bf16, the dtypes of every output and cotangent
through grad-of-grad, the bf16 layers, and GemNet-Q in bf16 against the JAX
package's bf16 model and against fp32 at tests/test_bf16.py's tolerances,
with a bf16 train step whose parameters, gradients and optimizer state stay
fp32."""

import numpy as np
import pytest
import torch

from test_segment_outer import _make_case

torch.set_num_threads(2)

BF16 = torch.bfloat16
# kernel output vs the JAX contract: both sum in fp32, in other orders, and
# round once to bf16, so they may differ by one bf16 ulp (2^-7 relative at
# most) of the output's magnitude
ULP_REL = 2.0**-7
# tests/test_bf16.py's widths and its bf16-vs-fp32 contract
TINY = dict(
    num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16, emb_size_edge=16,
    emb_size_trip=8, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=8, direct_forces=False,
)
E_REL, F_REL = 0.03, 0.05
# port bf16 vs JAX bf16 E and F, share of the magnitude (see the model test)
PORT_VS_JAX_BF16 = (0.006, 0.010)


def _to_bf16_np(x):
    """float32 numpy rounded to bf16 values (kept as float32 numpy)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(BF16).float().numpy()


def _close_ulp(port, ref):
    port = port.float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= ULP_REL * np.abs(ref).max()


# ---------------------------------------------------------------- kernels' plain versions

def _segment_case(rng, **kw):
    from gemnet_pytorch_tpu_torch.data import segment_plan

    a, b, ids, splits, E = _make_case(rng, **kw)
    a, b = _to_bf16_np(a), _to_bf16_np(b)
    port = (torch.from_numpy(a).to(BF16), torch.from_numpy(b).to(BF16),
            torch.from_numpy(ids.astype(np.int64)), segment_plan(ids, E, 128, "cpu"))
    return a, b, ids, splits, E, port


def test_outer_sum_bf16_matches_jax(rng):
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas import segment_outer as so
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_outer_sum

    a, b, ids, splits, E, port = _segment_case(rng)
    ref = so.segment_outer_sum(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                               jnp.asarray(ids), jnp.asarray(splits), E, "xla")
    out = segment_outer_sum(*port)
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close_ulp(out, np.asarray(ref.astype(jnp.float32)))


def test_gather_contract_bf16_matches_jax(rng):
    """bf16 streams and a bf16 cotangent (as the bilinear's sum_k cast gives
    it): the XLA contract computes in bf16 products summed in fp32."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas import segment_outer as so
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_gather_contract

    a, b, ids, splits, E, port = _segment_case(rng)
    cot = _to_bf16_np(rng.normal(size=(a.shape[1], E, b.shape[1])))
    bf = jnp.bfloat16
    ref = so.segment_gather_contract(jnp.asarray(cot, bf), jnp.asarray(a, bf), jnp.asarray(b, bf),
                                     jnp.asarray(ids), jnp.asarray(splits), "xla")
    da, db = segment_gather_contract(torch.from_numpy(cot).to(BF16), *port)
    assert da.dtype == db.dtype == BF16
    _close_ulp(da, np.asarray(ref[0].astype(jnp.float32)))
    _close_ulp(db, np.asarray(ref[1].astype(jnp.float32)))


@pytest.mark.parametrize("M", [8, 32])
def test_sorted_segsum_bf16_matches_jax(M):
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas import expand_gather as eg
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops.expand_gather import sorted_segsum

    rng = np.random.default_rng(M)
    n_src, n_rows = 700, 4000
    idx = rng.integers(0, n_src - 1, n_rows)
    idx[-500:] = 0  # padded rows point at row 0 of their source
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm].astype(np.int32)
    x = _to_bf16_np(rng.normal(size=(n_rows, M)))
    ref = eg._segsum_xla(jnp.asarray(x, jnp.bfloat16)[perm], jnp.asarray(srt), n_src)
    out = sorted_segsum(torch.from_numpy(x).to(BF16), torch.from_numpy(perm), torch.from_numpy(srt),
                        segment_plan(srt, n_src, 32, "cpu"), torch.from_numpy(idx))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    _close_ulp(out, np.asarray(ref.astype(jnp.float32)))


def test_bf16_dtypes_through_grad_of_grad(rng):
    """Every output and cotangent of K1, K2 and the expand gather / K3 pair
    carries its primal's dtype, to second order; mixed streams run fp32."""
    from gemnet_pytorch_tpu_torch.data import segment_plan
    from gemnet_pytorch_tpu_torch.ops.expand_gather import expand_gather
    from gemnet_pytorch_tpu_torch.ops.segment_outer import (
        segment_gather_contract, segment_outer_sum)

    _, _, _, _, E, (a, b, ids, plan) = _segment_case(rng, n_rows=300, pad_to=512, n_segments=64,
                                                     S=5, M=8)
    a, b = a.requires_grad_(True), b.requires_grad_(True)
    out = segment_outer_sum(a, b, ids, plan)
    assert out.dtype == BF16
    ga, gb = torch.autograd.grad((out.float() ** 2).sum(), (a, b), create_graph=True)
    assert ga.dtype == gb.dtype == BF16
    gga, ggb = torch.autograd.grad((ga.float() ** 2).sum() + (gb.float() ** 2).sum(), (a, b))
    assert gga.dtype == ggb.dtype == BF16
    assert torch.isfinite(gga.float()).all() and torch.isfinite(ggb.float()).all()

    cot = torch.randn(5, E, 8, dtype=BF16, requires_grad=True)
    da, db = segment_gather_contract(cot, a, b, ids, plan)
    assert da.dtype == db.dtype == BF16
    gc, ga, gb = torch.autograd.grad((da.float() ** 2).sum() + db.float().sum(), (cot, a, b))
    assert gc.dtype == ga.dtype == gb.dtype == BF16

    # mixed streams: fp32 sums and output, each cotangent in its primal dtype
    b32 = b.detach().float().requires_grad_(True)
    out = segment_outer_sum(a, b32, ids, plan)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out.sum(), (a, b32))
    assert ga.dtype == BF16 and gb.dtype == torch.float32

    idx = torch.from_numpy(rng.integers(0, 40, 500))
    perm = torch.argsort(idx, stable=True).to(torch.int32)
    srt = idx[perm.long()].to(torch.int32)
    table = torch.randn(40, 8, dtype=BF16, requires_grad=True)
    x = expand_gather(table, idx, perm, srt, segment_plan(srt.numpy(), 40, 32, "cpu"))
    assert x.dtype == BF16
    (g,) = torch.autograd.grad((x.float() ** 2).sum(), table, create_graph=True)
    assert g.dtype == BF16
    (gg,) = torch.autograd.grad((g.float() ** 2).sum(), table)
    assert gg.dtype == BF16 and torch.isfinite(gg.float()).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_raise(rng, dtype):
    from gemnet_pytorch_tpu_torch.ops.expand_gather import sorted_segsum_values
    from gemnet_pytorch_tpu_torch.ops.segment_outer import gather_contract, outer_sum

    _, _, _, _, E, (a, b, ids, plan) = _segment_case(rng, n_rows=50, pad_to=64, n_segments=16,
                                                     S=2, M=4)
    with pytest.raises(TypeError):
        outer_sum(a.to(dtype), b, ids, plan)
    with pytest.raises(TypeError):
        gather_contract(torch.zeros(2, E, 4, dtype=dtype), a, b, ids, plan)
    with pytest.raises(TypeError):
        sorted_segsum_values(b.to(dtype), torch.zeros(64, dtype=torch.int32), ids, plan)


# ---------------------------------------------------------------- layers, model, step

def test_bf16_layers_cast_per_call():
    """fp32 master parameters; bf16 outputs; the scale factor is cast down to
    y's dtype and never y up."""
    from gemnet_pytorch_tpu_torch.models.layers import AtomEmbedding, Dense, ScalingFactor

    g = torch.Generator().manual_seed(0)
    dense = Dense(6, 4, "swish", generator=g, dtype=BF16)
    x = torch.randn(5, 6)
    y = dense(x)
    assert dense.weight.dtype == torch.float32 and y.dtype == BF16
    ref = torch.nn.functional.silu(x.to(BF16) @ dense.weight.to(BF16).T) * (1 / 0.6)
    torch.testing.assert_close(y, ref)
    emb = AtomEmbedding(4, generator=g, dtype=BF16)
    assert emb(torch.tensor([1, 6])).dtype == BF16
    scale = ScalingFactor("s")
    scale.scale_factor.fill_(1.7)
    yb = torch.ones(3, dtype=BF16)
    assert scale(yb).dtype == BF16
    assert float(scale(yb)[0]) == float(torch.tensor(1.7).to(BF16))


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _setup():
    """tests/test_bf16.py's batch (4 molecules of 6-9 atoms with toy targets)
    and a JAX GemNet-Q init carried into the port."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import PadDims, build_graph, pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule, toy_energy_forces

    rng = np.random.default_rng(0)
    mols = [random_molecule(rng, int(rng.integers(6, 10))) for _ in range(4)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    EF = [toy_energy_forces(z, r) for z, r in mols]
    E = np.array([e for e, _ in EF], np.float32)
    F = np.concatenate([f for _, f in EF])
    g = build_graph(R, N, 5.0, 10.0)
    dims = PadDims(n_mol=4, n_atoms=48, n_edges=512, n_triplets=2048, kmax3=16,
                   n_int_edges=512, n_intm=2048, n_quads=8192,
                   kmax4=64).grow_to(scale_graph_dims(g, 1.1), 4, len(Z))
    batch = pad_batch(g, Z, R, dims, E=E, F=F)
    jcfg = JaxConfig(**TINY)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(make_model(jcfg).init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})))
    state_dict = state_dict_from_jax(variables, ModelConfig(**TINY))
    return dict(batch=batch, variables=variables, state_dict=state_dict, n_mol=len(mols),
                n_atoms=len(Z))


def _jax_outputs(setup, compute_dtype):
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model

    model = make_model(JaxConfig(compute_dtype=compute_dtype, **TINY))
    jbatch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    E, F = jax.jit(lambda v, b: energy_and_forces(model, v, b)[:2])(setup["variables"], jbatch)
    return np.asarray(E), np.asarray(F)


def _port_model(setup, compute_dtype):
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    model = GemNet(ModelConfig(compute_dtype=compute_dtype, **TINY),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(setup["state_dict"], strict=True)
    return model


def _assert_bf16_contract(E16, F16, E32, F32):
    """tests/test_bf16.py:64-68: E within 0.03 and F within 0.05 of the fp32
    magnitude."""
    scale_E = max(np.abs(E32).max(), 1e-9)
    scale_F = max(np.abs(F32).max(), 1e-9)
    assert np.abs(E16 - E32).max() / scale_E < E_REL
    assert np.abs(F16 - F32).max() / scale_F < F_REL


# the modules of GemNet's input side, before any interaction: the basis
# down-projections, the atom embedding and the edge embedding (Dense + SiLU)
INPUT_MODULES = ("mlp_rbf4", "mlp_cbf4", "mlp_sbf4", "mlp_rbf3", "mlp_cbf3", "mlp_rbf_h",
                 "mlp_rbf_out", "atom_emb", "edge_emb")


def _jax_input_modules(setup):
    """Each INPUT_MODULES output of one JAX bf16 forward (flax
    capture_intermediates), as fp32 numpy with the output's dtype."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model

    model = make_model(JaxConfig(compute_dtype="bfloat16", **TINY))
    jbatch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    _, state = jax.jit(lambda v, b: model.apply(
        v, b, b["R"], capture_intermediates=True, mutable=["intermediates"]))(
        setup["variables"], jbatch)
    out = {}
    for name in INPUT_MODULES:
        (y,) = jax.tree_util.tree_leaves(state["intermediates"][name]["__call__"])
        out[name] = (np.asarray(y.astype(jnp.float32)), str(y.dtype))
    return out


def _port_input_modules(setup, compute_dtype):
    """The same from one port forward in `compute_dtype` (forward hooks)."""
    from gemnet_pytorch_tpu_torch.data import to_torch

    port = _port_model(setup, compute_dtype).requires_grad_(False)
    out = {}
    for name in INPUT_MODULES:
        port.get_submodule(name).register_forward_hook(
            lambda mod, args, y, name=name: out.__setitem__(
                name, (y.float().numpy(), str(y.dtype).removeprefix("torch."))))
    port(to_torch(setup["batch"], "cpu"))
    return out


@pytest.fixture(scope="module")
def input_modules(setup):
    return _port_input_modules(setup, "bfloat16"), _jax_input_modules(setup)


@pytest.mark.parametrize("name", INPUT_MODULES)
def test_bf16_input_modules_round_as_jax(input_modules, name):
    """The port rounds where the JAX bf16 model rounds: the same bf16 inputs,
    weights cast per call, one rounding of each product's fp32 sum, and
    Python constants rounded to bf16 (1/0.6 is 1.6640625 there). The linear
    modules are bit-equal. The edge embedding's SiLU differs by rounding
    only: XLA on the CPU rounds each op of x * 1/(1+exp(-x)) to bf16, the
    port rounds F.silu once, which stays under one bf16 ulp (2^-7) of the
    magnitude; the same layer in fp32, or with the fp32 constant 1/0.6, does
    not. `python tests/test_torch_bf16.py` prints the readings."""
    port_out, jax_out = input_modules
    (y, dtype), (ref, ref_dtype) = port_out[name], jax_out[name]
    assert dtype == ref_dtype == "bfloat16"
    assert y.shape == ref.shape
    if name == "edge_emb":
        assert np.abs(y - ref).max() <= ULP_REL * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(y, ref)


def test_bf16_model_matches_jax_and_fp32(setup):
    """Port bf16 vs JAX bf16, and each against fp32, at the bf16 contract;
    the outputs are fp32 in both modes. Port vs JAX in bf16 is also held at
    PORT_VS_JAX_BF16, above its reading; the two bf16 models round the SiLU
    differently (see the test above), which at this size moves E/F about as
    far as bf16 vs fp32 does, so where the port rounds is held per module
    above. `python tests/test_torch_bf16.py` prints the readings."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    n_mol, n_atoms = setup["n_mol"], setup["n_atoms"]
    out = {}
    for dt in ("float32", "bfloat16"):
        E, F = energy_and_forces(_port_model(setup, dt).requires_grad_(False),
                                 to_torch(setup["batch"], "cpu"))
        assert E.dtype == F.dtype == torch.float32
        out[dt] = E.numpy()[:n_mol], F.numpy()[:n_atoms]
        jE, jF = _jax_outputs(setup, dt)
        out["jax_" + dt] = jE[:n_mol], jF[:n_atoms]
    _assert_bf16_contract(*out["bfloat16"], *out["jax_bfloat16"])
    for port, ref, limit in zip(out["bfloat16"], out["jax_bfloat16"], PORT_VS_JAX_BF16):
        assert np.abs(port - ref).max() <= limit * np.abs(ref).max()
    _assert_bf16_contract(*out["bfloat16"], *out["float32"])
    _assert_bf16_contract(*out["jax_bfloat16"], *out["jax_float32"])
    # the bf16 mode is a different rounding, not the fp32 model
    assert np.abs(out["bfloat16"][0] - out["float32"][0]).max() > 0


def test_bf16_train_steps(setup):
    """5 bf16 steps with warmup_steps=1 (tests/test_bf16.py:96-118): finite,
    decreasing losses; fp32 gradients, parameters, optimizer state and EMA."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = _port_model(setup, "bfloat16")
    batch = to_torch(setup["batch"], "cpu")
    E, F = energy_and_forces(model, batch, create_graph=True)
    grads = torch.autograd.grad(E.abs().sum() + F.abs().sum(), list(model.parameters()))
    for g in grads:
        assert g.dtype == torch.float32 and torch.isfinite(g).all()

    trainer = Trainer(model, TrainConfig(learning_rate=1e-3, warmup_steps=1, loss="rmse"))
    state = trainer.init_state()
    losses = []
    for _ in range(5):
        state, loss = trainer.train_on_batch(state, batch, 1.0)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    st = state.opt_state
    for t in (state.params, state.ema_params, st.mu, st.nu, st.nu_max, *model.parameters()):
        assert t.dtype == torch.float32


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _print_readings():
    """The readings behind the limits above: per input module and for E/F,
    as shares of the reference's magnitude, for the port in bf16, in fp32,
    and in bf16 with the fp32 constants torch would use (a counterfactual)."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces, layers

    setup = _setup()
    n_mol, n_atoms = setup["n_mol"], setup["n_atoms"]

    def model_outputs(dt):
        E, F = energy_and_forces(_port_model(setup, dt).requires_grad_(False),
                                 to_torch(setup["batch"], "cpu"))
        return E.numpy()[:n_mol], F.numpy()[:n_atoms]

    jax_modules = _jax_input_modules(setup)
    port = {dt: (_port_input_modules(setup, dt), model_outputs(dt))
            for dt in ("bfloat16", "float32")}
    rounded = layers._rounded
    layers._rounded = lambda c, dtype: c
    try:
        port["bfloat16, fp32 constants"] = (_port_input_modules(setup, "bfloat16"),
                                           model_outputs("bfloat16"))
    finally:
        layers._rounded = rounded
    jax_bf16 = [x[:n] for x, n in zip(_jax_outputs(setup, "bfloat16"), (n_mol, n_atoms))]
    jax_fp32 = [x[:n] for x, n in zip(_jax_outputs(setup, "float32"), (n_mol, n_atoms))]
    for name in INPUT_MODULES:
        print(f"{name:12s} vs JAX bf16: " + ", ".join(
            f"port {dt} {_rel_err(mods[name][0], jax_modules[name][0]):.3e}"
            for dt, (mods, _) in port.items()))
    for dt, (_, EF) in port.items():
        (eE, eF) = (_rel_err(o, r) for o, r in zip(EF, jax_bf16))
        print(f"E/F, port {dt} vs JAX bf16: E {eE:.3e}, F {eF:.3e}")
    (eE, eF) = (_rel_err(o, r) for o, r in zip(port["bfloat16"][1], port["float32"][1]))
    print(f"E/F, port bf16 vs port fp32: E {eE:.3e}, F {eF:.3e}")
    (eE, eF) = (_rel_err(o, r) for o, r in zip(jax_bf16, jax_fp32))
    print(f"E/F, JAX bf16 vs JAX fp32: E {eE:.3e}, F {eF:.3e}")


if __name__ == "__main__":
    # from the repository root: python tests/test_torch_bf16.py
    import sys
    from pathlib import Path

    import jax

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    jax.config.update("jax_platforms", "cpu")
    _print_readings()
