"""The port's split3 mode (K4, ModelConfig.matmul_precision="high") on the
CPU against the JAX package: the hi/lo split bit for bit, the plain split3
K1/K2 against JAX's split3 Pallas kernels in interpret mode and against the
exact XLA contract, grad-of-grad through the split3 autograd pair, the
precision reaching every backward, and GemNet plus one train step in "high"
with carried weights.

JAX's "high" flag is process-wide (`set_fp32_split3`); every test that sets
it resets it in `finally`, so the other tests of the worker see exact mode."""

import numpy as np
import pytest
import torch

from test_segment_outer import _make_case

torch.set_num_threads(2)

# split3 vs exact fp32: the JAX package's bound (tests/test_segment_outer.py:155-158)
EXACT_TOL = 3e-5
# port's plain split3 vs JAX's split3 kernels: the same bf16 products, exact
# in fp32, summed in fp32 in another order; readings <= 1.3e-7 of max |out|
SPLIT3_TOL = 1e-6
SHAPES = {"trip": dict(S=7, M=16), "quad": dict(S=49, M=32, n_rows=1200, pad_to=1536)}


@pytest.fixture
def jax_split3():
    from gemnet_pytorch_tpu.ops.pallas import segment_outer as jso

    jso.set_fp32_split3(True)
    try:
        yield jso
    finally:
        jso.set_fp32_split3(False)


def _torch_case(a, b, ids, n_segments):
    from gemnet_pytorch_tpu_torch.data import segment_plan

    return (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(ids.astype(np.int64)),
            segment_plan(ids, n_segments, 128, "cpu"))


def _close(port, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=0, atol=tol * np.abs(ref).max())


def test_split_hi_lo_bits_match_jax():
    """hi and lo as uint16, on fp32 of every magnitude and sign, zeros and
    the fp32 extremes. Values below 2^-100, whose lo half would be subnormal,
    are left out: XLA's CPU flushes subnormals to zero, the port (and the
    CUDA kernel, built without -ftz) keeps them."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas.segment_outer import _split_hi_lo as jax_split
    from gemnet_pytorch_tpu_torch.ops.segment_outer import _split_hi_lo

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(size=4000), rng.normal(size=500) * 1e30, rng.normal(size=500) * 1e-30,
        rng.uniform(-1, 1, 500) * np.exp(rng.uniform(-80, 80, 500)),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 2.0**-100, -(2.0**-100)],
    ]).astype(np.float32)
    x = x[(x == 0) | (np.abs(x) >= 2.0**-100)]
    hi, lo = _split_hi_lo(torch.from_numpy(x))
    jhi, jlo = jax_split(jnp.asarray(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    for port, ref in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(port.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(ref).view(np.uint16))
    # hi is the masked value, not bf16(x): round-to-nearest would differ
    assert not torch.equal(hi, torch.from_numpy(x).bfloat16())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_split3_plain_matches_jax(jax_split3, shape):
    """K1 and K2 (da, db) in split3 against JAX's split3 interpret kernels
    within SPLIT3_TOL, and both against the exact XLA contract within
    EXACT_TOL of max |ref|."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    jso = jax_split3
    rng = np.random.default_rng(7)
    a, b, ids, splits, E = _make_case(rng, **SHAPES[shape])
    cot = rng.normal(size=(a.shape[1], E, b.shape[1])).astype(np.float32)
    ja, jb, jids, jsp, jcot = map(jnp.asarray, (a, b, ids, splits, cot))
    exact = [np.asarray(jso._outer_sum_xla(ja, jb, jids, E)),
             *map(np.asarray, jso._gather_contract_xla(jcot, ja, jb, jids))]
    ref = [np.asarray(jso._outer_sum_pallas(ja, jb, jids, jsp, E, interpret=True)),
           *map(np.asarray, jso._gather_contract_pallas(jcot, ja, jb, jids, jsp,
                                                        interpret=True))]
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    port = [so.outer_sum(ta, tb, tids, plan, "split3"),
            *so.gather_contract(torch.from_numpy(cot), ta, tb, tids, plan, "split3")]
    for p, r, x in zip(port, ref, exact):
        assert p.dtype == torch.float32 and p.shape == r.shape
        _close(p.numpy(), r, SPLIT3_TOL)
        _close(p.numpy(), x, EXACT_TOL)
        _close(r, x, EXACT_TOL)
        assert not np.array_equal(p.numpy(), x)  # split3 really ran


def _fma(x, y, z):
    """fp32 FFMA: the product exact in float64, one sum, rounded to fp32."""
    return (x.astype(np.float64) * y.astype(np.float64) + z).astype(np.float32)


def _split_f(x):
    """split_f: (hi, lo) as fp32 values, through the port's bit-exact split."""
    from gemnet_pytorch_tpu_torch.ops.segment_outer import _split_hi_lo

    hi, lo = _split_hi_lo(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return hi.float().numpy(), lo.float().numpy()


def _warp_backward_emulated(cot, a, b, ids):
    """The arithmetic of the CUDA kernel gather_contract_split3_warp (the K4
    backward at the triplet shape) in numpy, in its order: lane l owns
    columns 2l, 2l + 1; db[t, m] = sum over s in order of
    c_hi (a_hi + a_lo) + c_lo a_hi, two FFMAs per s; the lane's part of
    da[t, s] = c_hi (b_hi + b_lo) + c_lo b_hi over its two columns (a
    product, then three FFMAs), summed across the 32 lanes as the kernel's
    reduce_scatter does for any number of values (the kernel takes four
    rows' eight values of s together): lanes paired by lane bit 4, then 3,
    2, 1, 0. Past S the kernel adds zero products, which change no value."""
    n, S = a.shape
    M = b.shape[1]
    assert M == 64 and S <= 8
    ch, cl = _split_f(cot[:, ids, :])  # (S, n, M)
    ah, al = _split_f(a)
    bh, bl = _split_f(b)
    a_sum, b_sum = ah + al, bh + bl  # exact in fp32
    db = np.zeros((n, M), np.float32)
    for s in range(S):
        db = _fma(ch[s], a_sum[:, s:s + 1], db)
        db = _fma(cl[s], ah[:, s:s + 1], db)

    def lanes(x):  # (n, M) -> (n, lane, its two columns)
        return x.reshape(n, 32, 2)

    part = np.zeros((n, 32, 8), np.float32)
    for s in range(S):
        c_hi, c_lo, b_s, b_hi = lanes(ch[s]), lanes(cl[s]), lanes(b_sum), lanes(bh)
        p = c_hi[..., 0] * b_s[..., 0]
        p = _fma(c_lo[..., 0], b_hi[..., 0], p)
        p = _fma(c_hi[..., 1], b_s[..., 1], p)
        part[:, :, s] = _fma(c_lo[..., 1], b_hi[..., 1], p)
    tree = part.reshape(n, 2, 2, 2, 2, 2, 8)  # lane bits 4 .. 0
    for _ in range(5):
        tree = tree[:, 0] + tree[:, 1]
    return tree[:, :S], db


def test_split3_triplet_backward_order_matches_jax(jax_split3):
    """The triplet K4 backward's order of summation (fused FFMAs, a lane's
    two columns, the warp's reduce-scatter) at the real triplet width (S = 7,
    M = 64), emulated in numpy: within 1e-5 of max |ref| of JAX's split3
    interpret kernel and within EXACT_TOL of the exact XLA contract, per
    output. Readings (seed 11): da 9.2e-8 / 1.55e-5, db 1.8e-7 / 2.14e-5."""
    import jax.numpy as jnp

    jso = jax_split3
    rng = np.random.default_rng(11)
    a, b, ids, splits, E = _make_case(rng, n_rows=1500, n_segments=256, S=7, M=64,
                                      pad_to=2048)
    cot = rng.normal(size=(7, E, 64)).astype(np.float32)
    ja, jb, jids, jsp, jcot = map(jnp.asarray, (a, b, ids, splits, cot))
    ref = jso._gather_contract_pallas(jcot, ja, jb, jids, jsp, interpret=True)
    exact = jso._gather_contract_xla(jcot, ja, jb, jids)
    for port, r, x in zip(_warp_backward_emulated(cot, a, b, ids), ref, exact):
        assert port.dtype == np.float32 and port.shape == r.shape
        _close(port, r, 1e-5)
        _close(port, x, EXACT_TOL)
        assert not np.array_equal(port, np.asarray(x))  # split3, not exact fp32


def test_split3_ignored_on_bf16_streams():
    """bf16 streams ignore split3 (segment_outer.py:182-183); an unknown
    precision raises."""
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so

    rng = np.random.default_rng(1)
    a, b, ids, _, E = _make_case(rng, n_rows=200, pad_to=256, n_segments=32)
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    ta, tb = ta.bfloat16(), tb.bfloat16()
    assert torch.equal(so.outer_sum(ta, tb, tids, plan, "split3"),
                       so.outer_sum(ta, tb, tids, plan, "exact"))
    with pytest.raises(ValueError, match="precision"):
        so.outer_sum(ta, tb, tids, plan, "tf32")


def test_split3_grad_of_grad_matches_exact():
    """Second order through the split3 autograd pair (the force-training
    path) against the exact XLA oracle's jax.grad of jax.grad."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.ops.pallas.segment_outer import segment_outer_sum as jax_sos
    from gemnet_pytorch_tpu_torch.ops.segment_outer import segment_outer_sum

    rng = np.random.default_rng(3)
    a, b, ids, splits, E = _make_case(rng, n_rows=100, pad_to=128, n_segments=32, S=3, M=4)
    jb, jids, jsp = jnp.asarray(b), jnp.asarray(ids), jnp.asarray(splits)

    def loss_jax(a):
        g = jax.grad(lambda a2: jnp.sum(jax_sos(a2, jb, jids, jsp, E, "xla") ** 2))(a)
        return jnp.sum(g**2)

    ref = np.asarray(jax.grad(loss_jax)(jnp.asarray(a)))
    ta, tb, tids, plan = _torch_case(a, b, ids, E)
    ta.requires_grad_(True)
    (g,) = torch.autograd.grad((segment_outer_sum(ta, tb, tids, plan, "split3") ** 2).sum(), ta,
                               create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), ta)
    # three split3 contractions deep, each within EXACT_TOL of its magnitude
    _close(gg.numpy(), ref, 3 * EXACT_TOL)


def test_precision_reaches_every_backward(synthetic_npz, monkeypatch):
    """One "high" train step of a 2-block GemNet-Q on the CPU: every K1 and
    K2 call, forward, -dE/dR backward and the loss's grad-of-grad, runs
    split3 (the CPU counterpart of chip_smoke's pinned census: 4 forward K1,
    4 + 4 K2 in the two backwards, 2 K1 + 1 K2 for each of the 4 first
    -backward K2s)."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.ops import segment_outer as so
    from gemnet_pytorch_tpu_torch.training import Trainer

    from test_torch_train import TINY, _provider

    calls = []
    for name in ("outer_sum", "gather_contract"):
        fn = getattr(so, name)

        def counted(*args, _fn=fn, _name=name):
            calls.append((_name, args[-1]))  # (..., precision)
            return _fn(*args)

        monkeypatch.setattr(so, name, counted)
    cfg = ModelConfig(matmul_precision="high", **TINY)
    trainer = Trainer(GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
                      TrainConfig(warmup_steps=1))
    batch = next(_provider(synthetic_npz, False, False).get_dataset("train", prefetch_workers=0))
    trainer.train_on_batch(trainer.init_state(), batch, 1.0)
    assert sorted(set(calls)) == [("gather_contract", "split3"), ("outer_sum", "split3")]
    assert calls.count(("outer_sum", "split3")) == 12
    assert calls.count(("gather_contract", "split3")) == 12


# ---------------------------------------------------------------- model, train step

SMALL = dict(
    num_spherical=4, num_radial=4, num_blocks=2, emb_size_atom=32, emb_size_edge=32,
    emb_size_trip=16, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=16,
)
VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True)}
# port "high" (split3 on the CPU) vs JAX "high" on the CPU, which is exact
# fp32 there (XLA, not the Pallas kernels): the split3 error carried through
# two blocks. Readings, share of max |E| / max |F|: Q 1.2e-6 / 8.2e-7,
# dT 1.1e-6 / 8.2e-7; the same against the port's own exact mode
MODEL_TOL = {"E": 2e-5, "F": 2e-5}


def _jax_high_model(jcfg_kwargs):
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.ops.pallas.segment_outer import set_fp32_split3

    try:
        return make_model(JaxConfig(matmul_precision="high", **jcfg_kwargs))
    finally:
        set_fp32_split3(False)  # make_model set it process-wide


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_high_model_matches_jax(synthetic_npz, variant):
    """E and F of GemNet-Q (-dE/dR) and -dT (direct) in "high", port on the
    CPU (split3) against JAX on the CPU, with carried weights and non-unit
    scale factors; and the port's "high" against its own exact mode, which
    must differ (split3 ran) by less than the tolerance."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.models import energy_and_forces as jax_ef
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    from test_torch_model import _padded_batch

    kw = dict(**VARIANTS[variant], **SMALL)
    batch, n = _padded_batch(synthetic_npz, kw["triplets_only"])
    model = _jax_high_model(kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1), jbatch))
    rng = np.random.default_rng(5)
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])
    jE, jF = map(np.asarray, jax.jit(lambda v, b: jax_ef(model, v, b)[:2])(variables, jbatch))
    outs = {}
    for precision in ("high", "default"):
        cfg = ModelConfig(matmul_precision=precision, **kw)
        port = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
        E, F = energy_and_forces(port.requires_grad_(False), to_torch(batch, "cpu"))
        outs[precision] = (E.numpy()[: n["mol"]], F.numpy()[: n["atoms"]])
    (E, F), (E0, F0) = outs["high"], outs["default"]
    _close(E, jE[: n["mol"]], MODEL_TOL["E"])
    _close(F, jF[: n["atoms"]], MODEL_TOL["F"])
    assert not (np.array_equal(E, E0) and np.array_equal(F, F0))
    _close(E, E0, MODEL_TOL["E"])
    _close(F, F0, MODEL_TOL["F"])


def test_high_train_step_matches_jax(synthetic_npz):
    """One "high" Trainer step of GemNet-Q (grad-of-grad through split3)
    against the JAX Trainer's with the same weights: loss within rtol 1e-4,
    the whole parameter update within a relative L2 error of 1e-3 (Adam's
    first step is ~lr*sign(g); see tests/test_torch_train.py)."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    from test_torch_train import TINY, TRAIN, _flat, _provider, _rel_l2

    batch = next(_provider(synthetic_npz, False, True).get_dataset("train", prefetch_workers=0))
    model = _jax_high_model(TINY)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})))
    jtrainer = JaxTrainer(model, JaxTrainConfig(**TRAIN))
    jstate = jtrainer.init_state(variables)
    jstate, jloss = jtrainer.train_on_batch(jstate, dict(batch), 1.0)
    cfg = ModelConfig(matmul_precision="high", **TINY)

    def port_order(flat):
        tree = jax.tree_util.tree_map(np.asarray, jtrainer.unravel(flat))
        return state_dict_from_jax({"params": tree, "scale_factors": variables["scale_factors"]},
                                   cfg)

    port = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    trainer = Trainer(port, TrainConfig(**TRAIN))
    state = trainer.init_state()
    p0 = state.params.clone().numpy()
    state, loss = trainer.train_on_batch(state, batch, 1.0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    assert _rel_l2(state.params.numpy() - p0, _flat(trainer, port_order(jstate.params)) - p0) < 1e-3

