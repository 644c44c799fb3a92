"""The PyTorch port's training step against the JAX package's `Trainer`
(flat mode) on the CPU: TrainConfig, the LR schedule, PlateauState, the
weight-decay and shared-gradient masks, the flat optimizer update, the loss
and metrics, the DataProvider, and 5-step trajectories of GemNet-Q
(grad-of-grad through -dE/dR) and GemNet-dT with carried weights."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# tests/test_bf16.py's widths, 2 blocks
TINY = dict(
    num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16, emb_size_edge=16,
    emb_size_trip=8, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=8,
)
VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True)}
# tests/test_flat_opt.py's optimizer settings: a warmup -> decay crossover
# inside 5 steps, weight decay, and a clip that binds
TRAIN = dict(learning_rate=1e-3, warmup_steps=3, decay_steps=50, decay_rate=0.5,
             weight_decay=1e-3, rho_force=0.9, loss="rmse", grad_clip_max=0.5,
             ema_decay=0.9, batch_size=4)
SEG_BLOCK_KEYS = ("trip_seg_block", "quad_seg_block")  # TPU-only shape carriers


def _rel_l2(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------- config, schedules

def test_train_config_matches_jax():
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu_torch.config import TrainConfig

    def jax_fields(cfg):
        # the port's fields are JAX's and OCP's loss coefficients, unset by
        # default (TUM's rho_force loss)
        port = dataclasses.asdict(cfg)
        assert {k: v for k, v in port.items() if k not in jax_names} == dict(
            energy_coefficient=None, force_coefficient=None)
        return {k: v for k, v in port.items() if k in jax_names}

    jax_names = set(dataclasses.asdict(JaxTrainConfig()))
    assert jax_fields(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    d = dict(learning_rate=5e-4, warmup_steps=7, loss="mae", unknown_key=1)
    assert jax_fields(TrainConfig.from_dict(d)) == dataclasses.asdict(
        JaxTrainConfig.from_dict(d))


@pytest.mark.parametrize("staircase", [False, True])
def test_schedule_matches_jax(staircase):
    from gemnet_pytorch_tpu.training.schedules import linear_warmup_exponential_decay as jax_sched
    from gemnet_pytorch_tpu_torch.training.schedules import linear_warmup_exponential_decay

    args = (10, 25.0, 0.3, staircase)
    port, ref = linear_warmup_exponential_decay(*args), jax_sched(*args)
    for step in (0, 1, 5, 9, 10, 11, 24, 25, 26, 100, 3000):
        np.testing.assert_allclose(float(port(step)), float(ref(step)), rtol=1e-6)
        # the optimizer passes its on-device int32 count
        np.testing.assert_allclose(float(port(torch.tensor(step, dtype=torch.int32))),
                                   float(ref(step)), rtol=1e-6)
    assert float(linear_warmup_exponential_decay(0, 10.0, 0.5)(0)) == float(jax_sched(0, 10.0, 0.5)(0))


def test_plateau_state_matches_jax():
    from gemnet_pytorch_tpu.training.schedules import PlateauState as JaxPlateau
    from gemnet_pytorch_tpu_torch.training.schedules import PlateauState

    rng = np.random.default_rng(0)
    metrics = np.concatenate([np.linspace(1.0, 0.5, 6), 0.5 + 0.01 * rng.random(20),
                              np.linspace(0.49, 0.2, 5), np.full(12, 0.3)])
    kw = dict(factor=0.5, patience=3, cooldown=2)
    port, ref = PlateauState(**kw), JaxPlateau(**kw)
    for m in metrics:
        assert port.step(m) == ref.step(m)
    assert port.reduce_counter > 0
    assert port.state_dict() == ref.state_dict()
    restored = PlateauState(**kw)
    restored.load_state_dict(port.state_dict())
    assert restored.state_dict() == port.state_dict()


# ---------------------------------------------------------------- JAX runs

def _provider(npz, triplets_only, jax_side):
    if jax_side:
        from gemnet_pytorch_tpu.data import DataContainer, DataProvider
    else:
        from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider
    c = DataContainer(npz, cutoff=5.0, int_cutoff=10.0, triplets_only=triplets_only)
    return DataProvider(c, ntrain=32, nval=8, batch_size=4, seed=0, pad_sample_batches=4)


@pytest.fixture(scope="module", params=list(VARIANTS))
def jax_trajectory(request, synthetic_npz):
    """5 JAX Trainer steps (flat mode) on one batch, from a model.init with
    non-unit scale factors: per-step losses, the params and EMA after, the
    drained metrics and an EMA eval."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Metrics, Trainer

    variant = VARIANTS[request.param]
    mcfg = ModelConfig(**variant, **TINY)
    batch = next(_provider(synthetic_npz, variant["triplets_only"], True)
                 .get_dataset("train", prefetch_workers=0))
    model = make_model(mcfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})))
    rng = np.random.default_rng(3)
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])
    trainer = Trainer(model, TrainConfig(**TRAIN))
    state = trainer.init_state(variables)
    losses = []
    for i in range(5):
        state, loss = trainer.train_on_batch(state, dict(batch), 0.5 if i >= 3 else 1.0)
        losses.append(float(loss))
    metrics = Metrics("train", trainer.tracked_metrics)
    state = trainer.drain_metrics(state, metrics)
    ev = Metrics("val", trainer.tracked_metrics)
    trainer.test_on_batch(state, dict(batch), ev, use_ema=True)

    def port_order(flat):
        from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
        from gemnet_pytorch_tpu_torch.config import ModelConfig as PortConfig

        tree = jax.tree_util.tree_map(np.asarray, trainer.unravel(flat))
        sd = state_dict_from_jax({"params": tree, "scale_factors": variables["scale_factors"]},
                                 PortConfig(**variant, **TINY))
        return sd

    return dict(name=request.param, variant=variant, variables=variables, batch=batch,
                losses=losses, metrics=metrics.result(append_tag=False),
                eval=ev.result(append_tag=False),
                params=port_order(state.params), ema=port_order(state.ema_params),
                params0=port_order(trainer.init_state(variables).params))


def _port_trainer(jax_run):
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(**jax_run["variant"], **TINY)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(state_dict_from_jax(jax_run["variables"], cfg), strict=True)
    return Trainer(model, TrainConfig(**TRAIN))


def _flat(trainer, named):
    """A name -> tensor dict flattened in the port's buffer order."""
    return np.concatenate([named[n].numpy().reshape(-1)
                           for n, _ in trainer.model.named_parameters()])


def test_trajectory_matches_jax(jax_trajectory):
    """5 steps on one batch (warmup -> decay, lr_scale 0.5 on the last two):
    losses equal per step within rtol 1e-4; the total parameter update, the
    EMA's move and the drained metrics within a relative L2 error of 1e-3.

    Not elementwise: at step 1 Adam's update is ~lr*sign(g), and a weight
    whose true gradient is ~0 may take either sign in two correct fp32
    implementations that sum in different orders (here: autograd vs XLA, and
    the global norm in named_parameters() order vs sorted-key order). Such
    weights are few and their moves small, so the whole update's relative
    L2 error stays far below 1e-3 while one element may differ by 2*lr."""
    from gemnet_pytorch_tpu_torch.training import Metrics

    run = jax_trajectory
    trainer = _port_trainer(run)
    state = trainer.init_state()
    p0 = state.params.clone().numpy()
    np.testing.assert_array_equal(p0, _flat(trainer, run["params0"]))
    losses = []
    for i in range(5):
        state, loss = trainer.train_on_batch(state, run["batch"], 0.5 if i >= 3 else 1.0)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    assert _rel_l2(state.params.numpy() - p0, _flat(trainer, run["params"]) - p0) < 1e-3
    assert _rel_l2(state.ema_params.numpy() - p0, _flat(trainer, run["ema"]) - p0) < 1e-3
    # the parameter views see the updated buffer
    for (_, p), v in zip(trainer.model.named_parameters(),
                         torch.split(state.params, [p.numel() for p in trainer.model.parameters()])):
        assert p.data_ptr() == v.data_ptr()

    metrics = Metrics("train", trainer.tracked_metrics)
    state = trainer.drain_metrics(state, metrics)
    got = metrics.result(append_tag=False)
    assert sorted(got) == sorted(run["metrics"])
    assert _rel_l2(list(got.values()), [run["metrics"][k] for k in got]) < 1e-3
    assert float(state.metric_acc.abs().sum()) == 0.0

    ev = Metrics("val", trainer.tracked_metrics)
    trainer.test_on_batch(state, run["batch"], ev, use_ema=True)
    got = ev.result(append_tag=False)
    assert _rel_l2(list(got.values()), [run["eval"][k] for k in got]) < 1e-3
    # after the EMA eval the parameters are the trained buffer's views again
    assert next(trainer.model.parameters()).data_ptr() == state.params.data_ptr()


def test_masks_match_jax(jax_trajectory):
    """wd_mask and shared_scale per parameter equal the JAX package's flat
    masks carried over by name."""
    import jax

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.training import flat_opt as jfo
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.training import flat_opt

    run = jax_trajectory
    params = run["variables"]["params"]
    jcfg, cfg = JaxConfig(**run["variant"], **TINY), ModelConfig(**run["variant"], **TINY)
    _, unravel = jfo.ravel_params(params)
    trainer = _port_trainer(run)
    named = [(n, p.shape) for n, p in trainer.model.named_parameters()]
    port = flat_opt.build_masks(named, cfg, 1e-3, "cpu")
    for ref_flat, port_flat in zip(jfo.build_masks(params, jcfg, 1e-3), port):
        tree = jax.tree_util.tree_map(np.asarray, unravel(ref_flat))
        ref = state_dict_from_jax({"params": tree, "scale_factors": run["variables"]["scale_factors"]}, cfg)
        np.testing.assert_array_equal(port_flat.numpy(), _flat(trainer, ref))
    labels = {n: flat_opt.param_label(n) for n, _ in named}
    assert labels["atom_emb.embeddings.weight"] == "adam"
    assert labels["rbf_basis.frequencies"] == "adam"
    assert labels["mlp_rbf3.weight"] == "adamw"


def test_apply_update_matches_jax():
    """Three calls on the same g/p/state, the second clipped: params, EMA and
    every optimizer buffer within rtol 1e-6 of flat_opt.apply_update."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.training import flat_opt as jfo
    from gemnet_pytorch_tpu.training.schedules import linear_warmup_exponential_decay as jsched
    from gemnet_pytorch_tpu_torch.training import flat_opt
    from gemnet_pytorch_tpu_torch.training.schedules import linear_warmup_exponential_decay

    rng = np.random.default_rng(0)
    n = 5000
    p = rng.normal(size=n).astype(np.float32)
    wd = np.where(rng.random(n) < 0.8, 2e-3, 0.0).astype(np.float32)
    sc = rng.choice([1.0, 0.5, 1 / 3], size=n).astype(np.float32)
    grads = [rng.normal(size=n).astype(np.float32) * s for s in (1e-3, 10.0, 1e-2)]
    kw = dict(learning_rate=1e-3, grad_clip_max=10.0, ema_decay=0.99)

    jst = jfo.init(jnp.asarray(p), wd, sc)
    jp, jema = jnp.asarray(p), jnp.asarray(p)
    st = flat_opt.init(torch.from_numpy(p), torch.from_numpy(wd), torch.from_numpy(sc))
    tp, tema = torch.from_numpy(p.copy()), torch.from_numpy(p.copy())
    for i, g in enumerate(grads):
        lr_scale = 1.0 if i < 2 else 0.5
        jp, jema, jst = jfo.apply_update(jnp.asarray(g), jst, jp, jema, lr_scale,
                                         schedule=jsched(2, 10.0, 0.5), **kw)
        flat_opt.apply_update(torch.from_numpy(g), st, tp, tema, lr_scale,
                              schedule=linear_warmup_exponential_decay(2, 10.0, 0.5), **kw)
        assert float(np.linalg.norm(g * sc)) > 10.0 or i != 1  # the clip binds
        for port, ref in ((tp, jp), (tema, jema), (st.mu, jst.mu), (st.nu, jst.nu),
                          (st.nu_max, jst.nu_max)):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-12)
        assert int(st.count) == int(jst.count) == i + 1


@pytest.mark.parametrize("loss", ["rmse", "mae"])
def test_loss_metrics_match_jax(loss):
    """loss_metrics_from_outputs on random outputs with padded rows."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    rng = np.random.default_rng(1)
    n_mol, n_atoms = 6, 40
    E, tE = rng.normal(size=(2, n_mol, 1)).astype(np.float32)
    F, tF = rng.normal(size=(2, n_atoms, 3)).astype(np.float32)
    batch = dict(E=tE, F=tF, mol_mask=np.arange(n_mol) < 4, atom_mask=np.arange(n_atoms) < 31)
    kw = dict(loss=loss, rho_force=0.7)
    jt = JaxTrainer(make_model(JaxConfig(**TINY)), JaxTrainConfig(**kw))
    ref_loss, (ref_m, ref_c) = jt.loss_metrics_from_outputs(
        jnp.asarray(E), None, jnp.asarray(F), None, {k: jnp.asarray(v) for k, v in batch.items()})
    model = GemNet(ModelConfig(**TINY), generator=torch.Generator().manual_seed(0), device="cpu")
    t = Trainer(model, TrainConfig(**kw))
    got_loss, (got_m, got_c) = t.loss_metrics_from_outputs(
        torch.from_numpy(E), None, torch.from_numpy(F), None,
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(ref_loss), rtol=1e-6)
    assert sorted(got_m) == sorted(ref_m)
    for k in ref_m:
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-6, err_msg=k)
    for k in ref_c:
        assert float(got_c[k]) == float(ref_c[k])
    from gemnet_pytorch_tpu.training import trainer as jtr
    from gemnet_pytorch_tpu_torch.training import trainer as ttr

    for port_fn, jax_fn in ((ttr.masked_mae, jtr.masked_mae), (ttr.masked_rmse, jtr.masked_rmse)):
        np.testing.assert_allclose(
            float(port_fn(torch.from_numpy(F), torch.from_numpy(tF),
                          torch.from_numpy(batch["atom_mask"]))),
            float(jax_fn(jnp.asarray(F), jnp.asarray(tF), jnp.asarray(batch["atom_mask"]))),
            rtol=1e-6)


# ---------------------------------------------------------------- data, metrics

@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_data_provider_matches_jax(synthetic_npz, tmp_path, triplets_only):
    """Same splits, pad dims and batches (prefetched or not) as the JAX
    package's DataProvider, less its TPU-only segment-block carriers."""
    port = _provider(synthetic_npz, triplets_only, False)
    ref = _provider(synthetic_npz, triplets_only, True)
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(port.idx[k], ref.idx[k])
    ref_dims = {k: v for k, v in dataclasses.asdict(ref.pad_dims).items()
                if not k.startswith("seg_block")}
    assert dataclasses.asdict(port.pad_dims) == ref_dims
    for split, workers in (("train", 2), ("val", 0)):
        it, jit = port.get_dataset(split, prefetch_workers=workers), ref.get_dataset(split, prefetch_workers=0)
        for _ in range(3):
            b, rb = next(it), next(jit)
            assert sorted(b) == sorted(k for k in rb if k not in SEG_BLOCK_KEYS)
            for k in b:
                np.testing.assert_array_equal(b[k], rb[k], err_msg=k)
    port.save_split(str(tmp_path / "split.npz"))
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider

    manual = DataProvider(DataContainer(synthetic_npz, 5.0, 10.0, triplets_only=triplets_only),
                          0, 0, batch_size=4, split=str(tmp_path / "split.npz"),
                          pad_dims=port.pad_dims)
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(manual.idx[k], port.idx[k])


def test_metrics_match_jax(tmp_path):
    from gemnet_pytorch_tpu.training import metrics as jm
    from gemnet_pytorch_tpu_torch.training import metrics as tm

    keys = ["loss", "energy_mae", "force_mae"]
    port, ref = tm.Metrics("val", keys), jm.Metrics("val", keys)
    for n, vals in ((4, (1.0, 2.0, 3.0)), (2, (0.5, 1.5, 0.25)), (7, (2.0, 0.0, 1.0))):
        port.update_state(n, **dict(zip(keys, vals)))
        ref.update_state(n, **dict(zip(keys, vals)))
    assert port.result() == ref.result()
    best = tm.BestMetrics(str(tmp_path), port)
    best.initialize()
    best.update(12, port)
    again = tm.BestMetrics(str(tmp_path), port)
    again.restore()
    assert again.step == 12 and again.loss == port.loss
    writer = tm.make_writer(str(tmp_path / "logs"), prefer_tensorboard=False)
    port.write(writer, 3)
    assert (tmp_path / "logs" / "metrics.jsonl").read_text().count("\n") == len(keys)
