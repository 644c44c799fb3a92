"""The port's two-target models and MVE training against the JAX package on
the CPU: `energy_and_forces` at num_targets=2 for GemNet-Q/-T (one forward,
one -dE/dR backward per target) and GemNet-dQ/-dT (the direct heads), the
MVE loss and its 8 metrics, and 5-step MVE trajectories of the Trainer
against JAX's. `run_jax_trainer` and `check_trajectory` are shared with
tests/test_torch_tree_opt.py."""

import numpy as np
import pytest
import torch

from test_torch_train import TINY, TRAIN, _provider, _rel_l2

torch.set_num_threads(2)

ALL_VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
                "T": dict(triplets_only=True, direct_forces=False),
                "dQ": dict(triplets_only=False, direct_forces=True),
                "dT": dict(triplets_only=True, direct_forces=True)}
# 5 steps: the lr_scale of each (the plateau's 0.5 on the last two)
LR_SCALES = (1.0, 1.0, 1.0, 0.5, 0.5)


def _jax_variables(model, batch, seed=0, scale_seed=3):
    """model.init from a seed, as numpy, with non-unit scale factors."""
    import jax
    import jax.numpy as jnp

    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()})))
    rng = np.random.default_rng(scale_seed)
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])
    return variables


def _port_sd(tree, variables, cfg):
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    return state_dict_from_jax({"params": tree, "scale_factors": variables["scale_factors"]}, cfg)


def run_jax_trainer(npz, variant: dict, model_kw: dict, train_kw: dict):
    """5 JAX Trainer steps on one batch from a model.init with non-unit
    scales: per-step losses, the params and EMA after them and before (as
    port state dicts), the drained metrics and an EMA eval."""
    import jax

    from gemnet_pytorch_tpu.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Metrics, Trainer
    from gemnet_pytorch_tpu_torch.config import ModelConfig as PortConfig

    mcfg = ModelConfig(**variant, **TINY, **model_kw)
    pcfg = PortConfig(**variant, **TINY, **model_kw)
    batch = next(_provider(npz, variant["triplets_only"], True)
                 .get_dataset("train", prefetch_workers=0))
    model = make_model(mcfg)
    variables = _jax_variables(model, batch)
    trainer = Trainer(model, TrainConfig(**train_kw))
    state = trainer.init_state(variables)

    def port(params):
        tree = jax.tree_util.tree_map(np.asarray, trainer.params_tree(params))
        return _port_sd(tree, variables, pcfg)

    params0 = port(state.params)
    losses = []
    for lr_scale in LR_SCALES:
        state, loss = trainer.train_on_batch(state, dict(batch), lr_scale)
        losses.append(float(loss))
    metrics = Metrics("train", trainer.tracked_metrics)
    state = trainer.drain_metrics(state, metrics)
    ev = Metrics("val", trainer.tracked_metrics)
    trainer.test_on_batch(state, dict(batch), ev, use_ema=True)
    return dict(variant=variant, model_kw=model_kw, train_kw=train_kw, variables=variables,
                batch=batch, losses=losses, metrics=metrics.result(append_tag=False),
                eval=ev.result(append_tag=False), params0=params0, params=port(state.params),
                ema=port(state.ema_params), tracked=list(trainer.tracked_metrics))


def port_trainer(run, **train_over):
    """The port's Trainer of `run`'s model and config, weights carried."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(**run["variant"], **TINY, **run["model_kw"])
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(_port_sd(run["variables"]["params"], run["variables"], cfg),
                          strict=True)
    return Trainer(model, TrainConfig(**dict(run["train_kw"], **train_over)))


def _flat(trainer, named):
    return np.concatenate([named[n].numpy().reshape(-1)
                           for n, _ in trainer.model.named_parameters()])


def check_trajectory(run):
    """The port's 5 steps against `run`'s: losses within rtol 1e-4; the whole
    update, the EMA's move, the drained metrics and the EMA eval within a
    relative L2 error of 1e-3 (tests/test_torch_train.py's
    test_trajectory_matches_jax gates). Returns the port's trainer and
    state."""
    from gemnet_pytorch_tpu_torch.training import Metrics

    trainer = port_trainer(run)
    state = trainer.init_state()
    p0 = state.params.clone().numpy()
    np.testing.assert_array_equal(p0, _flat(trainer, run["params0"]))
    losses = []
    for lr_scale in LR_SCALES:
        state, loss = trainer.train_on_batch(state, run["batch"], lr_scale)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    assert _rel_l2(state.params.numpy() - p0, _flat(trainer, run["params"]) - p0) < 1e-3
    assert _rel_l2(state.ema_params.numpy() - p0, _flat(trainer, run["ema"]) - p0) < 1e-3
    assert trainer.tracked_metrics == run["tracked"]
    metrics = Metrics("train", trainer.tracked_metrics)
    state = trainer.drain_metrics(state, metrics)
    got = metrics.result(append_tag=False)
    assert sorted(got) == sorted(run["metrics"])
    assert _rel_l2(list(got.values()), [run["metrics"][k] for k in got]) < 1e-3
    ev = Metrics("val", trainer.tracked_metrics)
    trainer.test_on_batch(state, run["batch"], ev, use_ema=True)
    got = ev.result(append_tag=False)
    assert _rel_l2(list(got.values()), [run["eval"][k] for k in got]) < 1e-3
    assert next(trainer.model.parameters()).data_ptr() == state.params.data_ptr()
    return trainer, state


# ---------------------------------------------------------------- two targets

@pytest.mark.parametrize("name", list(ALL_VARIANTS))
def test_two_target_energy_and_forces_match_jax(synthetic_npz, name):
    """E (n_mol, 2) and F (n_atoms, 2, 3): -dE_t/dR per target (JAX: one
    forward and a vmapped VJP) or the two direct heads, within rtol 1e-5 and
    atol 1e-5·max|ref|, with carried weights and non-unit scales."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import energy_and_forces as jax_ef
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    variant = ALL_VARIANTS[name]
    batch = next(_provider(synthetic_npz, variant["triplets_only"], True)
                 .get_dataset("train", prefetch_workers=0))
    model = make_model(JaxConfig(num_targets=2, **variant, **TINY))
    variables = _jax_variables(model, batch, seed=1)
    E_ref, F_ref = (np.asarray(x) for x in jax.jit(lambda v, b: jax_ef(model, v, b)[:2])(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))

    cfg = ModelConfig(num_targets=2, **variant, **TINY)
    port = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(_port_sd(variables["params"], variables, cfg), strict=True)
    E, F = energy_and_forces(port.requires_grad_(False), to_torch(batch, "cpu"))
    assert tuple(E.shape) == E_ref.shape == (batch["mol_mask"].shape[0], 2)
    assert tuple(F.shape) == F_ref.shape == (batch["R"].shape[0], 2, 3)
    for got, ref in ((E.numpy(), E_ref), (F.numpy(), F_ref)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # the two targets are two functions: the second force is not the first's
    assert np.abs(F_ref[:, 0] - F_ref[:, 1]).max() > 1e-3 * np.abs(F_ref).max()


def test_two_target_forces_are_each_targets_gradient(synthetic_npz):
    """Each target's -dE/dR equals the gradient of that target alone (the
    graph retained between the two backwards changes nothing), and the
    train path (create_graph) gives the same values, within fp32 rounding."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    batch = to_torch(next(_provider(synthetic_npz, False, False)
                          .get_dataset("train", prefetch_workers=0)), "cpu")
    model = GemNet(ModelConfig(num_targets=2, **TINY), generator=torch.Generator().manual_seed(4),
                   device="cpu")
    E, F = energy_and_forces(model, batch)
    E2, F2 = energy_and_forces(model, batch, create_graph=True)
    # fp32 rounding: a double-backward graph may sum in another order
    assert F2.requires_grad
    torch.testing.assert_close(F, F2.detach(), rtol=1e-5, atol=1e-6)
    for t in range(2):
        R = batch["R"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(model(batch, R)[0][:, t].sum(), R)
        torch.testing.assert_close(F[:, t], -g, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- MVE loss

def test_mve_loss_metrics_match_jax():
    """The MVE split (softplus variances) and loss_metrics_from_outputs on
    random two-target outputs with padded rows: the loss and the 8 metrics
    within rtol 1e-6, the counts equal."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu.training import trainer as jtr
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer
    from gemnet_pytorch_tpu_torch.training import trainer as ttr

    rng = np.random.default_rng(2)
    n_mol, n_atoms = 6, 40
    E = rng.normal(size=(n_mol, 2)).astype(np.float32) * 3
    F = rng.normal(size=(n_atoms, 2, 3)).astype(np.float32) * 3
    tE = rng.normal(size=(n_mol, 1)).astype(np.float32)
    tF = rng.normal(size=(n_atoms, 3)).astype(np.float32)
    batch = dict(E=tE, F=tF, mol_mask=np.arange(n_mol) < 4, atom_mask=np.arange(n_atoms) < 31)
    kw = dict(mve=True, rho_force=0.7)
    jt = JaxTrainer(make_model(JaxConfig(num_targets=2, **TINY)), JaxTrainConfig(**kw))
    jsplit = jt._split_outputs(jnp.asarray(E), jnp.asarray(F))
    ref_loss, (ref_m, ref_c) = jt.loss_metrics_from_outputs(
        *jsplit, {k: jnp.asarray(v) for k, v in batch.items()})
    model = GemNet(ModelConfig(num_targets=2, **TINY), generator=torch.Generator().manual_seed(0),
                   device="cpu")
    t = Trainer(model, TrainConfig(**kw))
    split = t._split_outputs(torch.from_numpy(E), torch.from_numpy(F))
    for got, ref in zip(split, jsplit):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    got_loss, (got_m, got_c) = t.loss_metrics_from_outputs(
        *split, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(got_loss), float(ref_loss), rtol=1e-6)
    assert list(got_m) == t.tracked_metrics == jt.tracked_metrics and len(got_m) == 8
    for k in ref_m:
        np.testing.assert_allclose(float(got_m[k]), float(ref_m[k]), rtol=1e-6, err_msg=k)
    for k in ref_c:
        assert float(got_c[k]) == float(ref_c[k])
    # var below the clamp: the NLL reads var as 1e-6, as torch's gaussian_nll_loss
    var = np.full((n_atoms, 3), 1e-9, np.float32)
    np.testing.assert_allclose(
        float(ttr.masked_nll(torch.from_numpy(tF), torch.from_numpy(var), torch.from_numpy(tF * 0),
                             torch.from_numpy(batch["atom_mask"]))),
        float(jtr.masked_nll(jnp.asarray(tF), jnp.asarray(var), jnp.asarray(tF * 0),
                             jnp.asarray(batch["atom_mask"]))), rtol=1e-6)


def test_mve_needs_two_targets():
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = GemNet(ModelConfig(**TINY), generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="num_targets=2"):
        Trainer(model, TrainConfig(mve=True))


# ---------------------------------------------------------------- MVE trajectories

MVE_CASES = {"dT": ALL_VARIANTS["dT"], "Q": ALL_VARIANTS["Q"]}


@pytest.fixture(scope="module", params=list(MVE_CASES))
def jax_mve_run(request, synthetic_npz):
    return run_jax_trainer(synthetic_npz, MVE_CASES[request.param], dict(num_targets=2),
                           dict(TRAIN, mve=True, rho_force=0.5))


def test_mve_trajectory_matches_jax(jax_mve_run):
    """5 MVE steps (flat optimizer, as JAX runs MVE by default) against the
    JAX Trainer's: losses, update, EMA, the 8 drained metrics and the EMA
    eval within test_trajectory_matches_jax's gates."""
    trainer, state = check_trajectory(jax_mve_run)
    assert trainer.flat and trainer.mve
    assert all(np.isfinite(jax_mve_run["metrics"][k]) for k in ("energy_nll", "force_var"))


def test_mve_train_run(tmp_path):
    """train.run with mve and num_targets=2 from the config dict: the 8 MVE
    metrics' best values, finite."""
    from gemnet_pytorch_tpu_torch import train

    config = dict(TINY, triplets_only=True, direct_forces=True, num_targets=2, mve=True,
                  batch_size=8, evaluation_interval=2, save_interval=2, warmup_steps=1,
                  data_seed=0, num_steps=2, restart=str(tmp_path / "run"))
    best = train.run(config, device="cpu", synthetic_molecules=16)
    assert {"energy_nll_val_best", "force_var_val_best", "loss_val_best"} <= set(best)
    assert all(np.isfinite(v) for v in best.values())


def test_eval_step_fn_on_cpu(synthetic_npz):
    """On a CPU trainer eval_step_fn() and predict_fn() run the eager eval
    and predict: their results equal eval_step's, predict's and
    test_on_batch's, on the EMA and the current weights of an MVE
    trainer."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Metrics, Trainer

    batch_np = next(_provider(synthetic_npz, True, False).get_dataset("train", prefetch_workers=0))
    model = GemNet(ModelConfig(num_targets=2, **ALL_VARIANTS["dT"], **TINY),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(model, TrainConfig(**dict(TRAIN, mve=True, ema_decay=0.5)))
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_on_batch(state, batch_np, 1.0)
    batch = to_torch(batch_np, "cpu")
    losses = {}
    for use_ema in (True, False):
        metrics, counts = trainer.eval_step_fn()(state, batch_np, use_ema)
        want, want_counts = trainer.eval_step(state, batch, use_ema)
        assert list(metrics) == trainer.tracked_metrics
        for k in want:
            assert torch.equal(metrics[k], want[k]), k
        assert all(torch.equal(counts[k], want_counts[k]) for k in counts)
        m = Metrics("val", trainer.tracked_metrics)
        losses[use_ema] = trainer.test_on_batch(state, batch_np, m, use_ema)
        assert losses[use_ema] == float(want["loss"])
        for a, b in zip(trainer.predict_fn()(state, batch_np, use_ema),
                        trainer.predict(state, batch, use_ema)):
            assert torch.equal(a, b)
    assert losses[True] != losses[False]
    assert next(trainer.model.parameters()).data_ptr() == state.params.data_ptr()


def test_scaling_factor_is_one_multiply_outside_fitting():
    """Outside `collect_stats` a factor runs exactly one aten op (the
    multiply), whatever it is given: the normal paths pay nothing for the
    fitting statistics."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from gemnet_pytorch_tpu_torch.models.layers import ScalingFactor

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    factor = ScalingFactor("OutBlock_0_sum")
    y, x = torch.randn(6, 4), torch.randn(9, 4)
    mask_x, mask_y = torch.arange(9) < 7, torch.arange(6) < 5
    with Record():
        out = factor(y, x, mask_x, mask_y)
    assert seen == ["aten.mul.Tensor"] and factor.stats is None
    assert torch.equal(out, y)
