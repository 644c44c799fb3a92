"""The port's data parallelism (`gemnet_pytorch_tpu_torch/parallel/dp.py`)
on a spawned gloo group of 2 ranks on the CPU, as tests/test_multichip.py
holds the JAX package's: every rank owns a shard of 2 molecules, and

- the all-reduced gradient of the local-numerator / global-denominator loss
  equals the gradient of the single-device loss on the merged batch;
- the step's metrics are the global masked means, its counts global;
- MVE's variance metrics are global too;
- the dp predict of each shard equals the single-device predict, and
  `gather=True` stacks them in rank order;
- the eval of a group padded with a `zero_masks` row reports the real
  shard's single-device metrics;
- one flat, one per-tensor and one AGC step each equal the single-device
  step on the merged batch.

Each case is held against two oracles: the JAX package's single-device
Trainer on the CPU (the parent computes it from the same weights and the
same molecules; the children import no JAX), and the port's single-device
path on the merged batch, which has no summation-order distance from JAX to
hide a difference in."""

import numpy as np
import pytest
import torch

from test_torch_halo import jax_variables, load_payload, spawn
from test_torch_train import TINY, TRAIN, _rel_l2

torch.set_num_threads(2)

WORLD = 2
DT = dict(triplets_only=True, direct_forces=True)
# tests/test_multichip.py's shard layout: 2 molecules a shard, one PadDims
SHARD_DIMS = dict(n_mol=2, n_atoms=32, n_edges=256, n_triplets=1024, kmax3=12)
MERGED_DIMS = dict(n_mol=2 * WORLD, n_atoms=32 * WORLD, n_edges=256 * WORLD,
                   n_triplets=1024 * WORLD, kmax3=12)
STEP_MODES = {"flat": {}, "tree": dict(flat_optimizer=False), "agc": dict(agc=True)}
# one step from the same state: the relative L2 error of the update (an
# Adam first step moves a weight by ~lr·sign(g), and a gradient within
# summation-order error of zero may take either sign; the three modes read
# 1.2e-6 to 1.5e-6 here)
UPDATE_REL_L2 = 1e-5
# the same against JAX's step: tests/test_torch_train.py's bound for a
# trajectory against JAX (autograd vs XLA sum in other orders)
JAX_UPDATE_REL_L2 = 1e-3


def _model(sd, num_targets=1):
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    model = GemNet(ModelConfig(**DT, **TINY, num_targets=num_targets),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model


def _trainer(sd, num_targets=1, **train_kw):
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.training import Trainer

    trainer = Trainer(_model(sd, num_targets), TrainConfig(**dict(TRAIN, **train_kw)))
    return trainer, trainer.init_state()


def _flat_grad(trainer, batch, group=None):
    """The training step's gradient (`flat_gradient`), in buffer order."""
    from gemnet_pytorch_tpu_torch.training.trainer import flat_gradient

    loss, _ = trainer._loss_and_metrics(batch, group, create_graph=True)
    return flat_gradient(loss, list(trainer.model.parameters()), group).numpy().copy()


def _host(x):
    return {k: float(v) for k, v in x.items()}


def _dp_rank(rank, world, directory, group):
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import dp

    payload = load_payload(directory)
    shards, sd = payload["shards"], payload["sd"]
    local = dp.shard_batch_to_mesh(dp.stack_shards(shards), group)
    out = {}
    trainer, state = _trainer(sd)
    out["grad"] = _flat_grad(trainer, to_torch(local, "cpu"), group)
    E, F = dp.make_dp_predict_fn(trainer.model, group)(to_torch(local, "cpu"), gather=True)
    out["predict"] = (E.detach().numpy(), F.detach().numpy())
    row = trainer.packer.pack(shards[0])
    rows = np.stack([row, trainer.packer.zero_masks(row)])
    metrics, counts = dp.make_dp_eval_step(trainer, group)(
        state, dp.shard_batch_to_mesh(rows, group))
    out["eval"] = (_host(metrics), _host(counts))
    for mode, kw in STEP_MODES.items():
        trainer, state = _trainer(sd, **kw)
        p0 = state.params.clone()
        state, metrics, counts = dp.make_dp_train_step(trainer, group)(state, local, 1.0)
        out[mode] = ((state.params - p0).numpy(), _host(metrics), _host(counts))
    trainer, state = _trainer(payload["sd_mve"], num_targets=2, mve=True)
    _, metrics, counts = dp.make_dp_train_step(trainer, group)(state, local, 1.0)
    out["mve"] = (_host(metrics), _host(counts))
    return out


@pytest.fixture(scope="module")
def dp_run(synthetic_npz, tmp_path_factory):
    """The shards, the merged batch, the weights, and every dp case on one
    spawned group."""
    from gemnet_pytorch_tpu_torch.data import DataContainer, PadDims

    c = DataContainer(synthetic_npz, cutoff=5.0, int_cutoff=10.0, triplets_only=True)
    shards = [c.get_padded([2 * s, 2 * s + 1], PadDims(**SHARD_DIMS)) for s in range(WORLD)]
    merged = c.get_padded(list(range(2 * WORLD)), PadDims(**MERGED_DIMS))
    sd = {k: v.clone() for k, v in _model(None).state_dict().items()}
    sd_mve = {k: v.clone() for k, v in _model(None, num_targets=2).state_dict().items()}
    results = spawn(_dp_rank, WORLD, tmp_path_factory.mktemp("dp"),
                    payload=dict(shards=shards, sd=sd, sd_mve=sd_mve))
    return dict(shards=shards, merged=merged, sd=sd, sd_mve=sd_mve, results=results)


@pytest.fixture(scope="module")
def jax_ref(dp_run, synthetic_npz):
    """The JAX package's single-device results on the same molecules and
    weights: the loss gradient, the step's metrics and each mode's update
    on the merged batch, MVE's metrics, each shard's predict and shard 0's
    eval; parameters and gradients in the port's buffer order."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxModelConfig
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.data import DataContainer as JaxContainer
    from gemnet_pytorch_tpu.data.padding import PadDims as JaxPadDims
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    c = JaxContainer(synthetic_npz, cutoff=5.0, int_cutoff=10.0, triplets_only=True)

    def dev(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    shards = [dev(c.get_padded([2 * s, 2 * s + 1], JaxPadDims(**SHARD_DIMS)))
              for s in range(WORLD)]
    merged = dev(c.get_padded(list(range(2 * WORLD)), JaxPadDims(**MERGED_DIMS)))

    def setup(sd, num_targets=1, **train_kw):
        cfg = ModelConfig(**DT, **TINY, num_targets=num_targets)
        variables = jax_variables(sd, cfg)
        model = make_model(JaxModelConfig(**DT, **TINY, num_targets=num_targets))
        trainer = JaxTrainer(model, JaxTrainConfig(**dict(TRAIN, **train_kw)))
        names = [n for n, _ in _model(sd, num_targets).named_parameters()]

        def port_order(params):
            tree = trainer.params_tree(params) if trainer.flat else params
            tree = jax.tree_util.tree_map(np.asarray, tree)
            out = state_dict_from_jax({"params": tree,
                                       "scale_factors": variables["scale_factors"]}, cfg)
            return np.concatenate([out[n].numpy().reshape(-1) for n in names])

        return model, variables, trainer, trainer.init_state(variables), port_order

    out = {}
    model, variables, trainer, state, port_order = setup(dp_run["sd"])
    grad = jax.jit(jax.grad(lambda p: trainer._loss_and_metrics(p, state.scales, merged)[0]))
    out["grad"] = port_order(grad(state.params))
    predict = jax.jit(lambda b: energy_and_forces(model, variables, b)[:2])
    out["predict"] = [tuple(np.asarray(t) for t in predict(b)) for b in shards]
    metrics, counts = trainer.eval_step_fn()(state.params, state.scales, shards[0])
    out["eval"] = (_host(metrics), _host(counts))
    for mode, kw in STEP_MODES.items():
        _, _, trainer, state, port_order = setup(dp_run["sd"], **kw)
        new, metrics, counts = trainer.train_step_fn()(state, merged, jnp.float32(1.0))
        out[mode] = (port_order(new.params) - port_order(state.params), _host(metrics),
                     _host(counts))
    _, _, trainer, state, _ = setup(dp_run["sd_mve"], num_targets=2, mve=True)
    _, metrics, counts = trainer.train_step_fn()(state, merged, jnp.float32(1.0))
    out["mve"] = (_host(metrics), _host(counts))
    return out


def _single_metrics(trainer, state, batch):
    metrics, counts = trainer.eval_step(state, _tensors(batch))
    return _host(metrics), _host(counts)


def _tensors(batch):
    from gemnet_pytorch_tpu_torch.data import to_torch

    return to_torch(batch, "cpu")


def test_dp_grads_match_merged_batch(dp_run, jax_ref):
    """The all-reduced dp gradient == JAX's single-device gradient of the
    same global loss on the merged batch, and the port's (tests/
    test_multichip.py's rtol 2e-4, atol 1e-6), the same on both ranks."""
    trainer, _ = _trainer(dp_run["sd"])
    ref = _flat_grad(trainer, _tensors(dp_run["merged"]))
    g0 = dp_run["results"][0]["grad"]
    np.testing.assert_allclose(g0, jax_ref["grad"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(g0, ref, rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(dp_run["results"][1]["grad"], g0)


def test_dp_metrics_are_global_masked_means(dp_run, jax_ref):
    """The dp step's metrics == JAX's and the port's single-device metrics
    of the merged batch (rtol 1e-5), its counts the merged batch's, on both
    ranks."""
    trainer, state = _trainer(dp_run["sd"])
    ref_m, ref_c = _single_metrics(trainer, state, dp_run["merged"])
    jax_m, jax_c = jax_ref["flat"][1:]
    assert ref_c == jax_c
    for res in dp_run["results"]:
        _, metrics, counts = res["flat"]
        for k, v in ref_m.items():
            np.testing.assert_allclose(metrics[k], jax_m[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(metrics[k], v, rtol=1e-5, err_msg=k)
        assert counts == ref_c


def test_dp_mve_var_metrics_are_global(dp_run, jax_ref):
    """MVE: energy_var and force_var (and every other metric) are the global
    num/den ratios, not a rank's own: JAX's and the port's single-device
    metrics of the merged batch (tests/test_multichip.py's rtol 1e-5)."""
    trainer, state = _trainer(dp_run["sd_mve"], num_targets=2, mve=True)
    ref_m, ref_c = _single_metrics(trainer, state, dp_run["merged"])
    shard_m, _ = _single_metrics(trainer, state, dp_run["shards"][0])
    jax_m, jax_c = jax_ref["mve"]
    assert ref_c == jax_c
    for res in dp_run["results"]:
        metrics, counts = res["mve"]
        for k in ("energy_var", "force_var", "energy_nll", "force_nll", "loss"):
            np.testing.assert_allclose(metrics[k], jax_m[k], rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(metrics[k], ref_m[k], rtol=1e-5, err_msg=k)
        assert counts == ref_c
    assert not np.isclose(shard_m["force_var"], ref_m["force_var"], rtol=1e-5)


def test_dp_predict_matches_single_device(dp_run, jax_ref):
    """Each rank's predict == JAX's and the port's single-device predict of
    its shard (1e-5), gathered in rank order."""
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    model = _model(dp_run["sd"])
    E, F = dp_run["results"][0]["predict"]
    assert E.shape[0] == WORLD and F.shape[0] == WORLD
    for s, shard in enumerate(dp_run["shards"]):
        E1, F1 = energy_and_forces(model, _tensors(shard))
        for refE, refF in ((E1.detach().numpy(), F1.detach().numpy()), jax_ref["predict"][s]):
            np.testing.assert_allclose(E[s], refE, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(F[s], refF, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(dp_run["results"][1]["predict"][0], E)


def test_dp_eval_with_zero_mask_padding(dp_run, jax_ref):
    """A group of one real shard and one `zero_masks` row reports JAX's and
    the port's single-device metrics of the real shard (rtol 2e-5) and
    counts: the pad adds zero to every num/den pair."""
    trainer, state = _trainer(dp_run["sd"])
    ref_m, ref_c = _single_metrics(trainer, state, dp_run["shards"][0])
    jax_m, jax_c = jax_ref["eval"]
    assert ref_c == jax_c
    for res in dp_run["results"]:
        metrics, counts = res["eval"]
        for k, v in ref_m.items():
            np.testing.assert_allclose(metrics[k], jax_m[k], rtol=2e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(metrics[k], v, rtol=2e-5, atol=1e-7, err_msg=k)
        assert counts == ref_c


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_dp_step_matches_merged_batch(dp_run, jax_ref, mode):
    """One dp step (flat optimizer, per-tensor optimizer, AGC) == JAX's
    single-device step on the merged batch (the update within
    JAX_UPDATE_REL_L2) and the port's (within UPDATE_REL_L2), the loss
    within rtol 1e-5 of both, and the same update on both ranks."""
    trainer, state = _trainer(dp_run["sd"], **STEP_MODES[mode])
    p0 = state.params.clone()
    state, metrics, _ = trainer.train_step(state, _tensors(dp_run["merged"]), 1.0)
    ref = (state.params - p0).numpy()
    jax_upd, jax_m, _ = jax_ref[mode]
    upd, m, _ = dp_run["results"][0][mode]
    assert np.abs(ref).max() > 0 and np.abs(jax_upd).max() > 0
    assert _rel_l2(upd, jax_upd) <= JAX_UPDATE_REL_L2, _rel_l2(upd, jax_upd)
    assert _rel_l2(upd, ref) <= UPDATE_REL_L2, _rel_l2(upd, ref)
    np.testing.assert_allclose(m["loss"], jax_m["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["loss"], float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(dp_run["results"][1][mode][0], upd)
