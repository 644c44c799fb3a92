"""The port's per-tensor optimizer (`training/tree_opt.py`) against the JAX
package's optax tree mode on the CPU: `adaptive_gradient_clip` on carried
parameters with both `compat_reference` settings (the unit axis of the
port's (out, in) Dense weights held against JAX's (in, out) kernels),
`scale_shared_grads`, 5-step trajectories at `flat_optimizer=False` with and
without weight decay and with AGC, and tree-mode and AGC checkpoints that
resume bit for bit."""

import numpy as np
import pytest
import torch

from test_torch_mve import ALL_VARIANTS, _jax_variables, _port_sd, check_trajectory, run_jax_trainer
from test_torch_train import TINY, TRAIN, _provider

torch.set_num_threads(2)

# AGC's clip factor is grad_clip_max; at 0.02 some units of every kind clip
# and others do not (test_agc_matches_jax asserts both)
AGC_CLIP = 0.02


def _carried(synthetic_npz, variant, seed=0):
    """A JAX model.init's params and seeded random gradients of the same
    tree, with the port's model and both carried over by name."""
    import jax

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    batch = next(_provider(synthetic_npz, variant["triplets_only"], True)
                 .get_dataset("train", prefetch_workers=0))
    variables = _jax_variables(make_model(JaxConfig(**variant, **TINY)), batch, seed=seed)
    rng = np.random.default_rng(seed + 7)
    params = variables["params"]
    # a Dense kernel whose rows and columns have different norms: a unit
    # axis that is the wrong one clips other units
    k = params["mlp_rbf3"]["Dense_0"]["kernel"]
    params["mlp_rbf3"]["Dense_0"]["kernel"] = (
        k * np.linspace(0.2, 3.0, k.shape[0], dtype=np.float32)[:, None]
        * np.linspace(3.0, 0.2, k.shape[1], dtype=np.float32)[None, :])
    grads = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * rng.uniform(0.01, 0.1)).astype(np.float32), params)
    cfg = ModelConfig(**variant, **TINY)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(_port_sd(params, variables, cfg), strict=True)
    return variables, grads, model, cfg


def _named(model, sd):
    return [sd[n] for n, _ in model.named_parameters()]


@pytest.mark.parametrize("compat", [False, True], ids=["nfnet", "compat_reference"])
def test_agc_matches_jax(synthetic_npz, compat):
    """AGC on every parameter of GemNet-dQ (Dense, embedding, 3-D bilinear
    and down-projection weights, the 1-D frequencies, the direct and energy
    heads) equals JAX's on the same carried params and gradients within
    rtol 1e-6; some units clip and some pass in each run, and the heads
    pass (or alone clip, with compat_reference)."""
    from gemnet_pytorch_tpu.training.trainer import adaptive_gradient_clip as jax_agc
    from gemnet_pytorch_tpu_torch.training import tree_opt

    variables, grads, model, cfg = _carried(synthetic_npz, ALL_VARIANTS["dQ"])
    tx = jax_agc(AGC_CLIP, compat_reference=compat)
    ref, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    ref_sd = _port_sd(ref, variables, cfg)
    grad_sd = _port_sd(grads, variables, cfg)
    layout = tree_opt.build_layout(model, cfg)
    params = [p.detach() for p in model.parameters()]
    out = tree_opt.adaptive_gradient_clip(_named(model, grad_sd), params, layout, AGC_CLIP,
                                          compat_reference=compat)
    clipped = passed = 0
    for name, got, g in zip(layout.names, out, _named(model, grad_sd)):
        np.testing.assert_allclose(got.numpy(), ref_sd[name].numpy(), rtol=1e-6, atol=1e-12,
                                   err_msg=name)
        head = "out_energy" in name or "out_forces" in name
        changed = not torch.equal(got, g)
        if head != compat:
            assert not changed, name
        clipped += changed
        passed += not changed
    assert clipped and passed
    # the unit axes: (out, in) Dense weights over dim 1; the rest as JAX
    dims = dict(zip(layout.names, layout.unit_dims))
    assert dims["mlp_rbf3.weight"] == (1,) and dims["out_blocks.0.out_forces.weight"] == (1,)
    assert dims["atom_emb.embeddings.weight"] == (0,)
    assert dims["mlp_sbf4.weight"] == (0, 1) and dims["int_blocks.0.trip_interaction.mlp_cbf.weight"] == (0, 1)
    assert dims["rbf_basis.frequencies"] == ()


def test_agc_unit_axis_is_the_output_unit(synthetic_npz):
    """The Dense weight with row and column norms apart: clipping it over
    dim 0 (JAX's axis on the port's transposed layout) gives another result
    than JAX's, which the per-output-unit norm (dim 1) reproduces."""
    from gemnet_pytorch_tpu.training.trainer import adaptive_gradient_clip as jax_agc
    from gemnet_pytorch_tpu_torch.training import tree_opt

    variables, grads, model, cfg = _carried(synthetic_npz, ALL_VARIANTS["dQ"])
    tx = jax_agc(AGC_CLIP)
    ref, _ = tx.update(grads, tx.init(variables["params"]), variables["params"])
    ref_w = _port_sd(ref, variables, cfg)["mlp_rbf3.weight"]
    g = _port_sd(grads, variables, cfg)["mlp_rbf3.weight"]
    p = model.mlp_rbf3.weight.detach()

    def clip(dims):
        max_norm = torch.clamp_min(tree_opt.unitwise_norm(p, dims), 1e-3) * AGC_CLIP
        g_norm = torch.clamp_min(tree_opt.unitwise_norm(g, dims), 1e-6)
        return torch.where(g_norm < max_norm, g, g * (max_norm / g_norm))

    np.testing.assert_allclose(clip((1,)).numpy(), ref_w.numpy(), rtol=1e-6)
    assert not np.allclose(clip((0,)).numpy(), ref_w.numpy(), rtol=1e-3)


def test_scale_shared_grads_matches_jax(synthetic_npz):
    """Shared basis MLPs over num_blocks, mlp_rbf_out over num_blocks + 1,
    the rest unchanged, as JAX's scale_shared_grads (GemNet-Q)."""
    import jax

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.training.trainer import scale_shared_grads as jax_scale
    from gemnet_pytorch_tpu_torch.training import tree_opt

    variables, grads, model, cfg = _carried(synthetic_npz, ALL_VARIANTS["Q"])
    tx = jax_scale(JaxConfig(**ALL_VARIANTS["Q"], **TINY))
    ref, _ = tx.update(grads, tx.init(variables["params"]))
    ref_sd = _port_sd(jax.tree_util.tree_map(np.asarray, ref), variables, cfg)
    layout = tree_opt.build_layout(model, cfg)
    out = tree_opt.scale_shared_grads(_named(model, _port_sd(grads, variables, cfg)), layout)
    for name, got in zip(layout.names, out):
        np.testing.assert_allclose(got.numpy(), ref_sd[name].numpy(), rtol=1e-7, err_msg=name)
    divs = dict(zip(layout.names, layout.shared_div))
    assert divs["mlp_sbf4.weight"] == cfg.num_blocks
    assert divs["mlp_rbf_out.weight"] == cfg.num_blocks + 1
    assert divs["edge_emb.dense.weight"] == 1


# ---------------------------------------------------------------- trajectories

TREE_CASES = {
    # name: (variant, train config over TRAIN)
    "tree_wd_Q": ("Q", dict(flat_optimizer=False)),
    "tree_no_wd_dT": ("dT", dict(flat_optimizer=False, weight_decay=0.0)),
    "agc_Q": ("Q", dict(agc=True, grad_clip_max=AGC_CLIP)),
    "agc_compat_dT": ("dT", dict(agc=True, agc_compat_reference=True, grad_clip_max=AGC_CLIP)),
}


@pytest.fixture(scope="module", params=list(TREE_CASES))
def jax_tree_run(request, synthetic_npz):
    variant, over = TREE_CASES[request.param]
    return run_jax_trainer(synthetic_npz, ALL_VARIANTS[variant], {}, dict(TRAIN, **over))


def test_tree_trajectory_matches_jax(jax_tree_run):
    """5 steps of the per-tensor chain (weight decay > 0 and == 0, AGC with
    both selections) against the JAX Trainer's optax tree mode, within
    test_trajectory_matches_jax's gates."""
    trainer, state = check_trajectory(jax_tree_run)
    assert not trainer.flat
    assert int(state.opt_state.count) == 5 and int(state.step) == 5
    assert list(state.opt_state.mu) == [n for n, _ in trainer.model.named_parameters()]


@pytest.mark.parametrize("over", [dict(flat_optimizer=False), dict(agc=True, grad_clip_max=0.02)],
                         ids=["tree", "agc"])
def test_tree_checkpoint_resume_bit_for_bit(synthetic_npz, tmp_path, over):
    """4 steps unbroken against 2 steps, a checkpoint, a fresh trainer of
    other weights restored from it, and 2 more steps: params, EMA, every
    moment, the count and the accumulators equal bit for bit; the moments
    are keyed by parameter name."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer, restore_checkpoint, save_checkpoint
    from gemnet_pytorch_tpu_torch.training.checkpoint import state_tensors

    batches = [b for b, _ in zip(_provider(synthetic_npz, False, False)
                                 .get_dataset("train", prefetch_workers=0), range(4))]

    def trainer(seed):
        model = GemNet(ModelConfig(**TINY), generator=torch.Generator().manual_seed(seed),
                       device="cpu")
        return Trainer(model, TrainConfig(**dict(TRAIN, **over)))

    t1 = trainer(0)
    unbroken = t1.init_state()
    for b in batches:
        unbroken, _ = t1.train_on_batch(unbroken, b, 1.0)

    t2 = trainer(0)
    state = t2.init_state()
    for b in batches[:2]:
        state, _ = t2.train_on_batch(state, b, 1.0)
    path = str(tmp_path / "checkpoint")
    save_checkpoint(path, state)
    saved = torch.load(path, weights_only=True)
    assert "opt_state.nu_max.mlp_rbf3.weight" in saved and "opt_state.count" in saved

    t3 = trainer(1)
    resumed, _ = restore_checkpoint(path, t3.init_state())
    for b in batches[2:]:
        resumed, _ = t3.train_on_batch(resumed, b, 1.0)
    want, got = state_tensors(unbroken), state_tensors(resumed)
    assert sorted(want) == sorted(got)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert next(t3.model.parameters()).data_ptr() == resumed.params.data_ptr()
