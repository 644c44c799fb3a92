"""remat_blocks in the port: tests/test_remat.py's contract (E/F within
rtol 1e-6, the parameter gradients of |E| + |F| through the -dE/dR force
path within rtol 1e-5, atol 1e-6) against the unremat'd port, and E/F
within rtol 1e-6 (atol 1e-6 of the largest value) of JAX with remat and
each gradient within rtol 1e-5, atol 1e-6 of JAX's too, or, on a leaf
where the unremat'd port's own summation orders already part further from
JAX's, no further than the unremat'd port's, which stays within the
port-vs-JAX gradient gate of tests/test_torch_model.py (rtol 1e-4, atol
1e-5); GemNet-T and -Q, the state dict unchanged; and a Trainer step with
remat against one without, with the recomputation's K1 calls in its
kernel census."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# tests/test_remat.py's config
WIDTHS = dict(num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16,
              emb_size_edge=16, emb_size_trip=8, emb_size_quad=4, emb_size_rbf=4,
              emb_size_cbf=4, emb_size_sbf=4, emb_size_bil_quad=4, emb_size_bil_trip=8)


def _batch(triplets_only):
    """tests/test_remat.py's batch: one 8-atom molecule, its padded dims."""
    from gemnet_pytorch_tpu_torch.data import PadDims, build_graph, pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    Z, R = random_molecule(np.random.default_rng(0), 8)
    g = build_graph(R, np.array([8]), 5.0, 10.0, triplets_only=triplets_only)
    q = 0 if triplets_only else 1
    dims = PadDims(n_mol=1, n_atoms=16, n_edges=128, n_triplets=512, kmax3=8,
                   n_int_edges=64 * q, n_intm=512 * q, n_quads=512 * q,
                   kmax4=8 * q).grow_to(scale_graph_dims(g, 1.1), 1, 8)
    return pad_batch(g, Z, R, dims, triplets_only=triplets_only)


def _loss_grads(model, batch):
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    E, F = energy_and_forces(model, batch, create_graph=True)
    loss = E.abs().sum() + F.abs().sum()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return (E.detach().numpy(), F.detach().numpy(),
            {name: g.numpy() for (name, _), g in zip(model.named_parameters(), grads)})


@pytest.mark.parametrize("triplets_only", [True, False], ids=["T", "Q"])
def test_remat_matches_unremat_and_jax(triplets_only):
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.compat import import_reference_state_dict
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import energy_and_forces as jax_ef
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import export_reference_state_dict, state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.models.scaling import scaling_factors

    kw = dict(WIDTHS, triplets_only=triplets_only, direct_forces=False)
    cfg = ModelConfig(**kw)
    batch_np = _batch(triplets_only)
    # the port's weights from a seed, with non-unit scale factors, carried
    # into the JAX model's variables (a template of its shapes)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    for factor in scaling_factors(model).values():
        factor.scale_factor.fill_(float(rng.uniform(0.5, 2.0)))
    sd = model.state_dict()
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jmodel = make_model(JaxConfig(**kw, remat_blocks=True))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jbatch))
    variables = import_reference_state_dict(
        {k: v.numpy() for k, v in export_reference_state_dict(model, cfg).items()}, template)

    def jax_loss(params):
        E, F, _ = jax_ef(jmodel, {**variables, "params": params}, jbatch)
        return jnp.sum(jnp.abs(E)) + jnp.sum(jnp.abs(F)), (E, F)

    grads, (E_j, F_j) = jax.jit(jax.grad(jax_loss, has_aux=True))(variables["params"])
    g_j = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grads),
         "scale_factors": variables["scale_factors"]}, cfg)

    runs = {}
    for remat in (False, True):
        model = GemNet(ModelConfig(**kw, remat_blocks=remat),
                       generator=torch.Generator().manual_seed(1), device="cpu")
        model.load_state_dict(sd, strict=True)
        runs[remat] = (list(model.state_dict()), _loss_grads(model, to_torch(batch_np, "cpu")))
    assert runs[True][0] == runs[False][0]  # the state dict's keys, in order

    E0, F0, g0 = runs[False][1]
    E1, F1, g1 = runs[True][1]
    for ref in ((E0, F0), (np.asarray(E_j), np.asarray(F_j))):
        for port, r in zip((E1, F1), ref):
            np.testing.assert_allclose(port, r, rtol=1e-6, atol=1e-6 * np.abs(r).max())
    assert g1.keys() == g0.keys()

    def gap(g, ref):
        """The largest |g - ref| in units of rtol 1e-5, atol 1e-6."""
        return float(np.max(np.abs(g - ref) / (1e-6 + 1e-5 * np.abs(ref)), initial=0.0))

    for name in g0:
        ref = g_j[name].numpy()
        np.testing.assert_allclose(g1[name], g0[name], rtol=1e-5, atol=1e-6, err_msg=name)
        assert gap(g1[name], ref) <= max(1.0, gap(g0[name], ref)), name
        np.testing.assert_allclose(g0[name], ref, rtol=1e-4, atol=1e-5, err_msg=name)


def test_remat_trainer_step():
    """A Trainer step with remat against one without, from the same
    weights: losses and the parameter update within test_torch_train.py's
    gates (rtol 1e-4, relative L2 1e-3); the step's census holds 16 more
    K1 calls (each block's forward again in the -dE/dR backward and in the
    loss's backward: 2 bilinears x 4 blocks x 2) and the same K2 and K3."""
    from test_torch_train import _rel_l2

    from gemnet_pytorch_tpu_torch import bench
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.perf import roofline
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = ModelConfig(**dict(WIDTHS, num_blocks=4))
    batch_np, _, _ = bench.padded_batch(cfg, bench.molecules("small")[:2])
    batch = to_torch(batch_np, "cpu")
    out = {}
    for remat in (False, True):
        model = GemNet(dataclasses.replace(cfg, remat_blocks=remat),
                       generator=torch.Generator().manual_seed(0), device="cpu")
        trainer = Trainer(model, TrainConfig())
        state = trainer.init_state()
        p0 = state.params.clone()
        census = roofline.kernel_census(trainer.train_step, state, batch, 1.0)
        losses = [float(trainer.train_step(state, batch, 1.0)[1]["loss"])]
        out[remat] = (collections.Counter(r["fn"] for r in census), losses,
                      (state.params - p0).numpy())
    (c0, l0, u0), (c1, l1, u1) = out[False], out[True]
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    assert _rel_l2(u1, u0) < 1e-3
    k1 = "gemnet_segment_outer_sum_f32"
    assert c1[k1] == c0[k1] + 16 and c0[k1] == 24
    assert {k: v for k, v in c1.items() if k != k1} == {k: v for k, v in c0.items() if k != k1}
