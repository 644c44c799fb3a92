"""dp x pp (`gemnet_pytorch_tpu_torch/parallel/pp.py` over a 2-D mesh,
`mesh.make_hybrid_mesh(2, 2)`, its rows the pipelines) on a spawned gloo
group of 4 ranks, against the single-device models per (dp row,
microbatch), as tests/test_dp_pp.py holds JAX's:

- E and F (GemNet-dQ and -Q) on every rank against the port's
  single-device model at tests/test_dp_pp.py:52-77's gates (rtol 2e-5, atol
  2e-6) and against JAX's at tests/test_torch_model.py's parity gates, the
  same bits on both ranks of a row;
- the gradients of tests/test_dp_pp.py:80-121's loss (GemNet-Q, -dE/dR,
  summed over the rows and microbatches) against JAX's single-device
  gradient (loss rtol 2e-5; gradients rtol 2e-3, atol 1e-4): the
  preamble's the same on all 4 ranks, each stage's on both ranks of its
  column; every rank's collectives one sequence.

The weights are JAX's (one init, `test_torch_pp.init_variables`), carried
into the port by `compat.state_dict_from_jax`; the microbatches are
tests/test_dp_pp.py's (seeds 7 d + s, 2 molecules of up to 7 atoms)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_halo import load_payload, spawn
from test_torch_pp import case, jax_cfg, jax_loss, molecules, padded, port_cfg, port_single_device

torch.set_num_threads(2)

MESH = (2, 2)  # (n_dp, n_pp)
# microbatches a row: tests/test_dp_pp.py:55 (E/F) and :84 (gradients)
EF_MICRO, GRAD_MICRO = 3, 2
EF_VARIANTS = ("dQ", "Q")


def row_batches(jcfg, n_micro: int) -> list:
    """tests/test_dp_pp.py::_setup's microbatches, dp-row-major, at one
    PadDims."""
    groups = [molecules(7 * d + s) for d in range(MESH[0]) for s in range(n_micro)]
    return padded(jcfg, groups)


@pytest.fixture(scope="module")
def references():
    """Per E/F variant: the port's weights, the microbatches of each row, and
    JAX's and the port's single-device E and F of each; for GemNet-Q the
    loss and gradient (a port state dict) of tests/test_dp_pp.py's loss,
    summed over every microbatch."""
    import jax
    import jax.numpy as jnp
    from test_torch_pp import init_variables

    from gemnet_pytorch_tpu.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    variables = init_variables()
    out = {}
    for variant in EF_VARIANTS:
        jcfg = jax_cfg(variant)
        sd, model, jv, _ = case(variables, jcfg, 1)
        shards = row_batches(jcfg, EF_MICRO)
        apply = jax.jit(lambda v, b: energy_and_forces(model, v, b)[:2])
        ef = [apply(jv, {k: jnp.asarray(x) for k, x in b.items()}) for b in shards]
        ref = dict(sd=sd, shards=shards,
                   ef=tuple(np.stack([np.asarray(o[i]) for o in ef]) for i in range(2)))
        ref["port"] = port_single_device(ref, jcfg)
        out[variant] = ref
    jcfg = jax_cfg("Q")
    sd, model, jv, _ = case(variables, jcfg, 1)
    shards = row_batches(jcfg, GRAD_MICRO)

    def one_loss(params, b):
        E, F, _ = energy_and_forces(model, {"params": params,
                                            "scale_factors": jv["scale_factors"]}, b)
        return jax_loss(E, F, b)

    value_and_grad = jax.jit(jax.value_and_grad(one_loss))
    loss, grad = 0.0, None
    for b in shards:
        v, g = value_and_grad(jv["params"], {k: jnp.asarray(x) for k, x in b.items()})
        loss += float(v)
        g = jax.tree_util.tree_map(np.asarray, g)
        grad = g if grad is None else jax.tree_util.tree_map(np.add, grad, g)
    out["grad"] = dict(sd=sd, shards=shards, loss=loss, grad=state_dict_from_jax(
        {"params": grad, "scale_factors": jv["scale_factors"]}, port_cfg(jcfg)))
    return out


def _dp_pp_rank(rank, world, directory, group):
    """This rank's row of every case: E/F per variant, and the loss and
    gradients of the force loss, with the collectives each issued."""
    from test_torch_pp import _loss

    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import collectives, mesh, pp

    payload = load_payload(directory)
    hmesh = mesh.make_hybrid_mesh(*MESH, group)
    out = {"place": (hmesh.dp_index, hmesh.pp_index)}
    for key, c in payload.items():
        cfg = ModelConfig(**c["cfg"])
        stage = pp.PipelineStage(cfg, hmesh.pp_index, hmesh.n_pp,
                                 generator=torch.Generator().manual_seed(0), device="cpu")
        pre, stages = pp.split_pp_state_dict(c["sd"], cfg.num_blocks, hmesh.n_pp)
        stage.load_state_dict({**pre, **stages[hmesh.pp_index]}, strict=True)
        m = len(c["shards"]) // MESH[0]
        batches = [to_torch(b, "cpu") for b in c["shards"][hmesh.dp_index * m:
                                                           (hmesh.dp_index + 1) * m]]
        with collectives.recorded() as seq:
            if key == "grad":
                loss, grads = pp.make_pp_loss_and_grad(stage, hmesh, _loss)(batches)
                out[key] = (float(loss), {k: g.numpy().copy() for k, g in grads.items()}, seq)
            else:
                E, F = pp.make_pp_energy_and_forces(stage, hmesh)(batches)
                out[key] = (E.detach().numpy(), F.detach().numpy(), seq)
    return out


@pytest.fixture(scope="module")
def dp_pp(references, tmp_path_factory):
    payload = {k: dict(cfg=dataclasses.asdict(port_cfg(jax_cfg("Q" if k == "grad" else k))),
                       sd=r["sd"], shards=r["shards"]) for k, r in references.items()}
    return spawn(_dp_pp_rank, MESH[0] * MESH[1], tmp_path_factory.mktemp("dp_pp"),
                 payload=payload)


@pytest.mark.parametrize("variant", EF_VARIANTS)
def test_dp_pp_matches_single_device(dp_pp, references, variant):
    """Each rank at its (dp, pp) place; E and F of its row's microbatches
    against the port's single-device model (tests/test_dp_pp.py:52-77's
    gates) and JAX's (the parity gates), the same bits on both ranks of a
    row; the collectives of every rank one sequence."""
    ref = references[variant]
    direct = variant.startswith("d")
    for r, res in enumerate(dp_pp):
        d, s = res["place"]
        assert (d, s) == divmod(r, MESH[1])
        E, F, seq = res[variant]
        rows = slice(d * EF_MICRO, (d + 1) * EF_MICRO)
        for got, mono in zip((E, F), ref["port"]):
            np.testing.assert_allclose(got, mono[rows], rtol=2e-5, atol=2e-6)
        for got, jax_ref, tol in zip((E, F), ref["ef"], (2e-4, 2e-4 if direct else 5e-4)):
            np.testing.assert_allclose(got, jax_ref[rows], rtol=tol, atol=tol)
        first = dp_pp[d * MESH[1]][variant]
        np.testing.assert_array_equal(E, first[0])
        np.testing.assert_array_equal(F, first[1])
        assert seq == dp_pp[0][variant][2]


def test_dp_pp_gradients_match_single_device(dp_pp, references):
    """The loss summed over both rows (rtol 2e-5) and each parameter's
    gradient (rtol 2e-3, atol 1e-4) against JAX's single-device gradient
    summed over all 4 microbatches; the preamble's the same on every rank,
    each stage's on both ranks of its dp column; one sequence of
    collectives on every rank."""
    ref = references["grad"]
    merged = {}
    for res in dp_pp:
        loss, grads, seq = res["grad"]
        np.testing.assert_allclose(loss, ref["loss"], rtol=2e-5)
        assert seq == dp_pp[0]["grad"][2]
        for name, g in grads.items():
            if name in merged:
                np.testing.assert_array_equal(g, merged[name], err_msg=name)
            merged[name] = g
    assert sorted(merged) == sorted(k for k in ref["grad"] if not k.endswith("scale_factor"))
    for name, g in merged.items():
        np.testing.assert_allclose(g, ref["grad"][name].numpy(), rtol=2e-3, atol=1e-4,
                                   err_msg=name)
