"""dp x tp (`gemnet_pytorch_tpu_torch/parallel/tp.py` over a 2-D mesh,
`mesh.make_hybrid_mesh(2, 2)`, its rows the tp groups) on a spawned gloo
group of 4 ranks, against JAX's single-device step, as tests/test_dp_tp.py
holds JAX's:

- one step on tests/test_dp_tp.py's two batches (one a dp row) against
  JAX's `make_dp_tp_train_step` run unpartitioned on the stacked batches
  (tests/test_dp_tp.py:68-80's gates: loss rtol 2e-5, parameters rtol
  3e-4 atol 3e-6), the merged parameters the same bits on every rank;
- a second step stays sharded (tests/test_dp_tp.py:95-109): every rank's
  parameters, EMA and moments of a sharded parameter its slice
  (`check_tp_opt_sharding`), the slices of one tp index the same bits on
  both dp rows, the replicated tensors on all four.

tests/test_dp_tp.py's first test runs a 2x4 mesh; here 2x2, as 8 spawned
CPU processes would cost the suite too much. The weights are JAX's, from
`test_torch_tp.init_variables`, carried by `compat.state_dict_from_jax`."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_halo import jax_variables, load_payload, spawn
from test_torch_tp import init_variables, jax_cfg, port_cfg

torch.set_num_threads(2)

MESH = (2, 2)  # (n_dp, n_tp)
# tests/test_dp_tp.py:35's TrainConfig
TRAIN = dict(weight_decay=2e-6, flat_optimizer=False, rho_force=0.9)
STEPS = 2


def dp_batches(jcfg) -> list:
    """tests/test_dp_tp.py::_setup's batches: 2 molecules of up to 7 atoms
    for seeds 0 and 1, at one PadDims."""
    from __graft_entry__ import _make_graphs, _pad, _shared_dims

    tups = [_make_graphs(jcfg, n_molecules=2, seed=s, max_atoms=7) for s in range(MESH[0])]
    dims = _shared_dims(jcfg, tups)
    return [_pad(jcfg, t, dims) for t in tups]


@pytest.fixture(scope="module")
def references():
    """GemNet-Q's weights (a port state dict), the dp rows' batches, and 2
    steps of JAX's dp x tp step run unpartitioned: after each, the loss, the
    molecule count and the parameters (a port state dict)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.parallel.tp import make_dp_tp_train_step, stack_dp_batches
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    jcfg = jax_cfg("Q")
    cfg = port_cfg(jcfg)
    sd = state_dict_from_jax(init_variables(), cfg)
    jv = jax_variables(sd, cfg)
    shards = dp_batches(jcfg)
    trainer = JaxTrainer(make_model(jcfg), JaxTrainConfig(**TRAIN))
    state = trainer.init_state(jv)
    mesh = Mesh(np.array(jax.devices()[:MESH[0] * MESH[1]]).reshape(MESH), ("dp", "tp"))
    step = make_dp_tp_train_step(trainer, mesh)
    batch = {k: jnp.asarray(v) for k, v in stack_dp_batches(shards).items()}
    steps = []
    for _ in range(STEPS):
        state, metrics, counts = step(state, batch, jnp.asarray(1.0))
        params = jax.tree_util.tree_map(np.asarray, trainer.params_tree(state.params))
        steps.append(dict(loss=float(metrics["loss"]), n_mol=float(counts["n_mol"]),
                          params=state_dict_from_jax(
                              {"params": params, "scale_factors": jv["scale_factors"]}, cfg)))
    return dict(cfg=dataclasses.asdict(cfg), sd=sd, shards=shards, steps=steps)


def _dp_tp_rank(rank, world, directory, group):
    """This rank's dp x tp run: its place, and after each step the loss,
    the molecule count, the merged parameters and the rank's slices, with
    the collectives each step issued."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import collectives, mesh, tp

    payload = load_payload(directory)
    hmesh = mesh.make_hybrid_mesh(*MESH, group)
    model = tp.TPModel(ModelConfig(**payload["cfg"]), hmesh,
                       generator=torch.Generator().manual_seed(0), device="cpu")
    trainer = tp.TPTrainer(model, TrainConfig(**TRAIN))
    state = tp.init_tp_state(trainer, payload["sd"])
    step = tp.make_dp_tp_train_step(trainer, hmesh)
    batch = tp.shard_dp_batch(tp.stack_dp_batches(payload["shards"]), hmesh, "cpu")
    out = {"place": (hmesh.dp_index, hmesh.tp_index), "specs": model.tp_specs, "steps": []}
    for _ in range(STEPS):
        with collectives.recorded() as seq:
            state, metrics, counts = step(state, batch, 1.0)
        tp.check_tp_opt_sharding(trainer, state)
        out["steps"].append(dict(
            loss=float(metrics["loss"]), n_mol=float(counts["n_mol"]), seq=seq,
            params=tp.merged_state_dict(trainer, state),
            local={n: p.detach().clone() for n, p in model.named_parameters()},
            moments={n: t.shape for n, t in state.opt_state.nu.items()},
            ema=state.ema_params.clone()))
    return out


@pytest.fixture(scope="module")
def dp_tp(references, tmp_path_factory):
    payload = {k: references[k] for k in ("cfg", "sd", "shards")}
    return spawn(_dp_tp_rank, MESH[0] * MESH[1], tmp_path_factory.mktemp("dp_tp"),
                 payload=payload)


def test_dp_tp_train_step_matches_single_device(dp_tp, references):
    """Each rank at its (dp, tp) place; the first step's loss (rtol 2e-5)
    and molecule count against JAX's step on the union of the rows'
    batches, the merged parameters (rtol 3e-4, atol 3e-6) too, the same
    bits on every rank; every rank's collectives one sequence."""
    ref = references["steps"][0]
    first = dp_tp[0]["steps"][0]
    for r, res in enumerate(dp_tp):
        assert res["place"] == divmod(r, MESH[1])
        got = res["steps"][0]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
        assert got["n_mol"] == ref["n_mol"]
        assert [k for k, _, _ in got["seq"]] == [k for k, _, _ in first["seq"]]
        for name, t in got["params"].items():
            assert torch.equal(t, first["params"][name]), name
    assert sorted(first["params"]) == sorted(ref["params"])
    for name, want in ref["params"].items():
        np.testing.assert_allclose(first["params"][name].numpy(), want.numpy(), rtol=3e-4,
                                   atol=3e-6, err_msg=name)


def test_dp_tp_second_step_stays_sharded(dp_tp, references):
    """After the second step (its loss against JAX's, rtol 2e-5): every
    rank's moments of a sharded parameter its slice, the slices of one tp
    index the same bits on both dp rows, the replicated tensors and the
    EMA of one tp index too; the two tp indices hold different slices."""
    np.testing.assert_allclose([res["steps"][1]["loss"] for res in dp_tp],
                               [references["steps"][1]["loss"]] * len(dp_tp), rtol=2e-5)
    specs = dp_tp[0]["specs"]
    for r, res in enumerate(dp_tp):
        got = res["steps"][1]
        twin = dp_tp[(r + MESH[1]) % len(dp_tp)]["steps"][1]  # same tp index, other dp row
        assert torch.equal(got["ema"], twin["ema"])
        for name, t in got["local"].items():
            assert torch.equal(t, twin["local"][name]), name
            assert got["moments"][name] == t.shape
            if specs[name] is None:
                assert torch.equal(t, dp_tp[0]["steps"][1]["local"][name]), name
            else:
                assert t.shape[specs[name]] * MESH[1] == got["params"][name].shape[specs[name]]
    sharded = [n for n, d in specs.items() if d is not None]
    assert any(not torch.equal(dp_tp[0]["steps"][1]["local"][n], dp_tp[1]["steps"][1]["local"][n])
               for n in sharded)
