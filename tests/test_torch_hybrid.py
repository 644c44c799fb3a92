"""The port's 2-D meshes (`gemnet_pytorch_tpu_torch/parallel/mesh.py::
make_hybrid_mesh`, `parallel/hybrid.py`) against the JAX package on the CPU,
as tests/test_hybrid.py holds JAX's:

- `build_hybrid_batch` (dp x ep, its common chunk) and `build_dp_halo_batch`
  (dp x halo, its common HaloPads) equal JAX's array for array;
- on a spawned gloo group of 4 ranks as a 2x2 mesh: each rank's place and
  sub-groups (rank = dp_index * 2 + ep_index); the dp x ep loss and
  gradients of tests/test_hybrid.py's loss (GemNet-dQ, one block) against
  JAX's single device on the union of the dp shards (loss rtol 1e-5,
  gradients within 1e-4 + 1e-3 max|g|); the dp x halo loss and gradients
  (rtol 2e-4, atol 1e-6); one dp x halo train step (GemNet-Q) against JAX's
  single-device Trainer on the union batch (loss rtol 1e-5, parameters and
  EMA rtol 5e-4 atol 1e-7); the dp x halo eval with the second dp row
  zero-masked against JAX's single-device eval of the first row's
  molecules; every result the same on every rank;
- `train.run(dp_halo=(2, 2))` on the 4 ranks: rank-0 checkpoints, a
  resume, and the same best metrics on every rank.

The weights are the port's (seed 0, non-unit scale factors), carried into
JAX by `test_torch_halo.jax_variables`; the spawned ranks import no JAX."""

import logging
import os

import numpy as np
import pytest
import torch

from test_torch_halo import TINY, jax_variables, load_payload, spawn

torch.set_num_threads(2)

N_DP, N_EP = 2, 2
WORLD = N_DP * N_EP
# tests/test_hybrid.py's widths: tests/test_halo.py's with one block
HYBRID = dict(TINY, num_blocks=1)
GRAD_KW = dict(triplets_only=False, direct_forces=True)   # GemNet-dQ
STEP_KW = dict(triplets_only=False, direct_forces=False)  # GemNet-Q
STEP_TRAIN = dict(batch_size=4, weight_decay=2e-6)
# tests/test_hybrid.py's dp x ep shard padding
SHARD_DIMS = dict(n_mol=2, n_atoms=32, n_edges=256, n_triplets=1024, kmax3=16, n_int_edges=256,
                  n_intm=1024, n_quads=4096, kmax4=64)


# ---------------------------------------------------------------- data and weights

def _mols(seed, n=2):
    """tests/test_hybrid.py's molecules: `n` of 6-8 atoms from `seed`."""
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule, toy_energy_forces

    rng = np.random.default_rng(seed)
    mols = [random_molecule(rng, int(rng.integers(6, 9))) for _ in range(n)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    EF = [toy_energy_forces(z, r) for z, r in mols]
    return N, Z, R, np.array([e for e, _ in EF], np.float32), np.concatenate([f for _, f in EF])


def _graph(N, Z, R, E, F):
    from gemnet_pytorch_tpu_torch.data.graph import build_graph

    return build_graph(R, N, 5.0, 10.0, triplets_only=False), Z, R, E, F


def ep_shards():
    """tests/test_hybrid.py::_shard: dp shard s holds 2 molecules of seed s,
    padded to SHARD_DIMS."""
    from gemnet_pytorch_tpu_torch.data.padding import PadDims, pad_batch

    out = []
    for s in range(N_DP):
        g, Z, R, E, F = _graph(*_mols(s))
        out.append(pad_batch(g, Z, R, PadDims(**SHARD_DIMS), E=E, F=F))
    return out


def halo_tuples():
    """tests/test_hybrid.py::_dp_halo_setup: the dp shards' (g, Z, R, E, F)."""
    return [_graph(*_mols(s)) for s in range(N_DP)]


def union_batch(shards):
    """The dp shards' molecules as one single-device batch
    (tests/test_hybrid.py::_dp_halo_setup's union)."""
    from gemnet_pytorch_tpu_torch.data.padding import PadDims, pad_batch, scale_graph_dims

    mols = [_mols(s) for s in shards]
    N, Z, R, E, F = (np.concatenate([m[i] for m in mols]) for i in range(5))
    g = _graph(N, Z, R, E, F)[0]
    dims = PadDims(n_mol=2 * len(shards), n_atoms=48, n_edges=512, n_triplets=2048, kmax3=16,
                   n_int_edges=512, n_intm=2048, n_quads=8192, kmax4=64,
                   ).grow_to(scale_graph_dims(g, 1.1), 2 * len(shards), len(Z))
    return pad_batch(g, Z, R, dims, E=E, F=F)


def hybrid_model(kw, sd=None):
    """The port's GemNet at HYBRID widths on the CPU: weights from `sd`, or
    from seed 0 with non-unit scale factors."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.models.scaling import scaling_factors

    model = GemNet(ModelConfig(**kw, **HYBRID), generator=torch.Generator().manual_seed(0),
                   device="cpu")
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    else:
        rng = np.random.default_rng(11)
        for m in scaling_factors(model).values():
            m.scale_factor.fill_(float(rng.uniform(0.5, 2.0)))
    return model


def loss_parts(E, F, b):
    """tests/test_hybrid.py's loss as (numerator, denominator)."""
    m = b["mol_mask"].float()[:, None]
    am = b["atom_mask"].float()[:, None]
    num = torch.sum(torch.abs(E - b["E"]) * m) + torch.sum(torch.abs(F[:, 0, :] - b["F"]) * am)
    return num, torch.sum(m) + torch.sum(am)


def _assert_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


# ---------------------------------------------------------------- host side

def test_build_hybrid_batch_matches_jax():
    """The dp x ep stack array for array as JAX's: (n_dp, n_ep, chunk) row
    arrays at one chunk a space from the shard with the most real rows,
    (n_dp, ...) for the rest; a rank's slice is its dp shard's ep chunk."""
    from gemnet_pytorch_tpu.parallel import hybrid as jhybrid
    from gemnet_pytorch_tpu_torch.parallel import ep, hybrid

    shards = ep_shards()
    port = hybrid.build_hybrid_batch(shards, N_EP)
    _assert_equal(port, jhybrid.build_hybrid_batch(shards, N_EP))
    assert port["id4_reduce_ca"].shape[:2] == (N_DP, N_EP) and port["Z"].shape[0] == N_DP
    for d in range(N_DP):
        for e in range(N_EP):
            local = hybrid.local_hybrid_batch(port, d, e)
            own = ep.local_ep_batch(ep.partition_batch(
                shards[d], N_EP, port["id3_reduce_ca"].shape[2], port["id4_reduce_ca"].shape[2]), e)
            _assert_equal(local, own)


def test_build_dp_halo_batch_matches_jax():
    """The dp x halo stack array for array as JAX's, with the one HaloPads
    grown over the dp shards (and with given pads past them)."""
    import dataclasses

    from gemnet_pytorch_tpu.parallel import hybrid as jhybrid
    from gemnet_pytorch_tpu_torch.parallel import halo, hybrid

    tuples = halo_tuples()
    port, pads = hybrid.build_dp_halo_batch(tuples, N_EP)
    ref, jpads = jhybrid.build_dp_halo_batch(tuples, N_EP)
    _assert_equal(port, ref)
    assert dataclasses.asdict(pads) == dataclasses.asdict(jpads)
    naturals = [halo.build_halo_partition(*t[:3], N_EP, E=t[3], F=t[4])["halo_pads"]
                for t in tuples]
    assert pads == naturals[0].grow_to(naturals[1])
    grown = pads.grow_to(pads, headroom=1.3)
    jgrown = jpads.grow_to(jpads, headroom=1.3)
    port, used = hybrid.build_dp_halo_batch(tuples, N_EP, pads=grown)
    ref, _ = jhybrid.build_dp_halo_batch(tuples, N_EP, pads=jgrown)
    _assert_equal(port, ref)
    assert used == grown
    local = hybrid.local_dp_halo_batch(port, 1, 0)
    assert local["id_c"].shape == port["id_c"].shape[2:] and local["Z"].shape == port["Z"].shape[1:]


# ---------------------------------------------------------------- the 2x2 mesh

def _mesh_rank(rank, world, directory, group):
    """Every 2x2 case on this rank."""
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import hybrid, mesh
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    out = {}
    with_wrong_size = None
    try:
        mesh.make_hybrid_mesh(2, 3, group)
    except ValueError as exc:
        with_wrong_size = str(exc)
    hmesh = mesh.make_hybrid_mesh(N_DP, N_EP, group)
    out["mesh"] = (hmesh.dp_index, hmesh.ep_index, dist.get_process_group_ranks(hmesh.dp),
                   dist.get_process_group_ranks(hmesh.ep), mesh.backend(hmesh.ep),
                   hmesh.world is group, with_wrong_size)

    def named(model, grads):
        return {n: g.numpy().copy() for (n, _), g in zip(model.named_parameters(), grads)}

    # dp x ep
    model = hybrid_model(GRAD_KW, payload["sd_grad"])
    local = hybrid.shard_hybrid_batch(hybrid.build_hybrid_batch(ep_shards(), N_EP), hmesh, "cpu")
    loss, grads = hybrid.make_hybrid_loss_and_grad(model, hmesh, loss_parts)(local)
    out["dp_ep"] = (float(loss), named(model, grads))
    # dp x halo
    stacked, _ = hybrid.build_dp_halo_batch(halo_tuples(), N_EP)
    local = hybrid.shard_dp_halo_batch(stacked, hmesh, "cpu")
    loss, grads = hybrid.make_dp_halo_loss_and_grad(model, hmesh, loss_parts)(local)
    out["dp_halo"] = (float(loss), named(model, grads))
    # one dp x halo train step from the host batch of this rank's shard
    trainer = Trainer(hybrid_model(STEP_KW, payload["sd_step"]), TrainConfig(**STEP_TRAIN))
    state = trainer.init_state()
    host = hybrid.local_dp_halo_batch(stacked, hmesh.dp_index, hmesh.ep_index)
    state, metrics = hybrid.make_dp_halo_train_step(trainer, hmesh)(state, host, 1.0)
    out["step"] = (float(metrics["loss"]), state.params.numpy().copy(),
                   state.ema_params.numpy().copy())
    # the eval of the first row's batch, the second row zero-masked
    trainer = Trainer(hybrid_model(STEP_KW, payload["sd_step"]), TrainConfig(**STEP_TRAIN))
    state = trainer.init_state()
    masked = {k: np.stack([v[0], v[0]]) for k, v in stacked.items()}
    for key in ("mol_mask", "atom_mask"):
        masked[key][1] = False
    host = hybrid.local_dp_halo_batch(masked, hmesh.dp_index, hmesh.ep_index)
    metrics, counts = hybrid.make_dp_halo_eval_step(trainer, hmesh)(state, host, use_ema=True)
    out["eval"] = ({k: float(v) for k, v in metrics.items()},
                   {k: float(v) for k, v in counts.items()})
    return out


@pytest.fixture(scope="module")
def weights():
    return {name: {k: v.detach().clone() for k, v in hybrid_model(kw).state_dict().items()}
            for name, kw in (("sd_grad", GRAD_KW), ("sd_step", STEP_KW))}


@pytest.fixture(scope="module")
def mesh_run(weights, tmp_path_factory):
    return spawn(_mesh_rank, WORLD, tmp_path_factory.mktemp("hybrid"), payload=weights)


@pytest.fixture(scope="module")
def references(weights):
    """JAX's single-device results with the same weights: the dp x ep loss
    and gradient summed over the dp shards' batches, the dp x halo loss and
    gradient on the union batch, one Trainer step on the union batch
    (parameters and EMA in the port's buffer order), and the eval of the
    first dp shard's molecules."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    def dev(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    def parts(E, F, b):
        m = b["mol_mask"].astype(jnp.float32)[:, None]
        am = b["atom_mask"].astype(jnp.float32)[:, None]
        num = (jnp.sum(jnp.abs(E - b["E"]) * m)
               + jnp.sum(jnp.abs(F[:, 0, :] - b["F"]) * am))
        return num, jnp.sum(m) + jnp.sum(am)

    out = {}
    cfg = ModelConfig(**GRAD_KW, **HYBRID)
    jmodel = make_model(JaxConfig(**GRAD_KW, **HYBRID))
    variables = jax_variables(weights["sd_grad"], cfg)
    scales = variables["scale_factors"]

    def loss_of(batches):
        def loss(params):
            num = den = 0.0
            for b in batches:
                E, F, _ = energy_and_forces(jmodel, {"params": params, "scale_factors": scales}, b)
                n, d = parts(E, F, b)
                num, den = num + n, den + d
            return num / den
        return loss

    for key, batches in (("dp_ep", [dev(b) for b in ep_shards()]),
                         ("dp_halo", [dev(union_batch(range(N_DP)))])):
        loss, g = jax.jit(jax.value_and_grad(loss_of(batches)))(variables["params"])
        g = jax.tree_util.tree_map(np.asarray, g)
        out[key] = (float(loss), state_dict_from_jax({"params": g, "scale_factors": scales}, cfg))

    cfg = ModelConfig(**STEP_KW, **HYBRID)
    jmodel = make_model(JaxConfig(**STEP_KW, **HYBRID))
    variables = jax_variables(weights["sd_step"], cfg)
    trainer = JaxTrainer(jmodel, JaxTrainConfig(**STEP_TRAIN))
    state = trainer.init_state(variables)
    names = [n for n, _ in hybrid_model(STEP_KW, weights["sd_step"]).named_parameters()]

    def port_order(params):
        tree = jax.tree_util.tree_map(np.asarray, trainer.params_tree(params))
        sd = state_dict_from_jax({"params": tree, "scale_factors": variables["scale_factors"]},
                                 cfg)
        return np.concatenate([sd[n].numpy().reshape(-1) for n in names])

    new, metrics, _ = trainer.train_step_fn()(state, dev(union_batch(range(N_DP))),
                                              jnp.float32(1.0))
    out["step"] = (float(metrics["loss"]), port_order(new.params), port_order(new.ema_params))
    metrics, counts = trainer.eval_step_fn()(state.ema_params, state.scales,
                                             dev(union_batch([0])))
    out["eval"] = ({k: float(v) for k, v in metrics.items()},
                   {k: float(v) for k, v in counts.items()})
    return out


def test_hybrid_mesh_layout(mesh_run):
    """Rank r sits at (r // 2, r % 2); its dp group is its column (the ranks
    of its ep index), its ep group its row, gloo as the world's; the world
    is the group it was cut from; a mesh of the wrong size is refused."""
    for r, res in enumerate(mesh_run):
        d, e, dp_ranks, ep_ranks, backend, is_world, refused = res["mesh"]
        assert (d, e) == divmod(r, N_EP)
        assert dp_ranks == [x * N_EP + e for x in range(N_DP)]
        assert ep_ranks == [d * N_EP + x for x in range(N_EP)]
        assert backend == "gloo" and is_world
        assert refused is not None and "needs 6 ranks" in refused


def _grads_within(got, ref, bound):
    bad = []
    for name, g in got.items():
        a = ref[name].numpy()
        if not bound(g, a):
            bad.append((name, float(np.abs(g - a).max()), float(np.abs(a).max())))
    assert not bad, bad[:8]


def test_dp_ep_loss_and_grads_match_jax(mesh_run, references):
    """dp x ep on the 2x2 mesh: the global loss and every gradient against
    JAX's single device over the dp shards' batches (tests/test_hybrid.py:
    27-90's gates), the same on every rank."""
    loss_ref, g_ref = references["dp_ep"]
    loss, g0 = mesh_run[0]["dp_ep"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    assert sorted(g0) == sorted(k for k in g_ref if not k.endswith("scale_factor"))
    _grads_within(g0, g_ref, lambda g, a: np.abs(g - a).max() <= 1e-4 + 1e-3 * np.abs(a).max())
    for res in mesh_run[1:]:
        assert res["dp_ep"][0] == loss
        for name, g in res["dp_ep"][1].items():
            np.testing.assert_array_equal(g, g0[name], err_msg=name)


def test_dp_halo_loss_and_grads_match_jax(mesh_run, references):
    """dp x halo on the 2x2 mesh: the global loss and every gradient against
    JAX's single device on the union batch (tests/test_hybrid.py:168-191's
    gates), the same on every rank."""
    loss_ref, g_ref = references["dp_halo"]
    loss, g0 = mesh_run[0]["dp_halo"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    _grads_within(g0, g_ref, lambda g, a: np.allclose(g, a, rtol=2e-4, atol=1e-6))
    for res in mesh_run[1:]:
        assert res["dp_halo"][0] == loss
        for name, g in res["dp_halo"][1].items():
            np.testing.assert_array_equal(g, g0[name], err_msg=name)


def test_dp_halo_train_step_matches_jax_trainer(mesh_run, references):
    """One dp x halo train step (flat optimizer, EMA, metrics) against JAX's
    single-device Trainer step on the union batch from the same weights
    (tests/test_hybrid.py:194-230's gates), the state the same on every
    rank."""
    loss_ref, params_ref, ema_ref = references["step"]
    loss, params, ema = mesh_run[0]["step"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    np.testing.assert_allclose(params, params_ref, rtol=5e-4, atol=1e-7)
    np.testing.assert_allclose(ema, ema_ref, rtol=5e-4, atol=1e-7)
    for res in mesh_run[1:]:
        for a, b in zip(res["step"], (loss, params, ema)):
            np.testing.assert_array_equal(a, b)


def test_dp_halo_eval_with_zero_masked_row(mesh_run, references):
    """The dp x halo eval of the EMA weights with the second dp row's masks
    zeroed reports the first row's molecules alone: JAX's single-device eval
    of them (tests/test_halo.py:353-383's gates), its counts, the same on
    every rank."""
    metrics_ref, counts_ref = references["eval"]
    metrics, counts = mesh_run[0]["eval"]
    assert sorted(metrics) == sorted(metrics_ref)
    for k, v in metrics_ref.items():
        np.testing.assert_allclose(metrics[k], v, rtol=2e-5, atol=1e-7, err_msg=k)
    assert counts == counts_ref
    for res in mesh_run[1:]:
        assert res["eval"] == (metrics, counts)


# ---------------------------------------------------------------- the driver

def _driver_rank(rank, world, directory, group):
    """`train.run(dp_halo=(2, 2))` on this rank: 4 steps, then a restart to
    6, with its restore log lines and what each run returned."""
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch import train

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    config = dict(payload["config"], num_steps=4, restart=os.path.join(directory, "run"))
    kw = dict(device="cpu", synthetic_molecules=payload["molecules"], group=group,
              dp_halo=(N_DP, N_EP))
    first = train.run(config, **kw)
    dist.barrier(group)  # rank 0's final checkpoint is on disk
    second = train.run(dict(config, num_steps=6), **kw)
    restores = [r.args for r in records if r.msg == "restored checkpoint at step %d"]
    places = [r.args[2:] for r in records if r.msg.startswith("dp%d x halo%d")]
    return dict(first=first, second=second, restores=restores, places=places)


def test_run_dp_halo_checkpoints_on_rank0_and_resumes(tmp_path):
    """`train.run(dp_halo=(2, 2))` on 4 ranks (GemNet-Q at the driver tests'
    small widths, batches of 8 a dp row, 4 steps, eval and checkpoints every
    2; then a restart to 6): the same finite best metrics on every rank,
    rank 0 alone wrote the log, the checkpoint and the best model, and every
    rank resumed at step 4 from rank 0's checkpoint."""
    from test_torch_train_driver import RUN, RUN_MOLECULES

    results = spawn(_driver_rank, WORLD, tmp_path,
                    payload=dict(config=dict(RUN), molecules=RUN_MOLECULES))
    run_dir = tmp_path / "run"
    for key in ("first", "second"):
        assert all(res[key] == results[0][key] for res in results)
        assert all(np.isfinite(v) for v in results[0][key].values())
    assert [r["restores"] for r in results] == [[(4,)]] * WORLD
    assert [r["places"][0] for r in results] == [(r, *divmod(r, N_EP)) for r in range(WORLD)]
    for rel in ("logs/checkpoint", "best/model", "best/best_metrics.npz", "logs_p3",
                "best_p3/best_metrics.npz"):
        assert (run_dir / rel).exists(), rel
    assert not (run_dir / "best_p1" / "model").exists()
    ckpt = torch.load(run_dir / "logs" / "checkpoint", weights_only=True)
    assert int(ckpt["step"]) == 6 and int(ckpt["opt_state.count"]) == 6
