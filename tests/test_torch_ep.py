"""The port's row-space edge partition (`gemnet_pytorch_tpu_torch/parallel/ep.py`,
rung 2a) against the JAX package on the CPU, as tests/test_edge_partition.py
holds JAX's:

- `partition_batch` equals JAX's array for array, dtypes included, at 1, 2
  and 4 shards, GemNet-Q and -T, with natural and with fixed chunks (one
  larger than the rows need, one smaller, which grows); a segment's rows
  split across two shards, all-padding chunks;
- an ep shard's segment plans have one shape for every batch of one chunk
  size (a captured ep step replays across them);
- on spawned gloo groups of 2 and 4 ranks: E and F of GemNet-Q, -dQ, -T and
  -dT on every rank against JAX's single-device `energy_and_forces` (E rtol
  1e-5 atol 1e-5, F rtol 1e-4 atol 1e-5, tests/test_edge_partition.py:50-74;
  -dE/dR for GemNet-Q and -T); at 4 ranks also a batch whose quadruplet
  chunks are all padding; the parameter gradients of tests/test_edge_
  partition.py's loss (GemNet-dQ and -Q) within 1e-4 + 1e-3 max|g| of JAX's,
  the same on every rank; the collectives the forward and a train step
  issue; on 2 ranks one `make_ep_train_step` against JAX's single-device
  `Trainer` step (tests/test_hybrid.py:194-230's gates);
- `python -m gemnet_pytorch_tpu_torch.train --ep 2` on 2 spawned ranks (the
  command line as torchrun starts it): rank-0 checkpoints, a resume, and
  the same best metrics on both ranks.

The weights are the port's, carried into JAX (`test_torch_halo.jax_variables`);
the spawned ranks import no JAX."""

import logging
import os

import numpy as np
import pytest
import torch

from test_torch_halo import (
    TINY, VARIANTS, _random_graph, counted_gathers, edge_sort_keys, halo_data, halo_loss,
    jax_variables, load_payload, port_model, spawn, swap_sites,
)

torch.set_num_threads(2)

EP_VARIANTS = ("Q", "dQ", "T", "dT")
GRAD_VARIANTS = ("dQ", "Q")
# tests/test_hybrid.py:194-230's train step: GemNet-Q, its TrainConfig
STEP_VARIANT = "Q"
STEP_TRAIN = dict(batch_size=4, weight_decay=2e-6)


# ---------------------------------------------------------------- data

def tiny_data():
    """A 3-atom and a 2-atom molecule (seed 0): 6 triplets and no
    quadruplet, so every shard's quadruplet chunk is all padding."""
    from gemnet_pytorch_tpu_torch.data.graph import build_graph
    from gemnet_pytorch_tpu_torch.data.padding import PadDims, pad_batch
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule, toy_energy_forces

    rng = np.random.default_rng(0)
    mols = [random_molecule(rng, n) for n in (3, 2)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    EF = [toy_energy_forces(z, r) for z, r in mols]
    g = build_graph(R, N, 5.0, 10.0, triplets_only=False)
    dims = PadDims(n_mol=2, n_atoms=16, n_edges=64, n_triplets=512, kmax3=4, n_int_edges=64,
                   n_intm=512, n_quads=512, kmax4=4)
    return pad_batch(g, Z, R, dims, E=np.array([e for e, _ in EF], np.float32),
                     F=np.concatenate([f for _, f in EF]))


def _padded(triplets_only: bool, seed: int, n_mol: int = 5):
    from gemnet_pytorch_tpu_torch.data.padding import estimate_pad_dims, pad_batch

    g, Z, R, E, F = _random_graph(triplets_only, seed, n_mol)
    dims = estimate_pad_dims([g], n_mol, [len(Z)], triplets_only=triplets_only)
    return pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=triplets_only)


def _assert_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


# ---------------------------------------------------------------- partitioner

@pytest.mark.parametrize("chunks", ["natural", "fixed", "grown"])
@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_matches_jax(n_shards, triplets_only, chunks):
    """Array for array as JAX's, with natural chunks, fixed chunks one
    ROW_BLOCK past what the rows need, and fixed chunks below it (they
    grow); no sort metadata survives, and every shard's reduce ids ascend."""
    from gemnet_pytorch_tpu.parallel import ep as jep
    from gemnet_pytorch_tpu_torch.data.batch import SORT_META_KEYS
    from gemnet_pytorch_tpu_torch.data.padding import ROW_BLOCK
    from gemnet_pytorch_tpu_torch.parallel import ep

    batch = _padded(triplets_only, seed=n_shards)
    natural = ep.partition_batch(batch, n_shards)
    kw = {}
    if chunks != "natural":
        delta = ROW_BLOCK if chunks == "fixed" else -ROW_BLOCK
        kw["trip_chunk"] = max(natural["id3_reduce_ca"].shape[1] + delta, 0)
        if not triplets_only:
            kw["quad_chunk"] = max(natural["id4_reduce_ca"].shape[1] + delta, 0)
    port = ep.partition_batch(batch, n_shards, **kw)
    _assert_equal(port, jep.partition_batch(batch, n_shards, **kw))
    if chunks == "grown":
        assert port["id3_reduce_ca"].shape == natural["id3_reduce_ca"].shape
    assert not set(SORT_META_KEYS) & set(port)
    for s in range(n_shards):
        local = ep.local_ep_batch(port, s)
        assert local["id_c"] is batch["id_c"]  # the edges are replicated
        assert local["trip_mask"].sum() == np.diff(np.round(
            np.arange(n_shards + 1) * batch["trip_mask"].sum() / n_shards))[s]


def test_partition_split_segment_and_padding_chunks():
    """A reduce edge's rows on two shards, a shard whose chunk is all padding
    (a space with fewer real rows than shards, and one with none), each
    array for array as JAX's; an unsorted chunk is refused."""
    from gemnet_pytorch_tpu.parallel import ep as jep
    from gemnet_pytorch_tpu_torch.parallel import ep

    batch = _padded(False, seed=0)
    part = ep.partition_batch(batch, 4)
    _assert_equal(part, jep.partition_batch(batch, 4))
    # (at 2 shards the quadruplet cut falls between the edge halves: an
    # edge and its reverse hold as many quadruplets)
    for key, mask_key in (("id3_reduce_ca", "trip_mask"), ("id4_reduce_ca", "quad_mask")):
        ids, mask = part[key], part[mask_key]
        assert any(ids[s][mask[s]][-1] == ids[s + 1][mask[s + 1]][0] for s in range(3)), key
    # two real triplet rows over 4 shards: bounds 0, 0, 1, 2, 2 (round half to even)
    few = dict(batch, trip_mask=np.arange(len(batch["trip_mask"])) < 2)
    part = ep.partition_batch(few, 4)
    _assert_equal(part, jep.partition_batch(few, 4))
    assert part["trip_mask"].sum(axis=1).tolist() == [0, 1, 1, 0]
    pad_id = batch["id3_reduce_ca"][-1]
    assert np.all(part["id3_reduce_ca"][0] == pad_id)
    tiny = tiny_data()
    part = ep.partition_batch(tiny, 4)
    _assert_equal(part, jep.partition_batch(tiny, 4))
    assert not part["quad_mask"].any() and part["trip_mask"].sum(axis=1).tolist() == [2, 1, 1, 2]
    bad = dict(part, id3_reduce_ca=part["id3_reduce_ca"][:, ::-1].copy())
    bad["id3_reduce_ca"][:, 0] += 1
    with pytest.raises(ValueError, match="not ascending"):
        ep.local_ep_batch(bad, 0)


def test_shard_plans_one_shape_per_chunk():
    """Two batches of other molecules, padded to one PadDims and partitioned
    with one chunk size: every shard's plans (of its own rows over all
    `len(id_c)` edges) and packed layout are the same, so one BatchPacker
    packs them without a new version and a captured ep step replays."""
    from gemnet_pytorch_tpu_torch.data.batch import plan_capacity
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker
    from gemnet_pytorch_tpu_torch.data.padding import (
        ROW_BLOCK, estimate_pad_dims, pad_batch, round_up,
    )
    from gemnet_pytorch_tpu_torch.parallel import ep

    raws = [_random_graph(False, seed, n_mol=4) for seed in (3, 4)]
    dims = estimate_pad_dims([r[0] for r in raws], 4, [len(r[1]) for r in raws])
    trip, quad = (round_up(-(-n // 2), ROW_BLOCK) for n in (dims.n_triplets, dims.n_quads))
    packer = BatchPacker()
    layouts = []
    for g, Z, R, E, F in raws:
        part = ep.partition_batch(pad_batch(g, Z, R, dims, E=E, F=F), 2, trip, quad)
        for shard in range(2):
            local = ep.local_ep_batch(part, shard)
            t = ep.to_torch(local, "cpu")
            for key, rows, item_rows in (("id3_reduce_ca_plan", trip, 16),
                                         ("id4_reduce_ca_plan", quad, 128)):
                assert t[key].n_segments == dims.n_edges
                assert t[key].items.shape[0] == plan_capacity(rows, dims.n_edges, item_rows).items
            assert {k for k in t if k.endswith("_plan")} == {"id3_reduce_ca_plan",
                                                             "id4_reduce_ca_plan"}
            packer.pack(local)
            layouts.append(list(packer.layout))
    assert packer.version == 0 and all(lay == layouts[0] for lay in layouts)


def test_ep_model_view_and_refusals():
    """The ep view shares the model's parameters and refuses to be made
    twice; without a group it raises at the forward, and with a
    single-device batch (sort metadata present) too."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import ep

    model = port_model("Q")
    view = ep.ep_model(model, group=None)
    assert view.cfg.ep_axis == "ep" and not view.cfg.ep_halo
    assert next(view.parameters()) is next(model.parameters())
    assert ep.make_model_ep is ep.ep_model
    with pytest.raises(ValueError, match="already"):
        ep.ep_model(view, None)
    batch, _ = halo_data(False)
    with pytest.raises(ValueError, match="process group"):
        view(to_torch(ep.local_ep_batch(ep.partition_batch(batch, 2), 0), "cpu"))
    view.group = object()
    with pytest.raises(ValueError, match="no sort metadata"):
        view(to_torch(batch, "cpu"))


# ---------------------------------------------------------------- the ranks

def _ep_rank(rank, world, directory, group):
    """Every case of the payload on this rank of an ep group."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import collectives, ep
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    out = {}

    def issued(fn):
        before = dict(collectives.CALLS)
        result = fn()
        return result, {k: v - before.get(k, 0) for k, v in collectives.CALLS.items()
                        if v != before.get(k, 0)}

    for variant, sd in payload["weights"].items():
        part = ep.partition_batch(halo_data(VARIANTS[variant]["triplets_only"])[0], world)
        local = ep.shard_ep_batch(part, group, "cpu")
        model = port_model(variant, sd)
        ((E, F), calls), gathers = counted_gathers(
            lambda: issued(lambda: ep.make_ep_apply(model, group)(local)))
        out[("apply", variant)] = (E.detach().numpy(), F.detach().numpy(), calls)
        out[("gathers", variant)] = (gathers, edge_sort_keys(local))
        if variant in GRAD_VARIANTS:
            loss, grads = ep.make_ep_loss_and_grad(model, group, halo_loss)(local)
            names = [n for n, _ in model.named_parameters()]
            out[("grad", variant)] = (float(loss), {n: g.numpy().copy()
                                                    for n, g in zip(names, grads)})
    if world == 4:
        model = port_model("Q", payload["weights"]["Q"])
        E, F = ep.make_ep_apply(model, group)(
            ep.shard_ep_batch(ep.partition_batch(tiny_data(), world), group, "cpu"))
        out["tiny"] = (E.detach().numpy(), F.detach().numpy())
    if payload["train"]:
        trainer = Trainer(port_model(STEP_VARIANT, payload["weights"][STEP_VARIANT]),
                          TrainConfig(**STEP_TRAIN))
        state = trainer.init_state()
        part = ep.partition_batch(halo_data(False)[0], world)
        step = ep.make_ep_train_step(trainer, group)
        (state, metrics), calls = issued(lambda: step(state, ep.local_ep_batch(part, rank), 1.0))
        out["train"] = (float(metrics["loss"]), state.params.numpy().copy(),
                        state.ema_params.numpy().copy(), calls)
    return out


@pytest.fixture(scope="module")
def references():
    """Per variant: the port's weights (seed 0, non-unit scales), JAX's
    single-device E and F with them, JAX's gradient of the loss for
    GRAD_VARIANTS (as a port state dict); JAX's E and F of GemNet-Q on the
    tiny batch; and JAX's single-device Trainer step of STEP_VARIANT
    (parameters and EMA in the port's buffer order)."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    out = {}
    for variant in EP_VARIANTS:
        kw = VARIANTS[variant]
        batch, _ = halo_data(kw["triplets_only"])
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        model = port_model(variant)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        cfg = ModelConfig(**kw, **TINY)
        jmodel = make_model(JaxConfig(**kw, **TINY))
        variables = jax_variables(sd, cfg)
        apply = jax.jit(lambda v, b: energy_and_forces(jmodel, v, b)[:2])
        E, F = apply(variables, jbatch)
        ref = dict(sd=sd, E=np.asarray(E), F=np.asarray(F))
        if variant in GRAD_VARIANTS:
            scales = variables["scale_factors"]

            def loss_single(params):
                E, F, _ = energy_and_forces(jmodel, {"params": params, "scale_factors": scales},
                                            jbatch)
                m = jbatch["mol_mask"].astype(jnp.float32)[:, None]
                am = jbatch["atom_mask"].astype(jnp.float32)[:, None]
                return (jnp.sum(jnp.abs(E - jbatch["E"]) * m)
                        + jnp.sum(jnp.abs(F[:, 0, :] - jbatch["F"]) * am))

            g = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_single))(
                variables["params"]))
            ref["grad"] = state_dict_from_jax({"params": g, "scale_factors": scales}, cfg)
        if variant == "Q":
            tiny = {k: jnp.asarray(v) for k, v in tiny_data().items()}
            ref["tiny"] = tuple(np.asarray(t) for t in apply(variables, tiny))
        if variant == STEP_VARIANT:
            trainer = JaxTrainer(jmodel, JaxTrainConfig(**STEP_TRAIN))
            state = trainer.init_state(variables)
            names = [n for n, _ in model.named_parameters()]

            def port_order(params):
                tree = jax.tree_util.tree_map(np.asarray, trainer.params_tree(params))
                sd = state_dict_from_jax({"params": tree,
                                          "scale_factors": variables["scale_factors"]}, cfg)
                return np.concatenate([sd[n].numpy().reshape(-1) for n in names])

            new, metrics, _ = trainer.train_step_fn()(state, jbatch, jnp.float32(1.0))
            ref["step"] = (float(metrics["loss"]), port_order(new.params),
                           port_order(new.ema_params))
        out[variant] = ref
    return out


def _run_ep(world, references, tmp_path_factory):
    payload = {"weights": {v: r["sd"] for v, r in references.items()}, "train": world == 2}
    return world, spawn(_ep_rank, world, tmp_path_factory.mktemp(f"ep{world}"), payload=payload)


@pytest.fixture(scope="module")
def ep2(references, tmp_path_factory):
    return _run_ep(2, references, tmp_path_factory)


@pytest.fixture(scope="module")
def ep4(references, tmp_path_factory):
    return _run_ep(4, references, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def ep_runs(request):
    return request.getfixturevalue(f"ep{request.param}")


@pytest.mark.parametrize("variant", EP_VARIANTS)
def test_ep_forward_matches_jax_single_device(ep_runs, references, variant):
    """E and F (the direct head, or -dE/dR) on every rank vs JAX's
    single-device energy_and_forces (tests/test_edge_partition.py's gates),
    the same bits on every rank; the forward's only collectives are the
    2 psums of each block's bilinear outputs (one for GemNet-T), with
    -dE/dR as many again in the backward and the psum of dE/dR."""
    world, results = ep_runs
    ref = references[variant]
    E0, F0, calls = results[0][("apply", variant)]
    for r, res in enumerate(results):
        E, F, _ = res[("apply", variant)]
        np.testing.assert_allclose(E, ref["E"], rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(F, ref["F"], rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(E, E0)
        np.testing.assert_array_equal(F, F0)
    kw = VARIANTS[variant]
    psums = TINY["num_blocks"] * (1 if kw["triplets_only"] else 2)
    assert calls == {("all_reduce", "gloo"): psums if kw["direct_forces"] else 2 * psums + 1}


def test_ep_shards_gather_plain(ep_runs):
    """An ep shard carries no edge sort metadata (its rows are re-sliced), so
    every gather site of its forward and -dE/dR but the swaps is a plain
    gather."""
    _, results = ep_runs
    for res in results:
        for variant in EP_VARIANTS:
            gathers, keys = res[("gathers", variant)]
            assert keys == [] and gathers["gather.plain"] > 0
            # the swaps alone take their own VJP, as on one device
            assert gathers["gather.sorted"] == swap_sites(variant)


def test_ep_all_padding_chunks_match_jax(ep4, references):
    """A batch without quadruplets over 4 ranks (every quadruplet chunk all
    padding, the triplet chunks 2, 1, 1 and 2 rows): GemNet-Q's E and F on
    every rank vs JAX's single device."""
    _, results = ep4
    E_ref, F_ref = references["Q"]["tiny"]
    assert np.all(np.isfinite(F_ref))
    for res in results:
        E, F = res["tiny"]
        np.testing.assert_allclose(E, E_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(F, F_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant", GRAD_VARIANTS)
def test_ep_grads_match_jax_single_device(ep_runs, references, variant):
    """Each parameter's gradient within 1e-4 + 1e-3 max|g| of JAX's
    single-device gradient (tests/test_edge_partition.py:101-168), identical
    on every rank."""
    world, results = ep_runs
    ref = references[variant]["grad"]
    _, g0 = results[0][("grad", variant)]
    assert sorted(g0) == sorted(k for k in ref if not k.endswith("scale_factor"))
    bad = []
    for name in g0:
        a = ref[name].numpy()
        err = np.abs(g0[name] - a).max()
        if err > 1e-4 + 1e-3 * np.abs(a).max():
            bad.append((name, float(err), float(np.abs(a).max())))
    assert not bad, bad[:10]
    for res in results[1:]:
        _, g = res[("grad", variant)]
        for name in g0:
            np.testing.assert_array_equal(g[name], g0[name], err_msg=name)


def test_ep_train_step_matches_jax_trainer(ep2, references):
    """One ep train step (flat optimizer, EMA, metrics) on 2 ranks against
    JAX's single-device Trainer step from the same weights
    (tests/test_hybrid.py:194-230's gates: loss rtol 1e-5, parameters and
    EMA rtol 5e-4 atol 1e-7), the state the same on both ranks. The
    collectives of the step: the forward's psums (2 a block), as many in the
    -dE/dR backward and twice as many in the loss's backward, the psum of
    dE/dR and its backward, and one all-reduce of the flat gradient."""
    _, results = ep2
    loss_ref, params_ref, ema_ref = references[STEP_VARIANT]["step"]
    loss, params, ema, calls = results[0]["train"]
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    np.testing.assert_allclose(params, params_ref, rtol=5e-4, atol=1e-7)
    np.testing.assert_allclose(ema, ema_ref, rtol=5e-4, atol=1e-7)
    psums = 2 * TINY["num_blocks"]
    assert calls == {("all_reduce", "gloo"): 4 * psums + 2 + 1}
    for a, b in zip(results[1]["train"][:3], (loss, params, ema)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the driver

def _driver_rank(rank, world, directory, group):
    """`python -m gemnet_pytorch_tpu_torch.train --ep 2` on this rank, as
    torchrun starts it (the environment's rank and world size), 4 steps and
    then a restart to 6, with its restore log lines and what each returned.
    Rank 1 starts from the smallest PadDims and grows them on its own
    batches, as a rank whose prefetch threads met other batches first."""
    import torch.distributed as dist
    import yaml

    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.data import PadDims
    from gemnet_pytorch_tpu_torch.data.provider import DataProvider

    if rank == 1:
        DataProvider._estimate_dims = lambda self, n: PadDims(
            n_mol=self.batch_size, n_atoms=16, n_edges=128, n_triplets=512, kmax3=4,
            n_int_edges=64, n_intm=512, n_quads=512, kmax4=4)

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    dist.destroy_process_group()
    os.environ.update(MASTER_ADDR="localhost", RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    path = os.path.join(directory, f"config{rank}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(payload["config"], restart=os.path.join(directory, "run")), f)
    argv = ["--config", path, "--device", "cpu", "--ep", str(world),
            "--synthetic-molecules", str(payload["molecules"])]
    os.environ["MASTER_PORT"] = str(payload["ports"][0])
    first = train.main(argv + ["--num-steps", "4"])
    os.environ["MASTER_PORT"] = str(payload["ports"][1])
    second = train.main(argv + ["--num-steps", "6"])
    restores = [r.args for r in records if r.msg == "restored checkpoint at step %d"]
    warned = any(r.levelno == logging.WARNING and "deprecated" in r.msg for r in records)
    agreed = sum(r.msg == "pad dims agreed across ranks: %s" for r in records)
    return dict(first=first, second=second, restores=restores, warned=warned, agreed=agreed)


def test_main_ep_checkpoints_on_rank0_and_resumes(tmp_path):
    """`--ep 2` from the command line on 2 ranks (GemNet-Q at the driver
    tests' small widths, 4 steps, eval and checkpoints every 2; then a
    restart to 6): the deprecation logged, the same finite best metrics on
    both ranks, rank 0 alone wrote the log, the checkpoint and the best
    model, and both ranks resumed at step 4 from rank 0's checkpoint. Rank 1
    pads from other PadDims than rank 0 and grows them on its own; the ranks
    agree on them before each step (their psums of (nEdges, units) need
    one padding)."""
    from test_torch_parallel_driver import _free_ports
    from test_torch_train_driver import RUN, RUN_MOLECULES

    results = spawn(_driver_rank, 2, tmp_path,
                    payload=dict(config=dict(RUN), molecules=RUN_MOLECULES, ports=_free_ports(2)))
    run_dir = tmp_path / "run"
    for key in ("first", "second"):
        assert results[0][key] == results[1][key]
        assert all(np.isfinite(v) for v in results[0][key].values())
    assert [r["restores"] for r in results] == [[(4,)], [(4,)]]
    assert all(r["warned"] for r in results) and results[1]["agreed"] > 0
    for rel in ("logs/checkpoint", "best/model", "best/best_metrics.npz", "logs_p1",
                "best_p1/best_metrics.npz"):
        assert (run_dir / rel).exists(), rel
    assert not (run_dir / "best_p1" / "model").exists()
    ckpt = torch.load(run_dir / "logs" / "checkpoint", weights_only=True)
    assert int(ckpt["step"]) == 6

