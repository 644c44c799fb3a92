"""The port's halo edge partition (`gemnet_pytorch_tpu_torch/parallel/halo.py`)
against the JAX package on the CPU, as tests/test_halo.py holds JAX's:

- the host partitioner (`build_halo_partition`, `estimate_halo_pads`,
  `HaloPads`) equals JAX's array for array, dtypes included, at 1, 2 and 4
  shards, for GemNet-Q and -T, three seeds, natural and grown pads;
- on gloo groups of 2 and 4 ranks (spawned processes, a `file://` store;
  the children import no JAX, the parent computes the JAX reference): E and
  F of the halo model on every rank against JAX's single-device
  `energy_and_forces` (GemNet-Q, -T, -dQ, -dT, and -dQ/-dT with
  forces_coupled; tests/test_halo.py's gates),
  the parameter gradients of tests/test_halo.py's loss against JAX's
  single-device gradient (GemNet-dQ and -Q, both force paths), the same on
  every rank; on 2 ranks, three halo train steps against the port's
  single-device Trainer (GemNet-Q and -dQ) and the halo eval of the EMA
  weights against the single-device eval.

`spawn` is shared with tests/test_torch_parallel_dp.py and
tests/test_torch_parallel_driver.py. This module imports no JAX at its top:
the spawned children import it to find their entry points."""

import dataclasses
import datetime
import os
import time
import traceback

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# tests/test_halo.py's widths
TINY = dict(
    num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16, emb_size_edge=16,
    emb_size_trip=8, emb_size_quad=8, emb_size_rbf=8, emb_size_cbf=8, emb_size_sbf=8,
    emb_size_bil_quad=8, emb_size_bil_trip=8,
)
VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dQ": dict(triplets_only=False, direct_forces=True),
            "T": dict(triplets_only=True, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True),
            # the id_undir average of the direct forces, local by pair ownership
            "dQ-coupled": dict(triplets_only=False, direct_forces=True, forces_coupled=True),
            "dT-coupled": dict(triplets_only=True, direct_forces=True, forces_coupled=True)}
GRAD_VARIANTS = ("dQ", "Q")
TRAIN_VARIANTS = ("Q", "dQ")
# tests/test_halo.py:241-282's optimizer settings
HALO_TRAIN = dict(weight_decay=1e-6, loss="mae", rho_force=0.5, learning_rate=3e-3)
TRAIN_STEPS = 3
# a spawned group's collective timeout, and the parent's wait for it
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120
# what a spawned rank may not import: the JAX side, and TensorFlow, which
# TensorBoard's writer would load (and which loads JAX)
BLOCKED_IN_CHILDREN = ("jax", "jaxlib", "flax", "optax", "gemnet_pytorch_tpu", "tensorflow")


# ---------------------------------------------------------------- spawned gloo groups

class _Blocked:
    """A meta-path finder that refuses BLOCKED_IN_CHILDREN."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED_IN_CHILDREN:
            raise ImportError(f"{name} is not imported in a spawned rank")
        return None


def _child(fn, rank, world, directory):
    """A spawned rank: join the gloo group of `directory`'s file store, run
    fn(rank, world, directory, group), save its result; on an error save the
    traceback for the parent and exit non-zero. Importing any of
    BLOCKED_IN_CHILDREN raises there."""
    import sys

    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.parallel import mesh

    assert not set(BLOCKED_IN_CHILDREN) & set(sys.modules)
    sys.meta_path.insert(0, _Blocked())
    torch.set_num_threads(1)
    try:
        group = mesh.initialize_distributed(
            f"file://{directory}/store", world, rank, device="cpu",
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        result = fn(rank, world, directory, group)
        torch.save(result, os.path.join(directory, f"rank{rank}.pt"))
        if dist.is_initialized():  # fn may have ended the group itself
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, directory, payload=None, timeout: float = JOIN_TIMEOUT_S) -> list:
    """Run fn(rank, world, directory, group) on `world` spawned processes in
    one gloo group; `payload` is saved to directory/payload.pt first (see
    `load_payload`). Returns each rank's result. A rank that fails stops the
    others at once; the group's timeout and `timeout` bound every wait."""
    import torch.multiprocessing as mp

    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    if payload is not None:
        torch.save(payload, os.path.join(directory, "payload.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, directory)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    errors = [open(os.path.join(directory, f"rank{r}.err")).read() for r in range(world)
              if os.path.exists(os.path.join(directory, f"rank{r}.err"))]
    codes = [p.exitcode for p in procs]
    assert not errors and codes == [0] * world, f"ranks exited {codes}:\n" + "\n".join(errors)
    return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def load_payload(directory):
    return torch.load(os.path.join(directory, "payload.pt"), weights_only=False)


def counted_gathers(fn):
    """(fn(), the counts of the gather sites' routes while it ran)."""
    from gemnet_pytorch_tpu_torch.perf import spans

    before = spans.counters()
    result = fn()
    after = spans.counters()
    return result, {k: after.get(k, 0) - before.get(k, 0)
                    for k in ("gather.sorted", "gather.plain")}


def swap_sites(variant):
    """The x[id_swap] sites of a TINY forward: one per block's triplet
    interaction, and one per quadruplet interaction."""
    return TINY["num_blocks"] * (1 if VARIANTS[variant]["triplets_only"] else 2)


def edge_sort_keys(batch):
    """The edges' sort metadata and plan a device batch carries."""
    from gemnet_pytorch_tpu_torch.data.batch import EDGE_SORT_KEYS

    return sorted(set(batch) & {*EDGE_SORT_KEYS, "edge_plan"})


# ---------------------------------------------------------------- data and weights

def halo_data(triplets_only: bool):
    """tests/test_halo.py::_setup's batch with the port's data modules: 4
    random molecules of 6-9 atoms (seed 0), the padded single-device batch
    and what the partitioner takes."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data.graph import build_graph
    from gemnet_pytorch_tpu_torch.data.padding import PadDims, pad_batch, scale_graph_dims
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule, toy_energy_forces

    cfg = ModelConfig()
    rng = np.random.default_rng(0)
    mols = [random_molecule(rng, int(rng.integers(6, 10))) for _ in range(4)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    EF = [toy_energy_forces(z, r) for z, r in mols]
    E = np.array([e for e, _ in EF], np.float32)
    F = np.concatenate([f for _, f in EF])
    g = build_graph(R, N, cfg.cutoff, cfg.int_cutoff, triplets_only=triplets_only)
    dims = PadDims(
        n_mol=4, n_atoms=48, n_edges=512, n_triplets=2048, kmax3=16,
        n_int_edges=0 if triplets_only else 512, n_intm=0 if triplets_only else 2048,
        n_quads=0 if triplets_only else 8192, kmax4=0 if triplets_only else 64,
    ).grow_to(scale_graph_dims(g, 1.1), 4, len(Z))
    batch = pad_batch(g, Z, R, dims, E=E, F=F, triplets_only=triplets_only)
    return batch, dict(g=g, Z=Z, R=R, E=E, F=F, n_mol_pad=dims.n_mol, n_atoms_pad=dims.n_atoms,
                       dims=dims)


def halo_partition(variant: str, n_shards: int, pads=None):
    from gemnet_pytorch_tpu_torch.parallel.halo import build_halo_partition

    triplets_only = VARIANTS[variant]["triplets_only"]
    _, d = halo_data(triplets_only)
    return build_halo_partition(d["g"], d["Z"], d["R"], n_shards, E=d["E"], F=d["F"],
                                triplets_only=triplets_only, n_mol_pad=d["n_mol_pad"],
                                n_atoms_pad=d["n_atoms_pad"], pads=pads)


def port_model(variant: str, state_dict=None, seed: int = 0, compute_dtype="float32"):
    """The port's GemNet of a variant at TINY widths on the CPU: weights
    from `state_dict`, or from `seed` with non-unit scale factors."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.models.scaling import scaling_factors

    model = GemNet(ModelConfig(**VARIANTS[variant], **TINY, compute_dtype=compute_dtype),
                   generator=torch.Generator().manual_seed(seed), device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        rng = np.random.default_rng(seed + 11)
        for m in scaling_factors(model).values():  # a misplaced factor shows off 1.0
            m.scale_factor.fill_(float(rng.uniform(0.5, 2.0)))
    return model


def jax_variables(state_dict, cfg):
    """The port's weights as the JAX model's variables, built from the
    port's state dict through compat's own map of flax paths (the tree
    `model.init` makes, without tracing it): every weight at its flax path,
    Dense kernels transposed; every scale factor under its module's path
    and its global name."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu_torch.compat import canonical_weights, flax_path, scale_state_names

    params, scales = {}, {}

    def put(tree, path, value):
        for p in path[:-1]:
            tree = tree.setdefault(p, {})
        tree[path[-1]] = value

    for name, is_dense in canonical_weights(cfg):
        value = state_dict[name].numpy()
        put(params, flax_path(name), jnp.asarray(value.T if is_dense else value))
    for key, global_name in scale_state_names(cfg):
        blocks, index, *rest, _ = key.split(".")  # ..., "scale_factor"
        put(scales, (f"{blocks}_{index}", *rest, global_name), jnp.float32(state_dict[key]))
    return {"params": params, "scale_factors": scales}


def halo_loss(E, F, batch):
    """tests/test_halo.py:140-195's loss."""
    m = batch["mol_mask"].float()[:, None]
    am = batch["atom_mask"].float()[:, None]
    return torch.sum(torch.abs(E - batch["E"]) * m) + torch.sum(torch.abs(F[:, 0, :] - batch["F"]) * am)


# ---------------------------------------------------------------- the ranks

def _halo_rank(rank, world, directory, group):
    """Every case of the payload on this rank of a halo group."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import halo
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    out = {}
    for variant, sd in payload["weights"].items():
        part = halo_partition(variant, world)
        local = halo.shard_halo_batch(part, group, "cpu")
        model = port_model(variant, sd)
        (E, F), gathers = counted_gathers(lambda: halo.make_halo_apply(model, group)(local))
        out[("apply", variant)] = (E.detach().numpy(), F.detach().numpy())
        out[("gathers", variant)] = (gathers, edge_sort_keys(local))
        if variant in GRAD_VARIANTS:
            loss, grads = halo.make_halo_loss_and_grad(model, group, halo_loss)(local)
            names = [n for n, _ in model.named_parameters()]
            out[("grad", variant)] = (float(loss), {n: g.numpy().copy()
                                                    for n, g in zip(names, grads)})
        if variant == "Q":
            E, F = halo.make_halo_apply(port_model(variant, sd, compute_dtype="bfloat16"),
                                        group)(local)
            out[("apply_bf16", variant)] = (E.detach().numpy(), F.detach().numpy())
        if payload["train"] and variant in TRAIN_VARIANTS:
            trainer = Trainer(port_model(variant, sd), TrainConfig(**HALO_TRAIN))
            state = trainer.init_state()
            step = halo.make_halo_train_step(trainer, group)
            host = halo.local_halo_batch(part, rank)
            losses = []
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, host, 1.0)
                losses.append(float(metrics["loss"]))
            out[("train", variant)] = (losses, state.params.numpy().copy(),
                                       state.ema_params.numpy().copy(),
                                       state.metric_acc.numpy().copy())
            state.ema_params.mul_(1.01)  # the EMA weights differ from the current ones
            metrics, counts = halo.make_halo_eval_step(trainer, group)(state, host, use_ema=True)
            out[("eval", variant)] = ({k: float(v) for k, v in metrics.items()},
                                      {k: float(v) for k, v in counts.items()},
                                      state.params.numpy().copy(),
                                      state.ema_params.numpy().copy())
    return out


# ---------------------------------------------------------------- partitioner

def _random_graph(triplets_only: bool, seed: int, n_mol: int = 5):
    from gemnet_pytorch_tpu_torch.data.graph import build_graph
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule

    rng = np.random.default_rng(seed)
    mols = [random_molecule(rng, int(rng.integers(4, 11))) for _ in range(n_mol)]
    N = np.array([len(z) for z, _ in mols])
    Z = np.concatenate([z for z, _ in mols])
    R = np.concatenate([r for _, r in mols])
    E = rng.normal(size=n_mol).astype(np.float32)
    F = rng.normal(size=R.shape).astype(np.float32)
    return build_graph(R, N, 5.0, 10.0, triplets_only=triplets_only), Z, R, E, F


def _assert_parts_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        if k == "halo_pads":
            assert dataclasses.asdict(port[k]) == dataclasses.asdict(v), k
            continue
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_partition_matches_jax(n_shards, triplets_only, seed):
    """Natural pads, grown pads (and an outlier batch past them), and
    `estimate_halo_pads`: array for array, dtype for dtype, as JAX's."""
    from gemnet_pytorch_tpu.parallel import halo as jhalo
    from gemnet_pytorch_tpu_torch.parallel import halo

    g, Z, R, E, F = _random_graph(triplets_only, seed)
    kw = dict(E=E, F=F, triplets_only=triplets_only)
    port = halo.build_halo_partition(g, Z, R, n_shards, **kw)
    ref = jhalo.build_halo_partition(g, Z, R, n_shards, **kw)
    _assert_parts_equal(port, ref)
    grown = port["halo_pads"].grow_to(port["halo_pads"], headroom=1.3)
    assert grown.covers(port["halo_pads"]) and grown != port["halo_pads"]
    jgrown = ref["halo_pads"].grow_to(ref["halo_pads"], headroom=1.3)
    assert dataclasses.asdict(grown) == dataclasses.asdict(jgrown)
    _assert_parts_equal(halo.build_halo_partition(g, Z, R, n_shards, pads=grown, **kw),
                        jhalo.build_halo_partition(g, Z, R, n_shards, pads=jgrown, **kw))
    # a bigger batch than the pads were sized for: the natural sizes win
    g2, Z2, R2, E2, F2 = _random_graph(triplets_only, seed + 10, n_mol=9)
    kw2 = dict(E=E2, F=F2, triplets_only=triplets_only)
    _assert_parts_equal(halo.build_halo_partition(g2, Z2, R2, n_shards, pads=grown, **kw2),
                        jhalo.build_halo_partition(g2, Z2, R2, n_shards, pads=jgrown, **kw2))
    raws = [_random_graph(triplets_only, seed + k) for k in (0, 10)]
    est = halo.estimate_halo_pads(raws, n_shards, triplets_only=triplets_only, n_mol=8)
    jest = jhalo.estimate_halo_pads(raws, n_shards, triplets_only=triplets_only, n_mol=8)
    assert dataclasses.asdict(est) == dataclasses.asdict(jest)


def test_shard_batch_local_plans_and_refusals():
    """A shard's tensors carry plans of its own reduce ids over its local
    edges (no sort metadata, no global plan); unsorted reduce ids and a halo
    model without its group raise."""
    from gemnet_pytorch_tpu_torch.data.batch import plan_capacity
    from gemnet_pytorch_tpu_torch.parallel import halo

    part = halo_partition("Q", 2)
    pads = part["halo_pads"]
    for s in range(2):
        local = halo.local_halo_batch(part, s)
        assert not set(halo.HOST_ONLY_KEYS) & set(local)
        assert not any(k.endswith(("_perm", "_sorted")) for k in local)
        t = halo.to_torch(local, "cpu")
        for key, rows in (("id3_reduce_ca_plan", pads.t_loc), ("id4_reduce_ca_plan", pads.q_loc)):
            plan = t[key]
            assert plan.n_segments == 2 * pads.half
            item_rows = 16 if key.startswith("id3") else 128
            assert plan.items.shape[0] == plan_capacity(rows, 2 * pads.half, item_rows).items
        assert "trip_ba_plan" not in t and "quad_abd_plan" not in t
    bad = dict(part)
    bad["id3_reduce_ca"] = part["id3_reduce_ca"][:, ::-1].copy()
    with pytest.raises(ValueError, match="not ascending"):
        halo.local_halo_batch(bad, 0)
    model = port_model("Q")
    hm = halo.halo_model(model, group=None)
    with pytest.raises(ValueError, match="process group"):
        hm(halo.to_torch(halo.local_halo_batch(part, 0), "cpu"))
    assert next(hm.parameters()) is next(model.parameters())


# ---------------------------------------------------------------- halo vs JAX

@pytest.fixture(scope="module")
def references():
    """Per variant: the port's weights (seed 0, non-unit scales), JAX's
    single-device E and F with those weights, and for GRAD_VARIANTS JAX's
    gradient of the halo loss (as a port state dict)."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.data.padding import PadDims, pad_batch as jax_pad_batch
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    out = {}
    for variant, kw in VARIANTS.items():
        batch, d = halo_data(kw["triplets_only"])
        model = port_model(variant)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        jmodel = make_model(JaxConfig(**kw, **TINY))
        jb = jax_pad_batch(d["g"], d["Z"], d["R"], PadDims(**dataclasses.asdict(d["dims"])),
                           E=d["E"], F=d["F"],
                           triplets_only=kw["triplets_only"])
        jbatch = {k: jnp.asarray(v) for k, v in jb.items()}
        cfg = ModelConfig(**kw, **TINY)
        variables = jax_variables(sd, cfg)
        E, F = jax.jit(lambda v, b: energy_and_forces(jmodel, v, b)[:2])(variables, jbatch)
        ref = dict(sd=sd, batch=batch, E=np.asarray(E), F=np.asarray(F))
        if variant in GRAD_VARIANTS:
            scales = variables["scale_factors"]

            def loss_single(params):
                E, F, _ = energy_and_forces(jmodel, {"params": params, "scale_factors": scales},
                                            jbatch)
                m = jbatch["mol_mask"].astype(jnp.float32)[:, None]
                am = jbatch["atom_mask"].astype(jnp.float32)[:, None]
                return (jnp.sum(jnp.abs(E - jbatch["E"]) * m)
                        + jnp.sum(jnp.abs(F[:, 0, :] - jbatch["F"]) * am))

            g = jax.jit(jax.grad(loss_single))(variables["params"])
            g = jax.tree_util.tree_map(np.asarray, g)
            ref["grad"] = state_dict_from_jax({"params": g, "scale_factors": scales}, cfg)
        out[variant] = ref
    return out


def _run_halo(world, references, tmp_path_factory):
    """Every halo case on one spawned gloo group of `world` ranks (the
    train step and eval on the group of 2)."""
    payload = {"weights": {v: r["sd"] for v, r in references.items()}, "train": world == 2}
    return world, spawn(_halo_rank, world, tmp_path_factory.mktemp(f"halo{world}"),
                        payload=payload)


@pytest.fixture(scope="module")
def halo2(references, tmp_path_factory):
    return _run_halo(2, references, tmp_path_factory)


@pytest.fixture(scope="module")
def halo4(references, tmp_path_factory):
    return _run_halo(4, references, tmp_path_factory)


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def halo_runs(request):
    return request.getfixturevalue(f"halo{request.param}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_halo_forward_matches_jax_single_device(halo_runs, references, variant):
    """E and F on every rank vs JAX's single-device energy_and_forces
    (tests/test_halo.py:111-137's gates), and the same bits on every rank."""
    world, results = halo_runs
    ref = references[variant]
    E0, F0 = results[0][("apply", variant)]
    for r, res in enumerate(results):
        E, F = res[("apply", variant)]
        np.testing.assert_allclose(E, ref["E"], rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(F, ref["F"], rtol=1e-4, atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(E, E0)
        np.testing.assert_array_equal(F, F0)


def test_halo_shards_gather_plain(halo_runs):
    """A halo shard carries no edge sort metadata (its edges are a shard's),
    so every gather site of its forward and -dE/dR but the swaps is a plain
    gather."""
    _, results = halo_runs
    for res in results:
        for variant in VARIANTS:
            gathers, keys = res[("gathers", variant)]
            assert keys == [] and gathers["gather.plain"] > 0
            # the swaps alone take their own VJP, as on one device
            assert gathers["gather.sorted"] == swap_sites(variant)


def test_halo_bf16_forward_matches_single_device(halo_runs, references):
    """compute_dtype="bfloat16" (the bf16 halo rows cross gloo as bytes):
    E and F of GemNet-Q on every rank against the port's single-device bf16
    predict, within tests/test_bf16.py's contract (E 0.03, F 0.05 of the
    magnitude: the same roundings, summed in other orders)."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces

    world, results = halo_runs
    ref = references["Q"]
    model = port_model("Q", ref["sd"], compute_dtype="bfloat16")
    E1, F1 = (t.detach().numpy() for t in energy_and_forces(model, to_torch(ref["batch"], "cpu")))
    for res in results:
        E, F = res[("apply_bf16", "Q")]
        assert np.abs(E - E1).max() <= 0.03 * np.abs(E1).max()
        assert np.abs(F - F1).max() <= 0.05 * np.abs(F1).max()
        np.testing.assert_array_equal(E, results[0][("apply_bf16", "Q")][0])


@pytest.mark.parametrize("variant", GRAD_VARIANTS)
def test_halo_grads_match_jax_single_device(halo_runs, references, variant):
    """Each parameter's gradient within 1e-4 + 1e-3 max|g| of JAX's
    single-device gradient (tests/test_halo.py:140-195), identical on every
    rank."""
    world, results = halo_runs
    ref = references[variant]["grad"]
    _, g0 = results[0][("grad", variant)]
    bad = []
    for name, a in ref.items():
        if name not in g0:
            continue  # the scale factors are buffers, not parameters
        a = a.numpy()
        err = np.abs(g0[name] - a).max()
        if err > 1e-4 + 1e-3 * np.abs(a).max():
            bad.append((name, float(err), float(np.abs(a).max())))
    assert not bad, bad[:10]
    assert sorted(g0) == sorted(k for k in ref if not k.endswith("scale_factor"))
    for res in results[1:]:
        _, g = res[("grad", variant)]
        for name in g0:
            np.testing.assert_array_equal(g[name], g0[name], err_msg=name)


def _single_device_trainer(variant, sd):
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.training import Trainer

    trainer = Trainer(port_model(variant, sd), TrainConfig(**HALO_TRAIN))
    return trainer, trainer.init_state()


@pytest.mark.parametrize("variant", TRAIN_VARIANTS)
def test_halo_train_step_matches_single_device(halo2, references, variant):
    """Three halo train steps (flat optimizer, EMA, device metrics) on 2
    ranks against the port's single-device Trainer from the same weights
    (tests/test_halo.py:241-282's gates); the state the same on both ranks."""
    world, results = halo2
    trainer, state = _single_device_trainer(variant, references[variant]["sd"])
    step = trainer.train_step_fn()
    ref_losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics, _ = step(state, references[variant]["batch"], 1.0)
        ref_losses.append(float(metrics["loss"]))
    losses, params, ema, acc = results[0][("train", variant)]
    for i, (a, b) in enumerate(zip(losses, ref_losses)):
        assert np.isclose(a, b, rtol=1e-4, atol=1e-6), (i, a, b)
    np.testing.assert_allclose(params, state.params.numpy(), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(ema, state.ema_params.numpy(), rtol=1e-3, atol=2e-5)
    np.testing.assert_allclose(acc, state.metric_acc.numpy(), rtol=1e-4, atol=1e-6)
    for res in results[1:]:
        for a, b in zip(res[("train", variant)][1:], (params, ema, acc)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("variant", TRAIN_VARIANTS)
def test_halo_eval_step_matches_single_device(halo2, references, variant):
    """The halo eval of the EMA weights on 2 ranks against the single-device
    eval of the same weights (tests/test_halo.py:353-383's gates)."""
    world, results = halo2
    trainer, state = _single_device_trainer(variant, references[variant]["sd"])
    metrics, counts, params, ema = results[0][("eval", variant)]
    state.params.copy_(torch.from_numpy(params))
    state.ema_params.copy_(torch.from_numpy(ema))
    assert not np.array_equal(params, ema)
    ref_m, ref_c = trainer.eval_step_fn()(state, references[variant]["batch"], use_ema=True)
    for k, v in ref_m.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=2e-5, atol=1e-7, err_msg=k)
    assert counts == {k: float(v) for k, v in ref_c.items()}
    for res in results[1:]:
        assert res[("eval", variant)][:2] == (metrics, counts)


def test_one_halopads_one_layout():
    """Two batches of other molecules partitioned to one HaloPads (grown over
    both, as train.py's --halo pads them) give every shard the same packed
    layout, segment plans included: one BatchPacker packs them without a
    new version, so a captured halo step replays across them."""
    from gemnet_pytorch_tpu_torch.data.packer import BatchPacker
    from gemnet_pytorch_tpu_torch.parallel import halo

    raws = [_random_graph(False, seed, n_mol=4) for seed in (3, 4)]
    pads = halo.estimate_halo_pads(raws, 2, n_mol=4)
    packer = BatchPacker()
    layouts = []
    for g, Z, R, E, F in raws:
        part = halo.build_halo_partition(g, Z, R, 2, E=E, F=F, pads=pads)
        assert part["halo_pads"] == pads
        for shard in range(2):
            packer.pack(halo.local_halo_batch(part, shard))
            layouts.append(list(packer.layout))
    assert packer.version == 0 and all(lay == layouts[0] for lay in layouts)
    assert {k for k, *_ in layouts[0] if k.endswith(".items")} == {
        "id3_reduce_ca_plan.items", "id4_reduce_ca_plan.items"}
