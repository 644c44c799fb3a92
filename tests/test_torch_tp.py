"""The port's tensor parallelism (`gemnet_pytorch_tpu_torch/parallel/tp.py`)
against the JAX package on the CPU, as tests/test_tp.py holds JAX's:

- `tp_param_specs` shards exactly the tensors JAX's `tp_param_specs`
  shards on a ("tp",) mesh of 2 and 4 devices, matched through
  `compat.flax_path`, each on the dim its layout maps JAX's to (a Dense
  (out, in) on dim 0, a 3-D weight on dim 2, the embedding table on dim 1);
- at config.yaml's widths 147 of GemNet-Q's 153 tensors shard, and a rank
  holds 1 079 558 / 540 102 of its 2 158 470 parameters at N = 2 / 4;
- `shard_tp_state_dict` and `merge_tp_state_dict` round-trip bit for bit;
- with no group (N = 1) the TPModel computes the single device's bits;
- on spawned gloo groups of 2 and 4 ranks (the children import no JAX):
  E and F of GemNet-Q, -dQ, -T and -dT against the port's single device at
  tests/test_tp.py:50-53's gates and the port's single device against
  JAX's at tests/test_torch_model.py's parity gates; the gradients of
  tests/test_tp.py:61-67's loss, merged over the ranks, against JAX's
  single-device gradient (tests/test_tp.py:81-84's gates); on 2 ranks, 3
  train steps against JAX's single-device tree-mode Trainer
  (tests/test_tp.py:118-139's gates) once with a grad_clip_max that makes
  the global-norm clip act (the norm, summed over the ranks, is above it)
  and once with AGC at one that makes AGC clip units on every rank; after
  them `check_tp_opt_sharding` holds, the
  replicated parameters are bit-equal on every rank, and every rank issued
  its collectives in one order.

Every JAX reference comes from ONE `model.init` (GemNet-dQ at
tests/test_tp.py's widths), each case taking its part through
`compat.state_dict_from_jax`; the batch is tests/test_tp.py's (2 molecules
of up to 7 atoms, seed 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_halo import jax_variables, load_payload, spawn

torch.set_num_threads(2)

VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dQ": dict(triplets_only=False, direct_forces=True),
            "T": dict(triplets_only=True, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True)}
# tests/test_tp.py:118's TrainConfig, and the two clips its steps run with,
# each at a grad_clip_max where it acts (at the default 10 neither clips)
TRAIN = dict(batch_size=2, weight_decay=2e-6, rho_force=0.9, warmup_steps=2,
             flat_optimizer=False)
TRAIN_MODES = {"clip": dict(grad_clip_max=1e-3), "agc": dict(agc=True, grad_clip_max=1e-3)}
TRAIN_STEPS = 3
# config.yaml's widths: GemNet-Q's tensors, parameters, and a rank's share
CONFIG_TENSORS, CONFIG_SHARDED, CONFIG_PARAMS = 153, 147, 2_158_470
CONFIG_RANK_PARAMS = {2: 1_079_558, 4: 540_102}


# ---------------------------------------------------------------- JAX side

def jax_cfg(variant: str):
    """tests/test_tp.py's `_small_cfg` of a variant."""
    from __graft_entry__ import _small_cfg

    return _small_cfg(**VARIANTS[variant])


def port_cfg(jcfg):
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    return ModelConfig.from_dict(dataclasses.asdict(jcfg))


def batch_of(jcfg):
    """tests/test_tp.py::_setup's padded batch (2 molecules, seed 3)."""
    from __graft_entry__ import _make_graphs, _pad, _shared_dims

    tup = _make_graphs(jcfg, n_molecules=2, seed=3, max_atoms=7)
    return _pad(jcfg, tup, _shared_dims(jcfg, [tup]))


def init_variables():
    """JAX's initial variables of GemNet-dQ at tests/test_tp.py's widths (every
    variant's weights are a part of its tree), as numpy."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.models import make_model

    jcfg = jax_cfg("dQ")
    sample = {k: jnp.asarray(v) for k, v in batch_of(jcfg).items()}
    variables = jax.jit(make_model(jcfg).init)(jax.random.PRNGKey(0), sample)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def tp_loss(E, F, b):
    """tests/test_tp.py:61-67's loss, in either package's arrays."""
    if isinstance(E, torch.Tensor):
        m, am, xp = b["mol_mask"].float()[:, None], b["atom_mask"].float()[:, None], torch
    else:
        import jax.numpy as xp

        m = b["mol_mask"].astype(xp.float32)[:, None]
        am = b["atom_mask"].astype(xp.float32)[:, None]
    return xp.sum(xp.abs(E - b["E"]) * m) + xp.sum(xp.abs(F[:, 0, :] - b["F"]) * am)


def port_model(sd, cfg):
    from gemnet_pytorch_tpu_torch.models import GemNet

    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def references():
    """From one init: per variant the port's weights, the batch, and JAX's
    and the port's single-device E and F; for GemNet-Q the loss and gradient
    of `tp_loss` (a port state dict) and, per train mode, 3 steps of JAX's
    single-device tree-mode Trainer (losses, parameters and EMA as port
    state dicts) and the port's global gradient norm of the first step."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import energy_and_forces, make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces as port_ef

    variables = init_variables()
    out = {"variables": variables, "ef": {}}
    for variant in VARIANTS:
        jcfg = jax_cfg(variant)
        cfg = port_cfg(jcfg)
        sd = state_dict_from_jax(variables, cfg)
        batch = batch_of(jcfg)
        model = make_model(jcfg)
        E, F, _ = jax.jit(lambda v, b: energy_and_forces(model, v, b))(
            jax_variables(sd, cfg), {k: jnp.asarray(x) for k, x in batch.items()})
        pE, pF = port_ef(port_model(sd, cfg), to_torch(batch, "cpu"))
        out["ef"][variant] = dict(sd=sd, batch=batch, jax=(np.asarray(E), np.asarray(F)),
                                  port=(pE.detach().numpy(), pF.detach().numpy()))
    # the gradient of tests/test_tp.py's loss, and the train steps, of GemNet-Q
    jcfg, case = jax_cfg("Q"), out["ef"]["Q"]
    cfg = port_cfg(jcfg)
    model = make_model(jcfg)
    jv = jax_variables(case["sd"], cfg)
    jbatch = {k: jnp.asarray(x) for k, x in case["batch"].items()}

    def loss_of(params):
        E, F, _ = energy_and_forces(model, {"params": params,
                                            "scale_factors": jv["scale_factors"]}, jbatch)
        return tp_loss(E, F, jbatch)

    loss, grad = jax.jit(jax.value_and_grad(loss_of))(jv["params"])
    out["grad"] = dict(loss=float(loss), grad=state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, grad),
         "scale_factors": jv["scale_factors"]}, cfg))

    def port_sd(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return state_dict_from_jax({"params": tree, "scale_factors": jv["scale_factors"]}, cfg)

    out["train"] = {}
    for mode, kw in TRAIN_MODES.items():
        from gemnet_pytorch_tpu.training import Trainer as JaxTrainer

        trainer = JaxTrainer(model, JaxTrainConfig(**TRAIN, **kw))
        state = trainer.init_state(jv)
        step = trainer.train_step_fn()
        losses = []
        for _ in range(TRAIN_STEPS):
            state, metrics, _ = step(state, jbatch, jnp.float32(1.0))
            losses.append(float(metrics["loss"]))
        out["train"][mode] = dict(losses=losses, params=port_sd(trainer.params_tree(state.params)),
                                  ema=port_sd(trainer.ema_tree(state)))
        out["train"][mode]["port"] = port_steps(case["sd"], cfg, case["batch"], kw)
    out["train"]["clip"]["norm"] = port_first_norm(case["sd"], cfg, case["batch"])
    return out


def port_steps(sd, cfg, batch, kw) -> dict:
    """The port's single-device tree-mode Trainer, 3 steps: the losses, and
    the parameters and EMA as state dicts."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.training import Trainer

    trainer = Trainer(port_model(sd, cfg), TrainConfig(**TRAIN, **kw))
    state = trainer.init_state()
    b = to_torch(batch, "cpu")
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics, _ = trainer.train_step(state, b, 1.0)
        losses.append(float(metrics["loss"]))
    params = {n: t.detach().clone() for n, t in trainer.model.state_dict().items()}
    with trainer.weights(state, use_ema=True):
        ema = {n: t.detach().clone() for n, t in trainer.model.state_dict().items()}
    return dict(losses=losses, params=params, ema=ema)


def port_first_norm(sd, cfg, batch) -> float:
    """The global norm of the port's single-device first step's gradient,
    shared layers scaled, as the clip takes it (`tree_opt.global_norm`)."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.training import Trainer, tree_opt

    trainer = Trainer(port_model(sd, cfg), TrainConfig(**TRAIN, **TRAIN_MODES["clip"]))
    trainer.init_state()
    params = list(trainer.model.parameters())
    loss, _ = trainer._loss_and_metrics(to_torch(batch, "cpu"), create_graph=True)
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return float(tree_opt.global_norm(tree_opt.scale_shared_grads(grads, trainer.layout)))


# ---------------------------------------------------------------- the specs

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_specs_match_jax(references, variant, n):
    """The port shards exactly the tensors JAX's `tp_param_specs` shards on
    a ("tp",) mesh of n devices, on the dims JAX's layouts map to."""
    import jax
    from jax.sharding import PartitionSpec as P

    from gemnet_pytorch_tpu.parallel.mesh import make_mesh
    from gemnet_pytorch_tpu.parallel.tp import tp_param_specs as jax_specs
    from gemnet_pytorch_tpu_torch.compat import flax_path
    from gemnet_pytorch_tpu_torch.parallel import tp_param_specs

    cfg = port_cfg(jax_cfg(variant))
    sd = references["ef"][variant]["sd"]
    specs = tp_param_specs(port_model(sd, cfg), n)
    jv = jax_variables(sd, cfg)["params"]
    flat = {tuple(getattr(k, "key", k) for k in path): s for path, s in
            jax.tree_util.tree_flatten_with_path(
                jax_specs(jv, make_mesh(n, axis_names=("tp",))),
                is_leaf=lambda x: isinstance(x, P))[0]}
    assert len(flat) == len(specs)
    for name, dim in specs.items():
        jspec = flat[flax_path(name)]
        if jspec == P():
            assert dim is None, name
            continue
        jdim = list(jspec).index("tp")
        ndim = sd[name].ndim
        # JAX's (in, out) kernel shards its last dim, the port's (out, in) Dense its first
        want = 0 if ndim == 2 and name.endswith(".weight") and flax_path(name)[-1] == "kernel" \
            else jdim
        assert dim == want, (name, dim, jspec)
    assert sum(d is not None for d in specs.values()) > 50


@pytest.mark.parametrize("n", [2, 4])
def test_config_widths_shares(n):
    """At config.yaml's widths (GemNet-Q) 147 of 153 tensors shard; the six
    that do not are the Bessel frequencies and the five energy heads; a
    rank's slices hold 1 079 558 (N = 2) / 540 102 (N = 4) parameters."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.parallel import shard_tp_state_dict, tp_param_specs

    model = GemNet(ModelConfig(), generator=torch.Generator().manual_seed(0), device="cpu")
    specs = tp_param_specs(model, n)
    params = dict(model.named_parameters())
    assert len(params) == CONFIG_TENSORS
    assert sum(p.numel() for p in params.values()) == CONFIG_PARAMS
    whole = sorted(k for k, d in specs.items() if d is None)
    assert len(whole) == CONFIG_TENSORS - CONFIG_SHARDED
    assert whole == sorted(["rbf_basis.frequencies"] + [
        f"out_blocks.{i}.out_energy.weight" for i in range(5)])
    for r in range(n):
        mine = shard_tp_state_dict({k: p.detach() for k, p in params.items()}, specs, n, r)
        assert sum(t.numel() for t in mine.values()) == CONFIG_RANK_PARAMS[n]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_merge_round_trip(references, n):
    """Merging every rank's `shard_tp_state_dict` gives the state dict back
    bit for bit (scale factors included); each slice is contiguous and 1/n
    of its tensor along its dim."""
    from gemnet_pytorch_tpu_torch.parallel import (
        merge_tp_state_dict, shard_tp_state_dict, tp_param_specs)

    sd = references["ef"]["Q"]["sd"]
    specs = tp_param_specs(port_model(sd, port_cfg(jax_cfg("Q"))), n)
    shards = [shard_tp_state_dict(sd, specs, n, r) for r in range(n)]
    for key, dim in specs.items():
        for s in shards:
            assert s[key].is_contiguous()
            if dim is not None:
                assert s[key].shape[dim] * n == sd[key].shape[dim]
    merged = merge_tp_state_dict(shards, specs)
    assert sorted(merged) == sorted(sd)
    for key in sd:
        assert torch.equal(merged[key], sd[key]), key


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_one_rank_is_the_single_device(references, variant):
    """N = 1, no group: the TPModel's E and F are the single device's bits
    (one all-gather of one rank is the identity, the permutation the
    single device's layout)."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import TPModel, make_tp_energy_and_forces

    ref = references["ef"][variant]
    model = TPModel(port_cfg(jax_cfg(variant)), None, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    model.load_state_dict(ref["sd"], strict=True)
    E, F = make_tp_energy_and_forces(model)(to_torch(ref["batch"], "cpu"))
    np.testing.assert_array_equal(E.detach().numpy(), ref["port"][0])
    np.testing.assert_array_equal(F.detach().numpy(), ref["port"][1])


def test_tp_trainer_refusals():
    """A `TPTrainer` trains a `TPModel` in tree mode only, and the tp
    functions take a `TPTrainer`, not a plain Trainer of a TPModel (whose
    step would neither reduce the replicated gradients nor sum the clip's
    norm over the group)."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.parallel import TPModel, TPTrainer, init_tp_state
    from gemnet_pytorch_tpu_torch.training import Trainer

    cfg = port_cfg(jax_cfg("T"))
    model = TPModel(cfg, None, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="flat_optimizer=False"):
        TPTrainer(model, TrainConfig(flat_optimizer=True))
    with pytest.raises(TypeError, match="TPTrainer"):
        init_tp_state(Trainer(model, TrainConfig(**TRAIN)))
    with pytest.raises(TypeError, match="TPModel"):
        TPTrainer(GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
                  TrainConfig(**TRAIN))
    trainer = TPTrainer(model, TrainConfig(**TRAIN))
    init_tp_state(trainer)
    assert trainer.process_groups() == (None, None, None)


# ---------------------------------------------------------------- the ranks

def _tp_model(case, rank, world, group):
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.parallel import tp

    cfg = ModelConfig(**case["cfg"])
    model = tp.TPModel(cfg, group, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(tp.shard_tp_state_dict(case["sd"], model.tp_specs, world, rank),
                          strict=True)
    return model


def _tp_rank(rank, world, directory, group):
    """Every case of the payload on this rank of a tp group."""
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import collectives, tp
    from gemnet_pytorch_tpu_torch.training import tree_opt

    payload = load_payload(directory)
    out = {}
    for variant, case in payload["ef"].items():
        model = _tp_model(case, rank, world, group)
        with collectives.recorded() as seq:
            E, F = tp.make_tp_energy_and_forces(model)(to_torch(case["batch"], "cpu"))
        out[("ef", variant)] = (E.detach().numpy(), F.detach().numpy(), seq)
    case = payload["ef"]["Q"]
    model = _tp_model(case, rank, world, group)
    out["specs"] = model.tp_specs
    batch = to_torch(case["batch"], "cpu")
    with collectives.recorded() as seq:
        loss, grads = tp.make_tp_loss_and_grad(model, tp_loss)(batch)
    out["grad"] = (float(loss), {k: g.numpy().copy() for k, g in grads.items()}, seq)
    for mode, kw in payload["train"].items():
        trainer = tp.TPTrainer(_tp_model(case, rank, world, group), TrainConfig(**TRAIN, **kw))
        state = tp.init_tp_state(trainer)
        # the first step's gradient as the clips take it: its global norm,
        # and the units of this rank's tensors that AGC scales
        first, _ = trainer._loss_and_metrics(batch, create_graph=True)
        g = tree_opt.scale_shared_grads(trainer.gradients(first), trainer.layout)
        norm = float(trainer.grad_norm(g))
        params = list(trainer.model.parameters())
        agc = tree_opt.adaptive_gradient_clip(g, params, trainer.layout, trainer.cfg.grad_clip_max)
        clipped = sum(int((tree_opt.unitwise_norm(a - b, dims) > 0).sum()) for a, b, dims in
                      zip(agc, g, trainer.layout.unit_dims))
        step = tp.make_tp_train_step(trainer)
        losses = []
        with collectives.recorded() as seq:
            for _ in range(TRAIN_STEPS):
                state, metrics, _ = step(state, batch, 1.0)
                losses.append(float(metrics["loss"]))
        tp.check_tp_opt_sharding(trainer, state)
        local = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        out[("train", mode)] = dict(
            losses=losses, norm=norm, clipped=clipped, seq=seq, local=local,
            params=tp.merged_state_dict(trainer, state),
            ema=tp.merged_state_dict(trainer, state, ema=True),
            moments={n: t.shape for n, t in state.opt_state.mu.items()})
    return out


def _payload(references, world: int):
    out = {"ef": {v: dict(cfg=dataclasses.asdict(port_cfg(jax_cfg(v))), sd=r["sd"],
                          batch=r["batch"]) for v, r in references["ef"].items()},
           "train": TRAIN_MODES if world == 2 else {}}
    return out


@pytest.fixture(scope="module")
def tp2(references, tmp_path_factory):
    return spawn(_tp_rank, 2, tmp_path_factory.mktemp("tp2"), payload=_payload(references, 2))


@pytest.fixture(scope="module")
def tp4(references, tmp_path_factory):
    return spawn(_tp_rank, 4, tmp_path_factory.mktemp("tp4"), payload=_payload(references, 4))


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def tp_runs(request):
    return request.param, request.getfixturevalue(f"tp{request.param}")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_matches_single_device(tp_runs, references, variant):
    """E and F on every rank against the port's single device at
    tests/test_tp.py:50-53's gates (rtol 2e-5, atol 2e-6), the same bits on
    every rank, and the port's single device against JAX's at
    tests/test_torch_model.py's parity gates (E 2e-4; F 2e-4 direct, 5e-4
    -dE/dR); one all-gather of the rank's slices, the only collective."""
    world, results = tp_runs
    ref = references["ef"][variant]
    E0, F0, seq0 = results[0][("ef", variant)]
    for res in results:
        E, F, seq = res[("ef", variant)]
        np.testing.assert_allclose(E, ref["port"][0], rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(F, ref["port"][1], rtol=2e-5, atol=2e-6)
        np.testing.assert_array_equal(E, E0)
        np.testing.assert_array_equal(F, F0)
        assert seq == seq0
    assert [k for k, _, _ in seq0] == ["all_gather"]
    f_tol = 2e-4 if VARIANTS[variant]["direct_forces"] else 5e-4
    for got, want, tol in zip(ref["port"], ref["jax"], (2e-4, f_tol)):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_tp_gradients_match_jax_single_device(tp_runs, references):
    """tests/test_tp.py:61-84: the loss (rtol 1e-5) and every parameter's
    gradient, each rank's slices merged, against JAX's single-device
    gradient (rtol 2e-4, atol 1e-5); each rank's gradient is its slice, a
    replicated one the same bits on every rank; the collectives one
    sequence: the gather, the replicated gradients' all-reduce."""
    from gemnet_pytorch_tpu_torch.parallel import merge_tp_state_dict

    world, results = tp_runs
    ref = references["grad"]
    specs = results[0]["specs"]
    for res in results:
        loss, grads, seq = res["grad"]
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        assert seq == results[0]["grad"][2]
        for name, g in grads.items():
            if specs[name] is None:
                np.testing.assert_array_equal(g, results[0]["grad"][1][name], err_msg=name)
            else:
                assert g.shape[specs[name]] * world == ref["grad"][name].shape[specs[name]]
    assert [k for k, _, _ in results[0]["grad"][2]] == ["all_gather", "all_reduce"]
    merged = merge_tp_state_dict([{k: torch.from_numpy(g) for k, g in res["grad"][1].items()}
                                  for res in results], specs)
    assert sorted(merged) == sorted(k for k in ref["grad"] if not k.endswith("scale_factor"))
    for name, g in merged.items():
        np.testing.assert_allclose(g.numpy(), ref["grad"][name].numpy(), rtol=2e-4, atol=1e-5,
                                   err_msg=name)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_tp_train_steps_match_jax_single_device(tp2, references, mode):
    """3 tp train steps at N = 2 (the per-tensor AMSGrad over the rank's
    slices, the EMA), the merged state the same on both ranks, against the
    single device at tests/test_tp.py:118-139's gates (losses rtol 1e-5,
    merged parameters and EMA rtol 1e-3 atol 5e-6): the port's single
    device, and JAX's tree-mode Trainer where the port's single device
    meets them too. "clip": the global-norm clip at 1e-3 acts (the first
    step's norm, summed over the ranks, equals the single device's and is
    above it); against JAX at the gates. "agc": AGC at 1e-3 clips units of
    every rank's slices; against JAX the losses at rtol 1e-5 and the update
    within a relative L2 error of 1e-3 (tests/test_torch_mve.py's trajectory
    gate). Without the global-norm clip's scaling, the port's single device
    itself lands 5-6 elements of `mlp_cbf4.weight`'s column 36 outside the
    elementwise gate from JAX after 3 steps, with AGC on or off. That column
    takes the basis term l = 6, n = 0, whose spherical Bessel factor j_6,
    evaluated in fp32 from its closed form, keeps no relative precision at
    short distances in either package; its gradient there is ~1e-7, near
    Adam's eps, and differs between the packages, and Adam's normalisation
    makes a full-size step of it. AGC clips the same units in both
    packages, none within 1e-3 of its threshold."""
    ref = references["train"][mode]
    out = tp2[0][("train", mode)]
    p0 = references["ef"]["Q"]["sd"]
    wants = [ref["port"]] + ([ref] if mode == "clip" else [])
    for want in wants:
        np.testing.assert_allclose(out["losses"], want["losses"], rtol=1e-5)
        for got, w in ((out["params"], want["params"]), (out["ema"], want["ema"])):
            assert sorted(got) == sorted(w)
            for name in w:
                np.testing.assert_allclose(got[name].numpy(), w[name].numpy(), rtol=1e-3,
                                           atol=5e-6, err_msg=name)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
    for got, w in ((out["params"], ref["params"]), (out["ema"], ref["ema"])):
        names = sorted(w)
        moved = np.concatenate([(got[n] - p0[n]).numpy().ravel() for n in names])
        assert _rel_l2(moved, np.concatenate([(w[n] - p0[n]).numpy().ravel()
                                              for n in names])) < 1e-3
    if mode == "clip":
        np.testing.assert_allclose(out["norm"], ref["norm"], rtol=1e-5)
        assert out["norm"] > TRAIN_MODES["clip"]["grad_clip_max"]
    else:
        assert all(res[("train", mode)]["clipped"] > 0 for res in tp2)
    other = tp2[1][("train", mode)]
    assert other["losses"] == out["losses"]
    for name in out["params"]:
        assert torch.equal(other["params"][name], out["params"][name]), name
        assert torch.equal(other["ema"][name], out["ema"][name]), name


@pytest.mark.parametrize("mode", list(TRAIN_MODES))
def test_tp_state_stays_sharded_and_replicas_agree(tp2, mode):
    """After the steps (`check_tp_opt_sharding` held on each rank): every
    moment of a sharded parameter is the rank's slice, the replicated
    parameters are the same bits on both ranks and the sharded ones differ
    (two slices), and both ranks issued their collectives in one order: a
    step's all-gather, the replicated gradients' all-reduce and, under the
    global-norm clip, the norm's."""
    a, b = (res[("train", mode)] for res in tp2)
    specs = tp2[0]["specs"]
    for name, t in a["local"].items():
        if specs[name] is None:
            assert torch.equal(t, b["local"][name]), name
        else:
            assert a["moments"][name] == t.shape
            assert t.shape[specs[name]] * 2 == a["params"][name].shape[specs[name]]
    assert a["seq"] == b["seq"]
    per_step = ["all_gather", "all_reduce"] + (["all_reduce"] if mode == "clip" else [])
    assert [k for k, _, _ in a["seq"]] == per_step * TRAIN_STEPS
    # the gather moves the rank's slices, the all-reduce the replicated floats
    (_, _, (gathered,)), (_, _, (replicated,)) = a["seq"][:2]
    n_sharded = sum(t.numel() for n, t in a["local"].items() if specs[n] is not None)
    assert gathered == (n_sharded,)
    assert replicated == (sum(t.numel() for n, t in a["local"].items() if specs[n] is None),)
