"""The port's pipeline (`gemnet_pytorch_tpu_torch/parallel/pp.py`) against the
JAX package on the CPU, as tests/test_pp.py holds JAX's:

- `split_pp_state_dict` equals JAX's `split_pp_variables` stage for stage
  (JAX's stage-local block and scale names renamed back to the monolithic
  ones with its own `_rename_scales`), at 1, 2 and 4 stages, and
  `merge_pp_state_dict` undoes it bit for bit;
- a rank's `PipelineStage` holds the preamble and 1/S of the block stack:
  at config.yaml's widths 1 149 574 and 645 126 of GemNet-Q's 2 158 470
  parameters for S = 2 and 4, the kept weights those of the monolithic
  model drawn from the same generator;
- on spawned gloo groups of 2 and 4 ranks (the children import no JAX):
  the neighbour shift's forward, backward and double backward against a
  one-process emulation (fp32 and bf16, which gloo moves as bytes); E and
  F of GemNet-Q, -dQ, -T and -dT at S = 1 (no group), 2 and 4 against
  JAX's single-device model per microbatch (tests/test_pp.py:49-67's
  gates); the gradients of tests/test_pp.py:70-118's force loss (rtol
  2e-3, atol 1e-4), the preamble's the same on every rank, and every
  rank's collectives in one sequence; 3 `PPTrainer` steps at S = 2
  against JAX's single-device flat step on the concatenated loss
  (tests/test_pp.py:121-200's gates: losses rtol 1e-5, merged parameters
  and EMA rtol 2e-3 atol 2e-6);
- `python -m gemnet_pytorch_tpu_torch.train --pp 2 --pp-micro 4` on 2
  spawned ranks (the command line as torchrun starts it): rank-0
  checkpoints holding both stages, a resume on both ranks, the eval of the
  merged EMA weights, the export, and the same best metrics on both.

The weights are JAX's, carried into the port by `compat.state_dict_from_jax`;
the microbatches are tests/test_pp.py's (2 molecules of up to 7 atoms each,
padded to shared dims)."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

from test_torch_halo import load_payload, spawn

torch.set_num_threads(2)

VARIANTS = {"Q": dict(triplets_only=False, direct_forces=False),
            "dQ": dict(triplets_only=False, direct_forces=True),
            "T": dict(triplets_only=True, direct_forces=False),
            "dT": dict(triplets_only=True, direct_forces=True)}
# microbatches of the E/F runs (tests/test_pp.py:54), the gradient run
# (:75) and the train steps (:130), each of 2 molecules of up to 7 atoms
EF_MICRO, GRAD_MICRO, TRAIN_MICRO = 3, 4, 3
MAX_ATOMS = 7
# the blocks of each stage count's E/F runs: tests/test_pp.py's 2, and 4
# where S = 4
EF_BLOCKS = {1: 2, 2: 2, 4: 4}
# tests/test_pp.py:133's TrainConfig
TRAIN = dict(batch_size=2, weight_decay=2e-6, rho_force=0.9, loss="rmse", warmup_steps=2,
             grad_clip_max=1e-3)
TRAIN_STEPS = 3


# ---------------------------------------------------------------- JAX side

def jax_cfg(variant: str, num_blocks: int = 2):
    """tests/test_pp.py's `_tiny_cfg` of a variant, with `num_blocks`."""
    from test_pp import _tiny_cfg

    return dataclasses.replace(_tiny_cfg(**VARIANTS[variant]), num_blocks=num_blocks)


def port_cfg(jcfg):
    from gemnet_pytorch_tpu_torch.config import ModelConfig

    return ModelConfig.from_dict(dataclasses.asdict(jcfg))


def molecules(seed: int):
    """The 2 molecules of up to 7 atoms of `_make_graphs(cfg, 2, seed, 7)`
    (tests/test_pp.py:25-33), with their toy targets."""
    from gemnet_pytorch_tpu.data.synthetic import _toy_energy_forces, random_molecule

    rng = np.random.default_rng(seed)
    mols = [random_molecule(rng, int(rng.integers(5, MAX_ATOMS + 1))) for _ in range(2)]
    return [(z, r, *_toy_energy_forces(z, r)) for z, r in mols]


def padded(jcfg, groups):
    """One padded numpy batch per group of molecules, at one PadDims
    (`_shared_dims`, tests/test_pp.py:25-35)."""
    from __graft_entry__ import _pad, _shared_dims

    from gemnet_pytorch_tpu.data.graph import build_graph

    tups = []
    for mols in groups:
        N = np.array([len(z) for z, _, _, _ in mols])
        R = np.concatenate([r for _, r, _, _ in mols])
        g = build_graph(R, N, jcfg.cutoff, jcfg.int_cutoff, triplets_only=jcfg.triplets_only)
        tups.append((g, np.concatenate([z for z, _, _, _ in mols]), R,
                     np.array([e for _, _, e, _ in mols], np.float32),
                     np.concatenate([f for _, _, _, f in mols]), len(mols)))
    dims = _shared_dims(jcfg, tups)
    return [_pad(jcfg, t, dims) for t in tups]


def microbatches(jcfg, n_micro: int):
    """tests/test_pp.py::_setup's microbatches (seeds 0 .. n_micro - 1)."""
    return padded(jcfg, [molecules(s) for s in range(n_micro)])


def init_variables():
    """JAX's initial variables of the widest tree the tests use (GemNet-dQ,
    4 blocks: every variant's and 2 blocks' weights are a part of it), as
    numpy: the weights of every case, each taking its own part
    (`compat.state_dict_from_jax` with the case's config)."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.models import make_model

    jcfg = jax_cfg("dQ", 4)
    sample = {k: jnp.asarray(v) for k, v in microbatches(jcfg, 1)[0].items()}
    variables = jax.jit(make_model(jcfg).init)(jax.random.PRNGKey(0), sample)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def case(variables, jcfg, n_micro: int):
    """(the port's state dict, JAX's model and variables of it, the
    microbatches) of one configuration."""
    from test_torch_halo import jax_variables

    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    sd = state_dict_from_jax(variables, port_cfg(jcfg))
    return sd, make_model(jcfg), jax_variables(sd, port_cfg(jcfg)), microbatches(jcfg, n_micro)


def jax_loss(E, F, b):
    """tests/test_pp.py:80-87's loss over (stacked) outputs, in either
    package's arrays."""
    if isinstance(E, torch.Tensor):
        m, am, xp = b["mol_mask"].float()[..., None], b["atom_mask"].float()[..., None], torch
    else:
        import jax.numpy as xp

        m = b["mol_mask"].astype(xp.float32)[..., None]
        am = b["atom_mask"].astype(xp.float32)[..., None]
    return xp.sum(xp.abs(E - b["E"]) * m) + xp.sum(xp.abs(F[..., 0, :] - b["F"]) * am)


@pytest.fixture(scope="module")
def references():
    """JAX's side, from one init (`init_variables`): per variant at 2 and 4
    blocks, the port's weights, the microbatches, and JAX's and the port's
    single-device E and F of each; for GemNet-Q at 2 blocks, the force loss's value and
    gradient summed over 4 microbatches (a port state dict), and 3 steps of
    JAX's single-device flat Trainer on the concatenated loss of 3
    microbatches (one batch of their 6 molecules): the losses, and the
    parameters and EMA after them as port state dicts."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import TrainConfig as JaxTrainConfig
    from gemnet_pytorch_tpu.models import energy_and_forces
    from gemnet_pytorch_tpu.training import Trainer as JaxTrainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    variables = init_variables()
    out = {"variables": variables, "ef": {}}
    for num_blocks in sorted(set(EF_BLOCKS.values())):
        for variant in VARIANTS:
            jcfg = jax_cfg(variant, num_blocks)
            sd, model, jv, shards = case(variables, jcfg, EF_MICRO)
            apply = jax.jit(lambda v, b: energy_and_forces(model, v, b)[:2])
            ef = [apply(jv, {k: jnp.asarray(x) for k, x in b.items()}) for b in shards]
            out["ef"][variant, num_blocks] = dict(sd=sd, shards=shards, ef=tuple(
                np.stack([np.asarray(o[i]) for o in ef]) for i in range(2)))
            out["ef"][variant, num_blocks]["port"] = port_single_device(
                out["ef"][variant, num_blocks], jcfg)
    # the force loss's gradient (tests/test_pp.py:70-118): the sum over the
    # microbatches of each one's gradient
    jcfg = jax_cfg("Q")
    sd, model, jv, shards = case(variables, jcfg, GRAD_MICRO)

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
    # the single-device flat step (tests/test_pp.py:121-200) on one batch of
    # the microbatches' molecules: the loss of the flattened stack
    sd, model, jv, shards = case(variables, jcfg, TRAIN_MICRO)
    (whole,) = padded(jcfg, [sum((molecules(s) for s in range(TRAIN_MICRO)), [])])
    trainer = JaxTrainer(model, JaxTrainConfig(**TRAIN))
    state = trainer.init_state(jv)
    step = trainer.train_step_fn()
    batch = {k: jnp.asarray(x) for k, x in whole.items()}
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics, _ = step(state, batch, jnp.float32(1.0))
        losses.append(float(metrics["loss"]))

    def port_sd(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return state_dict_from_jax({"params": tree, "scale_factors": jv["scale_factors"]},
                                   port_cfg(jcfg))

    out["train"] = dict(sd=sd, shards=shards, losses=losses,
                        params=port_sd(trainer.params_tree(state.params)),
                        ema=port_sd(trainer.ema_tree(state)))
    return out


# ---------------------------------------------------------------- the split

@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_split_matches_jax_split(references, n_stages):
    """Stage s of the port's split holds what JAX's `split_pp_variables`
    puts in its slice s, renamed to the monolithic blocks (JAX's
    `_rename_scales` back to global scale names), bit for bit, and the
    preamble what JAX's pre_vars hold; the merge gives the state dict back."""
    import jax

    from gemnet_pytorch_tpu.parallel.pp import _rename_scales, split_pp_variables
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.parallel import merge_pp_state_dict, split_pp_state_dict
    from gemnet_pytorch_tpu_torch.parallel.pp import block_of

    nb = 4 if n_stages == 4 else 2
    jcfg = jax_cfg("Q", nb)
    sd, _, variables, _ = case(references["variables"], jcfg, 1)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    pre, stages = split_pp_state_dict(sd, nb, n_stages)
    jpre, jstage = split_pp_variables(variables, nb, n_stages)
    jstage = jax.tree_util.tree_map(np.asarray, jstage)
    k = nb // n_stages
    assert len(stages) == n_stages
    for s in range(n_stages):
        # JAX's slice s under monolithic names, the other blocks as they were
        tree = {col: dict(variables[col]) for col in variables}
        for col in jstage:
            for j in range(k):
                i = s * k + j
                tree[col][f"int_blocks_{i}"] = _rename_scales(jax.tree_util.tree_map(
                    lambda x: x[s], jstage[col][f"iblock_{j}"]), i + 1)
                tree[col][f"out_blocks_{i + 1}"] = _rename_scales(jax.tree_util.tree_map(
                    lambda x: x[s], jstage[col][f"oblock_{j}"]), i + 1)
        held = state_dict_from_jax(tree, port_cfg(jcfg))
        mine = {key for key in held if block_of(key) is not None and block_of(key) // k == s}
        assert set(stages[s]) == mine
        for key in mine:
            torch.testing.assert_close(stages[s][key], held[key], rtol=0, atol=0)
    # the preamble: JAX's pre_vars with the monolithic blocks beside them
    tree = {col: {**variables[col], **jpre[col]} for col in variables}
    held = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), port_cfg(jcfg))
    assert set(pre) == {key for key in held if block_of(key) is None}
    for key in pre:
        torch.testing.assert_close(pre[key], held[key], rtol=0, atol=0)
    merged = merge_pp_state_dict(pre, stages)
    assert sorted(merged) == sorted(sd)
    for key in sd:
        assert torch.equal(merged[key], sd[key]), key


@pytest.mark.parametrize("n_stages", [2, 4])
def test_stage_holds_its_share_of_the_parameters(n_stages):
    """At config.yaml's widths (GemNet-Q) each rank's PipelineStage holds
    the 140 678 preamble parameters and 2 017 792 / S of the block stack's
    (53% and 30% of the model for S = 2 and 4), all on its device, each
    equal to the monolithic model's drawn from the same generator; the
    monolithic forward is refused."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.parallel import PipelineStage

    cfg = ModelConfig()
    full = dict(GemNet(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu").named_parameters())
    assert sum(p.numel() for p in full.values()) == 2_158_470
    expected = {2: 1_149_574, 4: 645_126}[n_stages]
    for s in range(n_stages):
        stage = PipelineStage(cfg, s, n_stages, generator=torch.Generator().manual_seed(3),
                              device="cpu")
        params = dict(stage.named_parameters())
        assert sum(p.numel() for p in params.values()) == expected
        assert sum(p.numel() for _, p in stage.named_parts()[0]) == 140_678
        assert all(p.device.type == "cpu" for p in params.values())
        for name, p in params.items():
            assert torch.equal(p, full[name]), name
        with pytest.raises(TypeError, match="make_pp_apply"):
            stage({})


# ---------------------------------------------------------------- the ranks

def _shift_case(rank, group):
    """The shift of a (fp32, bf16) pair through two losses: its output, the
    gradient of sum(c * y^2) and the gradient of sum(d * g^2) (the double
    backward), each on this rank."""
    from gemnet_pytorch_tpu_torch.parallel.collectives import shift

    gen = torch.Generator().manual_seed(100 + rank)
    xs = [torch.randn(5, 3, generator=gen).requires_grad_(True),
          torch.randn(4, generator=gen).to(torch.bfloat16).requires_grad_(True)]
    c = [torch.randn(5, 3, generator=gen), torch.randn(4, generator=gen).to(torch.bfloat16)]
    d = [torch.randn(5, 3, generator=gen), torch.randn(4, generator=gen).to(torch.bfloat16)]
    ys = shift(tuple(xs), group)
    loss = sum(torch.sum(ci * y.float() ** 2) for ci, y in zip(c, ys))
    gs = torch.autograd.grad(loss, xs, create_graph=True)
    loss2 = sum(torch.sum(di * g.float() ** 2) for di, g in zip(d, gs))
    g2 = torch.autograd.grad(loss2, xs)
    return dict(x=[x.detach().float() for x in xs], c=c, d=d,
                y=[y.detach().float() for y in ys], g=[g.detach().float() for g in gs],
                g2=[g.float() for g in g2])


def _pp_rank(rank, world, directory, group):
    """Every case of the payload on this rank of a pp group."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import collectives, pp
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    out = {"shift": _shift_case(rank, group)}

    def stage_of(case):
        cfg = ModelConfig(**case["cfg"])
        stage = pp.PipelineStage(cfg, rank, world, generator=torch.Generator().manual_seed(0),
                                 device="cpu")
        pre, stages = pp.split_pp_state_dict(case["sd"], cfg.num_blocks, world)
        stage.load_state_dict({**pre, **stages[rank]}, strict=True)
        return stage, [to_torch(b, "cpu") for b in case["shards"]]

    for variant, case in payload["ef"].items():
        stage, batches = stage_of(case)
        with collectives.recorded() as seq:
            E, F = pp.make_pp_energy_and_forces(stage, group)(batches)
        out[("ef", variant)] = (E.detach().numpy(), F.detach().numpy(), seq)
    if "grad" in payload:
        stage, batches = stage_of(payload["grad"])
        with collectives.recorded() as seq:
            loss, grads = pp.make_pp_loss_and_grad(stage, group, _loss)(batches)
        out["grad"] = (float(loss), {k: g.numpy().copy() for k, g in grads.items()}, seq)
    if "train" in payload:
        case = payload["train"]
        stage, _ = stage_of(case)
        trainer = Trainer(stage, TrainConfig(**TRAIN))
        ppt = pp.PPTrainer(trainer, group, TRAIN_MICRO)
        state = ppt.init_state()
        losses = []
        with collectives.recorded() as seq:
            for _ in range(TRAIN_STEPS):
                state, loss = ppt.train_on_microbatches(state, case["shards"], 1.0)
                losses.append(float(loss))
        out["train"] = (losses, ppt.merged_state_dict(state),
                        ppt.merged_state_dict(state, ema=True), seq)
    return out


def _loss(E, F, b):
    return jax_loss(E, F, b)


def _payload(references, world: int):
    nb = EF_BLOCKS[world]
    out = {"ef": {v: dict(cfg=dataclasses.asdict(port_cfg(jax_cfg(v, nb))), sd=r["sd"],
                          shards=r["shards"])
                  for (v, b), r in references["ef"].items() if b == nb}}
    train = world == 2
    if train:
        cfg = dataclasses.asdict(port_cfg(jax_cfg("Q")))
        for key in ("grad", "train"):
            r = references[key]
            out[key] = dict(cfg=cfg, sd=r["sd"], shards=r["shards"])
    return out


@pytest.fixture(scope="module")
def pp2(references, tmp_path_factory):
    return spawn(_pp_rank, 2, tmp_path_factory.mktemp("pp2"),
                 payload=_payload(references, 2))


@pytest.fixture(scope="module")
def pp4(references, tmp_path_factory):
    return spawn(_pp_rank, 4, tmp_path_factory.mktemp("pp4"),
                 payload=_payload(references, 4))


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def pp_runs(request):
    return request.param, request.getfixturevalue(f"pp{request.param}")


def test_shift_matches_one_process_emulation(pp_runs):
    """Rank s receives rank s-1's tensors and rank 0 zeros (bf16 bit for
    bit through gloo's bytes); the gradient on rank s of sum_r sum(c_r *
    y_r^2) is 2 c_{s+1} x_s (zero on the last rank), and the double
    backward's that of the sum of every rank's sum(d * g^2): both equal to
    autograd on the one-process emulation of the shift."""
    world, results = pp_runs
    xs = [[r["shift"]["x"][i].clone().requires_grad_(True) for r in results] for i in range(2)]
    ys = [[torch.zeros_like(col[0])] + col[:-1] for col in xs]
    loss = sum(torch.sum(results[r]["shift"]["c"][i].float() * ys[i][r] ** 2)
               for i in range(2) for r in range(world))
    flat = [x for col in xs for x in col]
    # the last rank's tensors go nowhere: their gradients are zeros
    gs = torch.autograd.grad(loss, flat, create_graph=True, allow_unused=True,
                             materialize_grads=True)
    loss2 = sum(torch.sum(results[r]["shift"]["d"][i].float() * gs[i * world + r] ** 2)
                for i in range(2) for r in range(world))
    g2 = torch.autograd.grad(loss2, flat, allow_unused=True, materialize_grads=True)
    for i in range(2):
        for r, res in enumerate(results):
            torch.testing.assert_close(res["shift"]["y"][i], ys[i][r].detach(), rtol=0, atol=0)
            tol = dict(rtol=1e-6, atol=1e-6) if i == 0 else dict(rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(res["shift"]["g"][i], gs[i * world + r].detach(), **tol)
            torch.testing.assert_close(res["shift"]["g2"][i], g2[i * world + r], **tol)
    assert torch.equal(results[0]["shift"]["y"][0], torch.zeros(5, 3))
    assert torch.equal(results[-1]["shift"]["g"][0], torch.zeros(5, 3))


def _ef_gates(E, F, ref, variant, num_blocks):
    """E and F against the port's single-device model at tests/test_pp.py:
    49-67's gates (rtol 2e-5, atol 2e-6: the pipeline computes what its
    monolithic model computes), and against JAX's single-device model at
    tests/test_torch_model.py's parity gates (E 2e-4; F 2e-4 direct, 5e-4
    -dE/dR: two fp32 programs, which differ by up to 0.6 of the first gate
    at 2 blocks and 2.3 times it at 4). At 4 blocks the -dE/dR F of a
    pipeline is held to the parity gate: the psum of the ranks' partial
    dE/dR sums in another order than one backward, and JAX's own pipeline
    (`make_pp_energy_and_forces`, 2 stages of 2 blocks) misses the first
    gate by 1.5 times on these microbatches (the port's, 4 stages: 5 times)."""
    direct = VARIANTS[variant]["direct_forces"]
    f_mono = (2e-5, 2e-6) if direct or num_blocks == 2 else (5e-4, 5e-4)
    for got, mono, (rtol, atol) in zip((E, F), ref["port"], ((2e-5, 2e-6), f_mono)):
        np.testing.assert_allclose(got, mono, rtol=rtol, atol=atol)
    for got, jax_ref, tol in zip((E, F), ref["ef"], (2e-4, 2e-4 if direct else 5e-4)):
        np.testing.assert_allclose(got, jax_ref, rtol=tol, atol=tol)


def port_single_device(ref, jcfg):
    """The port's single-device (E, F) of each microbatch of `ref`."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import GemNet, energy_and_forces

    model = GemNet(port_cfg(jcfg), generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(ref["sd"], strict=True)
    out = [energy_and_forces(model, to_torch(b, "cpu")) for b in ref["shards"]]
    return tuple(np.stack([o[i].detach().numpy() for o in out]) for i in range(2))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pp_one_stage_matches_jax_single_device(references, variant):
    """S = 1, no group (the pipeline's program with an empty shift): E and F
    of each microbatch against the single-device models (`_ef_gates`)."""
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.parallel import PipelineStage, make_pp_energy_and_forces

    ref = references["ef"][variant, EF_BLOCKS[1]]
    stage = PipelineStage(port_cfg(jax_cfg(variant, EF_BLOCKS[1])), 0, 1,
                          generator=torch.Generator().manual_seed(0), device="cpu")
    stage.load_state_dict(ref["sd"], strict=True)
    E, F = make_pp_energy_and_forces(stage, None)([to_torch(b, "cpu") for b in ref["shards"]])
    _ef_gates(E.detach().numpy(), F.detach().numpy(), ref, variant, EF_BLOCKS[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pp_matches_jax_single_device(pp_runs, references, variant):
    """S = 2 (2 blocks, 1 a stage) and 4 (4 blocks, 1 a stage): E and F on
    every rank against the single-device models per microbatch
    (`_ef_gates`), the same bits on every rank; every rank's collectives one
    sequence: T = M + S - 1 shifts of the carried state, 2 psums of the
    outputs, and for -dE/dR the backward's T - 1 reverse shifts (the first
    tick shifts the zero state, which carries no gradient), the psum's
    backward and the psum of dE/dR."""
    world, results = pp_runs
    ref = references["ef"][variant, EF_BLOCKS[world]]
    E0, F0, seq0 = results[0][("ef", variant)]
    for res in results:
        E, F, seq = res[("ef", variant)]
        _ef_gates(E, F, ref, variant, EF_BLOCKS[world])
        np.testing.assert_array_equal(E, E0)
        np.testing.assert_array_equal(F, F0)
        assert seq == seq0
    ticks = EF_MICRO + world - 1
    kinds = [k for k, _, _ in seq0]
    direct = VARIANTS[variant]["direct_forces"]
    assert kinds.count("shift") == (ticks if direct else 2 * ticks - 1)
    assert kinds.count("all_reduce") == (2 if direct else 4)


def test_pp_gradients_match_jax_single_device(pp2, references):
    """The force loss of tests/test_pp.py:70-118 (GemNet-Q, -dE/dR, 4
    microbatches, 2 stages): the loss (rtol 1e-5) and each parameter's
    gradient (rtol 2e-3, atol 1e-4) against JAX's single-device gradient
    summed over the microbatches; the preamble's gradient the same on both
    ranks, each stage's held by its rank alone; the ranks' collectives one
    sequence."""
    ref = references["grad"]
    merged = {}
    for r, res in enumerate(pp2):
        loss, grads, seq = res["grad"]
        np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
        assert seq == pp2[0]["grad"][2]
        for name, g in grads.items():
            if name in merged:  # the preamble's: all-reduced, equal on every rank
                np.testing.assert_array_equal(g, merged[name], err_msg=name)
            merged[name] = g
    assert sorted(merged) == sorted(k for k in ref["grad"] if not k.endswith("scale_factor"))
    for name, g in merged.items():
        np.testing.assert_allclose(g, ref["grad"][name].numpy(), rtol=2e-3, atol=1e-4,
                                   err_msg=name)


def test_pptrainer_matches_jax_single_device_step(pp2, references):
    """3 PPTrainer steps at S = 2 (flat AdamW/Adam over the preamble and
    stage vectors, the global-norm clip across both, EMA) against JAX's
    single-device flat step on the concatenated loss of the same 3
    microbatches (tests/test_pp.py:121-200's gates: losses rtol 1e-5,
    parameters and EMA rtol 2e-3 atol 2e-6), the merged state the same on
    both ranks."""
    ref = references["train"]
    losses, params, ema, seq = pp2[0]["train"]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for got, want in ((params, ref["params"]), (ema, ref["ema"])):
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=2e-3,
                                       atol=2e-6, err_msg=name)
    losses1, params1, ema1, seq1 = pp2[1]["train"]
    assert losses1 == losses and seq1 == seq
    for name in params:
        assert torch.equal(params1[name], params[name]) and torch.equal(ema1[name], ema[name])


# ---------------------------------------------------------------- the driver

def _driver_rank(rank, world, directory, group):
    """`python -m gemnet_pytorch_tpu_torch.train --pp 2 --pp-micro 4` on this
    rank, as torchrun starts it, 4 steps and then a restart to 6 with the
    export, with its restore log lines and what each returned. Rank 1
    starts from the smallest PadDims and grows them on its own batches."""
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
    argv = ["--config", path, "--device", "cpu", "--pp", str(world), "--pp-micro", "4",
            "--synthetic-molecules", str(payload["molecules"])]
    os.environ["MASTER_PORT"] = str(payload["ports"][0])
    first = train.main(argv + ["--num-steps", "4"])
    os.environ["MASTER_PORT"] = str(payload["ports"][1])
    second = train.main(argv + ["--num-steps", "6", "--export-torch",
                                os.path.join(directory, "export.pth")])
    restores = [r.args for r in records if r.msg == "restored checkpoint at step %d"]
    agreed = sum(r.msg == "pad dims agreed across ranks: %s" for r in records)
    return dict(first=first, second=second, restores=restores, agreed=agreed)


def test_main_pp_checkpoints_on_rank0_and_resumes(tmp_path):
    """`--pp 2 --pp-micro 4` from the command line on 2 ranks (GemNet-Q at
    the driver tests' small widths, one block a stage, 4 steps, eval and
    checkpoints every 2; then a restart to 6 with `--export-torch`): the
    same finite best metrics on both ranks (the eval of the merged EMA
    weights, rank 0's metrics broadcast), rank 0 alone wrote the log, the
    checkpoint (both stages' rows) and the best model, both ranks resumed
    at step 4, and the export is the whole model. Rank 1 pads from other
    PadDims than rank 0 and grows them on its own; the ranks agree on them
    before each step."""
    from test_torch_parallel_driver import _free_ports
    from test_torch_train_driver import RUN, RUN_MOLECULES

    from gemnet_pytorch_tpu_torch.compat import strip_reference_aliases
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    config = dict(RUN, batch_size=4)
    results = spawn(_driver_rank, 2, tmp_path,
                    payload=dict(config=config, molecules=RUN_MOLECULES, ports=_free_ports(2)))
    run_dir = tmp_path / "run"
    for key in ("first", "second"):
        assert results[0][key] == results[1][key]
        assert all(np.isfinite(v) for v in results[0][key].values())
    assert [r["restores"] for r in results] == [[(4,)], [(4,)]]
    assert results[1]["agreed"] > 0
    for rel in ("logs/checkpoint", "logs/checkpoint.plateau.npz", "best/model",
                "best/best_metrics.npz", "logs_p1", "best_p1/best_metrics.npz"):
        assert (run_dir / rel).exists(), rel
    assert not (run_dir / "best_p1" / "model").exists()
    ckpt = torch.load(run_dir / "logs" / "checkpoint", weights_only=True)
    assert int(ckpt["step"]) == 6 and ckpt["params.stage"].shape[0] == 2
    assert ckpt["opt_state.stage.count"].tolist() == [6, 6]
    model = GemNet(ModelConfig.from_dict(config), generator=torch.Generator().manual_seed(0),
                   device="cpu")
    exported = strip_reference_aliases(torch.load(tmp_path / "export.pth", weights_only=True))
    model.load_state_dict(exported, strict=True)
    best = torch.load(run_dir / "best" / "model", weights_only=True)
    assert sorted(best) == sorted(model.state_dict())
