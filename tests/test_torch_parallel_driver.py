"""The port's training driver in its parallel modes on the CPU: `--dp 2`
on the command line (each rank started as torchrun starts it) and
`train.run` with halo=2, on spawned gloo groups of 2 ranks
(tests/test_torch_train_driver.py's small run, GemNet-T: 4 steps, eval
and checkpoints every 2), where only rank 0 writes the log, the checkpoint and
the best model, both ranks keep the same best metrics, and a restart of 6
steps resumes from rank 0's checkpoint on both ranks; under halo, ranks that
hold other HaloPads (one rank's prefetch met an outlier batch first) agree
on them before each step; `train.run` with tp=2: rank 0's checkpoint (the
single device's tree-mode layout of the merged state), a resume, the
export of the merged EMA weights; the mode flags' checks; and what stays
refused (--pp-micro without --pp)."""

import logging
import os

import numpy as np
import pytest
import torch

from test_torch_halo import HALO_TRAIN, _random_graph, load_payload, port_model, spawn
from test_torch_train_driver import RUN, RUN_MOLECULES

torch.set_num_threads(2)

WORLD = 2
# GemNet-T: the quadruplet path's parallel steps are held in
# tests/test_torch_halo.py; here the driver around them
CONFIG = dict(RUN, triplets_only=True)


def _driver_rank(rank, world, directory, group):
    """Two runs of the driver on this rank (4 steps, then a restart to 6),
    with its restore log lines and what each run returned. --dp goes through
    the command line as torchrun would start it (the environment's rank and
    world size, `parallel.initialize_distributed`), on a group of its own;
    --halo through `train.run` on the spawned group."""
    import torch.distributed as dist
    import yaml

    from gemnet_pytorch_tpu_torch import train

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    run_dir = os.path.join(directory, "run")
    config = dict(payload["config"], num_steps=4, restart=run_dir)
    if "dp" in payload["mode"]:
        dist.destroy_process_group()
        os.environ.update(MASTER_ADDR="localhost", RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank))
        path = os.path.join(directory, f"config{rank}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump({k: v for k, v in config.items() if k != "num_steps"}, f)
        argv = ["--config", path, "--device", "cpu", "--dp", str(world),
                "--synthetic-molecules", str(RUN_MOLECULES)]
        os.environ["MASTER_PORT"] = str(payload["ports"][0])
        first = train.main(argv + ["--num-steps", "4"])
        os.environ["MASTER_PORT"] = str(payload["ports"][1])
        second = train.main(argv + ["--num-steps", "6"])
    else:
        if rank == 1:
            # this rank starts from the smallest pads and grows them on its
            # own batches, as a rank whose threads met other batches first:
            # every step must agree on the pads with rank 0's
            from gemnet_pytorch_tpu_torch.parallel import halo

            halo.estimate_halo_pads = lambda *a, **k: halo.HaloPads()
        first = train.run(config, device="cpu", synthetic_molecules=RUN_MOLECULES,
                          group=group, **payload["mode"])
        dist.barrier(group)  # rank 0's final checkpoint is on disk
        second = train.run(dict(config, num_steps=6), device="cpu",
                           synthetic_molecules=RUN_MOLECULES, group=group, **payload["mode"])
    restores = [r.args for r in records if r.msg == "restored checkpoint at step %d"]
    agreed = sum(r.msg == "halo pads agreed across ranks: %s" for r in records)
    return dict(first=first, second=second, restores=restores, agreed=agreed)


def _pads_rank(rank, world, directory, group):
    """`train.HaloBatches` on this rank, fed the payload's batches, the
    third an outlier that outgrows the pads. Rank 1's prefetch races ahead:
    it partitions the outlier first and so holds grown pads for the two
    batches before it, which rank 0 partitions at the old pads. Each rank
    then packs the batches in order and steps on them: the packed widths,
    the losses and the pads after, with the log lines of pads grown and
    agreed."""
    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.parallel import halo
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.msg)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    trainer = Trainer(port_model("Q", payload["sd"]), TrainConfig(**HALO_TRAIN))
    state = trainer.init_state()
    batches = train.HaloBatches(trainer, group, payload["pads"], triplets_only=False)
    raws = payload["raws"]
    order = [2, 0, 1, 3] if rank == 1 else [0, 1, 2, 3]
    items = dict((i, batches.partition(*raws[i])) for i in order)
    step = halo.make_halo_train_step(trainer, group)
    widths, losses = [], []
    for i in range(len(raws)):
        row = batches.row(items[i])
        state, metrics = step(state, row, 1.0)
        widths.append(row.size)
        losses.append(float(metrics["loss"]))
    return dict(widths=widths, losses=losses, pads=batches.pads, log=records)


def test_halo_pads_agree_across_ranks(tmp_path):
    """Two ranks that partitioned the same batches at different pads (one
    rank's threads met the outlier first) agree on the pads before each
    step: the same packed widths and losses on both ranks, the pads grown
    past the estimate on both, and the rank behind rebuilt its partitions
    at the agreed pads. Without the agreement the ranks' all-to-all
    blocks would differ in shape."""
    from gemnet_pytorch_tpu_torch.parallel import halo

    raws = [_random_graph(False, seed, n_mol=n) for seed, n in ((3, 4), (4, 4), (20, 9), (5, 4))]
    pads = halo.estimate_halo_pads(raws[:2], WORLD, headroom=1.0, n_mol=4)
    sd = {k: v.detach().clone() for k, v in port_model("Q").state_dict().items()}
    results = spawn(_pads_rank, WORLD, tmp_path, payload=dict(raws=raws, pads=pads, sd=sd))
    r0, r1 = results
    assert r0["widths"] == r1["widths"] and r0["losses"] == r1["losses"]
    assert all(np.isfinite(r0["losses"]))
    assert r0["pads"] == r1["pads"] and r0["pads"].covers(pads) and r0["pads"] != pads
    assert len(set(r0["widths"])) == 1  # rank 0's first two batches rebuilt at the grown pads
    assert "halo pads agreed across ranks: %s" in r0["log"]
    assert all("halo pads grown: %s" in r["log"] for r in results)


def _free_ports(n: int) -> list[int]:
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


@pytest.mark.parametrize("mode", [dict(dp=WORLD), dict(halo=WORLD)], ids=["dp", "halo"])
def test_run_parallel_checkpoints_on_rank0_and_resumes(tmp_path, mode):
    """Both ranks return the same finite best metrics; rank 0 alone wrote
    logs/, best/ and the checkpoint (rank 1 its sidecars); the restart
    resumed at step 4 on both ranks and rank 0's last checkpoint is at step
    6 with new weights. Under halo, rank 1 starts from other pads than rank
    0 and grows them on its own, and the ranks agree on them before each
    step."""
    results = spawn(_driver_rank, WORLD, tmp_path,
                    payload=dict(config=CONFIG, mode=mode, ports=_free_ports(2)))
    run_dir = tmp_path / "run"
    for key in ("first", "second"):
        assert results[0][key] == results[1][key]
        assert all(np.isfinite(v) for v in results[0][key].values())
    assert [r["restores"] for r in results] == [[(4,)], [(4,)]]
    if "halo" in mode:
        assert results[1]["agreed"] > 0
    for rel in ("logs/checkpoint", "logs/checkpoint.plateau.npz", "best/model",
                "best/best_metrics.npz", "synthetic_train_p0.npz", "synthetic_train_p1.npz",
                "logs_p1", "best_p1/best_metrics.npz"):
        assert (run_dir / rel).exists(), rel
    assert not (run_dir / "logs_p0").exists() and not (run_dir / "best_p1" / "model").exists()
    ckpt = torch.load(run_dir / "logs" / "checkpoint", weights_only=True)
    assert int(ckpt["step"]) == 6 and int(ckpt["opt_state.count"]) == 6


def _dp_rows_rank(rank, world, directory, group):
    """`train.DPBatches` on this rank, fed its own shard of the payload's
    batches, all prepared ahead as the prefetch threads do: rank 1's second
    batch is an outlier that outgrows the dims, which rank 0 cannot see;
    both ranks prepared their third batch at the old dims. Each rank
    then steps on its rows in order: the packed widths, the (global)
    losses, the dims after, and the log lines of dims agreed."""
    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider, make_dataset
    from gemnet_pytorch_tpu_torch.parallel import dp
    from gemnet_pytorch_tpu_torch.training import Trainer

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.msg)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    path = os.path.join(directory, f"molecules{rank}.npz")
    make_dataset(path, n_molecules=8, seed=0)
    provider = DataProvider(DataContainer(path, 5.0, 10.0, True), 8, 0, 4, seed=0,
                            pad_dims=payload["dims"])
    trainer = Trainer(port_model("T", payload["sd"]), TrainConfig(**HALO_TRAIN))
    state = trainer.init_state()
    batches = train.DPBatches(trainer, provider, group)
    items = [batches.prepare(*raw) for raw in payload["raws"][rank]]
    step = dp.make_dp_train_step(trainer, group)
    widths, losses = [], []
    for item in items:
        row = batches.row(item)
        state, metrics, _ = step(state, row, 1.0)
        widths.append(row.size)
        losses.append(float(metrics["loss"]))
    return dict(widths=widths, losses=losses, dims=provider.pad_dims, log=records)


def test_dp_pads_agree_across_ranks(tmp_path):
    """Under --dp each rank builds only its own batch, so an outlier grows
    one rank's dims: the ranks agree on them before each step (the same
    packed widths on both, and losses, which are the global batch's), the
    dims end grown past the estimate on both, both ranks grew them at the
    same step, and packed their later batch again at the agreed dims. Without the agreement the ranks
    would capture their steps at different calls, and their warm-up
    all-reduces would pair with each other's steps."""
    from gemnet_pytorch_tpu_torch.data.padding import PadDims, estimate_pad_dims

    normal = [_random_graph(True, seed, n_mol=4) for seed in (3, 4, 5, 6, 7)]
    outlier = _random_graph(True, 20, n_mol=9)
    raws = [[normal[0], normal[1], normal[2]], [normal[3], outlier, normal[4]]]
    dims = estimate_pad_dims([r[0] for r in normal[:2]], n_mol=4,
                             n_atoms_list=[len(r[1]) for r in normal[:2]], triplets_only=True,
                             headroom=1.0)
    sd = {k: v.detach().clone() for k, v in port_model("T").state_dict().items()}
    r0, r1 = spawn(_dp_rows_rank, WORLD, tmp_path, payload=dict(raws=raws, dims=dims, sd=sd))
    assert r0["widths"] == r1["widths"] and r0["losses"] == r1["losses"]
    assert all(np.isfinite(r0["losses"]))
    assert r0["widths"][0] < r0["widths"][1] == r0["widths"][2]
    assert r0["dims"] == r1["dims"] != dims and isinstance(r0["dims"], PadDims)
    assert r0["log"].count("pad dims agreed across ranks: %s") == 1 == r1["log"].count(
        "pad dims agreed across ranks: %s")


def test_provider_shard(tmp_path):
    """`get_dataset(shard=(rank, ranks))` yields every ranks-th batch of
    what every process draws alike, from `rank` on."""
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider, make_dataset

    path = str(tmp_path / "m.npz")
    make_dataset(path, n_molecules=12, seed=0)
    provider = DataProvider(DataContainer(path, 5.0, 10.0, True), 12, 0, 2, seed=3)
    whole = provider.get_dataset("train", prefetch_workers=0)
    batches = [next(whole)["R"] for _ in range(9)]
    for rank in range(3):
        it = provider.get_dataset("train", prefetch_workers=2, shard=(rank, 3))
        for k in range(3):
            np.testing.assert_array_equal(next(it)["R"], batches[3 * k + rank])
        it.close()


def test_run_mode_checks():
    """Two modes at once, a mode without a group (tp's too), a group without
    a mode, and pp_micro without pp raise before anything runs."""
    from gemnet_pytorch_tpu_torch import train

    with pytest.raises(ValueError, match="one of dp / ep / halo / dp_halo"):
        train.run(dict(RUN), device="cpu", dp=2, halo=2)
    with pytest.raises(ValueError, match="one of dp / ep / halo / dp_halo"):
        train.run(dict(RUN), device="cpu", ep=2, dp_halo=(2, 2))
    with pytest.raises(ValueError, match="process group"):
        train.run(dict(RUN), device="cpu", dp=2)
    with pytest.raises(ValueError, match="process group"):
        train.run(dict(RUN), device="cpu", dp_halo=(2, 2))
    with pytest.raises(ValueError, match="without dp, ep, halo, dp_halo, pp or tp"):
        train.run(dict(RUN), device="cpu", group=object())
    with pytest.raises(ValueError, match="one of dp / ep / halo / dp_halo / pp / tp"):
        train.run(dict(RUN), device="cpu", tp=2, dp=2)
    with pytest.raises(ValueError, match="process group"):
        train.run(dict(RUN), device="cpu", tp=2)
    with pytest.raises(ValueError, match="one of dp / ep / halo / dp_halo / pp"):
        train.run(dict(RUN), device="cpu", pp=2, halo=2)
    with pytest.raises(ValueError, match="process group"):
        train.run(dict(RUN), device="cpu", pp=2)
    with pytest.raises(ValueError, match="pp_micro without pp"):
        train.run(dict(RUN), device="cpu", pp_micro=4)


def test_run_refuses_ep_axis_alone(tmp_path):
    """A configuration that asks for the partitioned model itself (ep_axis,
    the rung-2a view `parallel.ep.ep_model` makes) builds a model without a
    process group, whose first step raises: the parallel modes make the
    view (tests/test_torch_ep.py runs --ep)."""
    from gemnet_pytorch_tpu_torch import train

    config = dict(RUN, ep_axis="ep", num_steps=1, restart=str(tmp_path / "run"))
    with pytest.raises(ValueError, match="process group"):
        train.run(config, device="cpu", synthetic_molecules=RUN_MOLECULES)


@pytest.mark.parametrize("argv", [["--ep", "2"], ["--dp-halo", "2", "2"], ["--pp", "2"],
                                  ["--pp-micro", "4"], ["--tp", "2"]],
                         ids=["ep", "dp-halo", "pp", "pp-micro", "tp"])
def test_main_still_refuses(argv, monkeypatch):
    """--pp-micro without --pp raises (it is the microbatch count of --pp).
    --ep, --dp-halo, --pp and --tp are ported: they parse and reach
    `train.run` with the mode and the process group (here stand-ins;
    tests/test_torch_ep.py, tests/test_torch_hybrid.py, tests/test_torch_pp.py
    and `test_run_tp_checkpoints_on_rank0_and_resumes` run them on gloo
    ranks), --tp with the per-tensor optimizer."""
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch import train

    if argv[0] == "--pp-micro":
        with pytest.raises(ValueError, match="--pp-micro .* --pp N"):
            train.main(argv + ["--device", "cpu"])
        return
    group, reached = object(), {}

    def run(config, **kw):
        reached.update(kw, config=config)
        return {"loss_best": 1.0}

    monkeypatch.setattr(train.mesh, "initialize_distributed", lambda *a, **k: group)
    monkeypatch.setattr(train, "run", run)
    monkeypatch.setattr(dist, "barrier", lambda *a, **k: None)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: None)
    assert train.main(argv + ["--device", "cpu"]) == {"loss_best": 1.0}
    assert reached["group"] is group
    if argv[0] == "--tp":
        assert reached["config"]["flat_optimizer"] is False
    assert (reached["ep"], reached["dp_halo"], reached["pp"], reached["tp"]) == {
        "--ep": (2, None, 0, 0), "--dp-halo": (0, (2, 2), 0, 0), "--pp": (0, None, 2, 0),
        "--tp": (0, None, 0, 2)}[argv[0]]
    assert reached["pp_micro"] == 0  # run() takes 4 * pp


def _tp_driver_rank(rank, world, directory, group):
    """`train.run(tp=2)` on this rank: 4 steps, then a restart to 6 with the
    export, with its restore log lines, what each run returned and the rank's
    parameter count."""
    from gemnet_pytorch_tpu_torch import train

    payload = load_payload(directory)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    root = logging.getLogger()
    root.setLevel(logging.INFO)
    root.addHandler(Keep())
    config = dict(payload["config"], restart=os.path.join(directory, "run"))
    kw = dict(device="cpu", synthetic_molecules=RUN_MOLECULES, group=group, tp=world)
    first = train.run(dict(config, num_steps=4), **kw)
    second = train.run(dict(config, num_steps=6),
                       export_torch=os.path.join(directory, "export.pth"), **kw)
    restores = [r.args for r in records if r.msg == "restored checkpoint at step %d"]
    held = [r.args for r in records if r.msg.startswith("tensor parallel over")]
    return dict(first=first, second=second, restores=restores, held=held)


def test_run_tp_checkpoints_on_rank0_and_resumes(tmp_path):
    """`train.run(tp=2)` on 2 ranks (GemNet-T at the driver tests' widths,
    the per-tensor optimizer, 4 steps with eval and checkpoints every 2,
    then a restart to 6 with the export): the same finite best metrics on
    both ranks (rank 0's eval metrics broadcast), each rank holding its
    slices; rank 0 alone wrote the log, the checkpoint and the best model;
    both ranks resumed at step 4; the checkpoint is the single device's
    tree-mode checkpoint of the merged state (it restores into a
    single-device Trainer) and the export is its EMA weights."""
    from gemnet_pytorch_tpu_torch.compat import strip_reference_aliases
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import PlateauState, Trainer, restore_checkpoint

    config = dict(CONFIG, flat_optimizer=False)
    results = spawn(_tp_driver_rank, WORLD, tmp_path, payload=dict(config=config))
    run_dir = tmp_path / "run"
    for key in ("first", "second"):
        assert results[0][key] == results[1][key]
        assert all(np.isfinite(v) for v in results[0][key].values())
    assert [r["restores"] for r in results] == [[(4,)], [(4,)]]
    (tp, rank0, mine, whole), = results[0]["held"][:1]
    assert (tp, rank0) == (WORLD, 0) and mine < whole
    assert results[1]["held"][0][1:] == (1, mine, whole)
    for rel in ("logs/checkpoint", "logs/checkpoint.plateau.npz", "best/model",
                "best/best_metrics.npz", "logs_p1", "best_p1/best_metrics.npz"):
        assert (run_dir / rel).exists(), rel
    assert not (run_dir / "best_p1" / "model").exists()
    cfg = ModelConfig.from_dict(config)
    trainer = Trainer(GemNet(cfg, generator=torch.Generator().manual_seed(1), device="cpu"),
                      TrainConfig.from_dict(config))
    state, _ = restore_checkpoint(str(run_dir / "logs" / "checkpoint"), trainer.init_state(),
                                  PlateauState())
    assert int(state.step) == 6 and int(state.opt_state.count) == 6
    exported = strip_reference_aliases(torch.load(tmp_path / "export.pth", weights_only=True))
    with trainer.weights(state, use_ema=True):
        ema = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    assert sorted(exported) == sorted(ema)
    for k in ema:
        if not k.endswith("scale_factor"):
            assert torch.equal(exported[k], ema[k]), k
    best = torch.load(run_dir / "best" / "model", weights_only=True)
    assert sorted(best) == sorted(ema)
