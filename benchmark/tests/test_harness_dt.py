"""The `gemnet-dt-oc20` configuration's pieces of the benchmark: the slab
generator, the direct-force FLOP count against FlopCounterMode over the
GemNet-dT reference, the faults its check catches (a run at small
widths on the CPU, its look for a chip skipped, comes out not correct),
and the data-parallel loop (`loops/train_dp.py`) on four gloo ranks."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops_direct, run, weights_dt, workload_slab
from benchmark.reference import graph_pbc, model_dt
from benchmark.tests import tiny
from gemnet_pytorch_tpu_torch.ops import geometry
from gemnet_pytorch_tpu_torch.training.trainer import Trainer

CELLS = [w["name"] for w in run.manifest()["workloads"]
         if run.cell(w["name"])[3]["loop"] == "train_pbc"]


def test_slab_pool():
    """The mix's pool: the same from the same pool_seed, 28-134 atoms a
    system, OC20's tags, cells periodic with 20 A of vacuum over the slab."""
    mix = run.load_json("traffic", "oc20slab32.json")
    mix = {**mix, "pool": 24}
    a, b = workload_slab.pool(mix), workload_slab.pool(mix)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["N"].min() >= 28 and a["N"].max() <= 134
    assert set(np.unique(a["tags"])) == {0, 1, 2}
    assert a["cell"].shape == (24, 3, 3) and (a["cell"][:, 2, 2] > 20).all()
    assert np.isfinite(a["E"]).all() and np.isfinite(a["F"]).all()


def test_flops_match_the_flop_counter():
    with open(f"{run.HERE}/configs/gemnet-dt-oc20.json") as f:
        c = json.load(f)
    c.update(emb_size_atom=12, emb_size_edge=10, emb_size_trip=6, emb_size_rbf=4, emb_size_cbf=5,
             emb_size_bil_trip=7, num_blocks=2, num_radial=9, max_neighbors=12, num_atom=2)
    mix = {**run.load_json("traffic", "oc20slab32.json"), "pool": 2, "surface": [2, 2],
           "layers": [2, 2], "adsorbate": [1, 2]}
    pool = workload_slab.pool(mix)
    g = graph_pbc.build(pool["R"], pool["N"], pool["cell"], c["cutoff"], c["max_neighbors"])
    n = graph_pbc.counts(g)
    model = model_dt.GemNetDT(c)
    model.load_state_dict(weights_dt.make(c, 1, "cpu"), strict=True)
    gt = model_dt.to_tensors(g, pool["cell"], "cpu")
    Z, R = torch.as_tensor(pool["Z"], dtype=torch.int64), torch.as_tensor(pool["R"])
    free = torch.as_tensor(pool["tags"] > 0)

    def count(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    def train():
        E, F = model(gt, Z, R, 2)
        loss = model_dt.loss(E, F, torch.zeros_like(E), torch.zeros_like(F), free, c)
        torch.autograd.grad(loss, list(model.parameters()))

    assert count(lambda: model(gt, Z, R, 2)) == flops_direct.step_flops(
        c, n, "forward", neighbour=False)
    assert count(train) == flops_direct.step_flops(c, n, "train", neighbour=False)
    neighbour = sum(ops for kind, ops in flops_direct.products(c, n) if kind == "neighbour")
    assert neighbour == 2 * c["num_blocks"] * n["triplets"] * c["num_spherical"] * c[
        "emb_size_trip"]


def _run(workload):
    torch.set_num_threads(2)
    return run.run(workload, 2**31 + 99, 0.3, False, device="cpu",
                   overrides=tiny.overrides(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_wrong_offset_sign(workload, monkeypatch):
    """The program's edge vectors from the source images on the wrong side:
    the forces and the loss differ from the reference's."""
    inner = geometry.edge_shifts
    monkeypatch.setattr(geometry, "edge_shifts", lambda *a: -inner(*a))
    r = _run(workload)
    assert r["correct"] is False
    assert r["checks"]["force_mae_gap"]["value"] > r["checks"]["force_mae_gap"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_every_atom_in_the_force_loss(workload, monkeypatch):
    """The force loss and metrics over every atom, the fixed ones too."""
    inner = Trainer.loss_metrics_from_outputs

    def every(self, mean_E, var_E, mean_F, var_F, batch, group=None):
        batch = {k: v for k, v in batch.items() if k != "free_mask"}
        return inner(self, mean_E, var_E, mean_F, var_F, batch, group)

    monkeypatch.setattr(Trainer, "loss_metrics_from_outputs", every)
    r = _run(workload)
    assert r["correct"] is False
    assert r["checks"]["first_loss_gap"]["value"] > r["checks"]["first_loss_gap"]["limit"]


def test_data_parallel_loop_on_cpu():
    """`loops/train_dp.py` on four gloo ranks at small widths: rank 0's
    record counts the global structures, its first steps pass
    dt-oc20-train's limits against OCP's step over each whole global
    batch, and a note gives every rank's set-up phases."""
    import time

    from benchmark import check, loops

    _, _, cfg, mix = run.cell("dt-oc20-train")
    over = tiny.overrides("dt-oc20-train")
    cfg = {**cfg, **over["config"]}
    mix = {**run.load_json("traffic", "oc20slab32x4.json"), **over["traffic"]}
    loop = loops.find(mix["loop"])
    rec = loop.run(cfg, mix, 2**31 + 17, 0.5, False, torch.device("cpu"), time.time())
    assert rec.steps >= 1 and rec.units == rec.steps * mix["batch"] * mix["ranks"]
    assert [len(b) for b in rec.check["batches"]] == [mix["batch"] * mix["ranks"]] * 3
    numbers = loop.numbers(cfg, rec, 2**31 + 17, torch.device("cpu"))
    limits = check.limits("dt-oc20-train")
    assert all(numbers[k] <= v for k, v in limits.items()), numbers
    assert any(n.startswith("set-up phases") and "rank 3: imports" in n for n in rec.notes)
