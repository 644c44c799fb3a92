"""flops.py counts what FlopCounterMode counts over the plain reference
(its products; the neighbour sums, elementwise products and index sums are
what FlopCounterMode does not see), and the frozen kernel cost is the
port's."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, roofline, weights, workload
from benchmark.reference import graph as ref_graph
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.tests import tiny
from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig

WIDTHS = dict(tiny.CONFIG, emb_size_edge=12, emb_size_quad=6, emb_size_cbf=5, emb_size_sbf=7,
              emb_size_bil_trip=9, emb_size_bil_quad=10)


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("triplets_only", [False, True], ids=["Q", "T"])
def test_flops_match_the_flop_counter(triplets_only):
    c = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    c.update({f.name: f.default for f in dataclasses.fields(TrainConfig)})
    c.update(WIDTHS, triplets_only=triplets_only)
    model = ref_model.GemNet(c)
    model.load_state_dict(weights.make(c, 1, "cpu"), strict=True)
    rng = np.random.default_rng(0)
    mols = [workload.random_molecule(rng, n) for n in (6, 8, 7)]
    N = np.array([6, 8, 7])
    Z = torch.as_tensor(np.concatenate([m[0] for m in mols]), dtype=torch.int64)
    R = torch.as_tensor(np.concatenate([m[1] for m in mols]))
    gn = ref_graph.build(R.numpy(), N, c["cutoff"], c["int_cutoff"], triplets_only)
    g, n = ref_model.to_tensors(gn, "cpu"), ref_graph.counts(gn)

    def train():
        E, F = model.energy_and_forces(g, Z, R, 3, create_graph=True)
        loss = ref_train.loss(E, F, torch.zeros_like(E), torch.zeros_like(F), c)
        torch.autograd.grad(loss, list(model.parameters()))

    assert _count(lambda: model.energy(g, Z, R, 3)) == flops.step_flops(
        c, n, "forward", neighbour=False)
    assert _count(train) == flops.step_flops(c, n, "train", neighbour=False)
    model.requires_grad_(False)
    assert _count(lambda: model.energy_and_forces(g, Z, R, 3)) == flops.step_flops(
        c, n, "md", neighbour=False)
    neighbour = sum(ops for kind, ops in flops.products(c, n) if kind == "neighbour")
    S = c["num_spherical"]
    assert neighbour == 2 * c["num_blocks"] * (
        n["triplets"] * S * c["emb_size_trip"]
        + (0 if triplets_only else n["quads"] * S * S * c["emb_size_quad"]))


# the bench shapes of the port's kernel table: (kernel, dtype, (n, S, M, n_seg))
SHAPES = [("K1", d, s) for d in ("f32", "bf16", "split3")
          for s in ((25600, 7, 64, 3072), (192512, 49, 32, 3072), (2454528, 49, 32, 3456))]
SHAPES += [("K2", d, s) for _, d, s in SHAPES]


@pytest.mark.parametrize("kernel,dtype,shape", SHAPES)
def test_kernel_cost_is_the_ports(kernel, dtype, shape):
    from gemnet_pytorch_tpu_torch.perf import roofline as port
    real = {shape[0]: shape[0] * 9 // 10}
    used = {shape[3]: shape[3] - 100}
    assert roofline.kernel_cost(kernel, dtype, shape) == port.kernel_cost(kernel, dtype, shape)
    assert roofline.kernel_cost(kernel, dtype, shape, real[shape[0]], used[shape[3]]) == \
        port.kernel_cost(kernel, dtype, shape, real, used)
    assert roofline.PEAKS["f32"] == port.H100_DATASHEET["f32"]
    assert roofline.PEAKS["hbm"] == port.H100_DATASHEET["hbm"]
