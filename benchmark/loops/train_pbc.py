"""Training on periodic systems (OC20-like slabs, `workload_slab.py`)
through the program's provider and captured train step: `train.py`'s loop
with the container's cells, tags and neighbour cap, OCP's GemNet-dT
weights (`weights_dt.py`) and its check (`check_pbc.py`).

Set-up builds one trainer and drives its first `CHECKED_STEPS` steps
through the window's own call and feed; that same trainer then runs the
window. The check follows those first steps (`numbers`), against OCP's
training step in the plain reference.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from .. import check, check_pbc, weights_dt, workload_slab
from ..reference import graph_pbc
from . import Record, build_kernels, free, halves, peak, setup_s, traced
from .train import CHECKED_STEPS, TRACED_STEPS, _leaf_norms, provider_seed, selections


def program(cfg, seed, device):
    """The program's model at the run's weights, and those weights."""
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models.gemnet import GemNet
    sd = weights_dt.make(cfg, seed, device)
    model = GemNet(ModelConfig.from_dict(cfg), generator=torch.Generator().manual_seed(0),
                   device=device)
    model.load_state_dict(sd, strict=True)
    return model, sd


def container(cfg, pool):
    """The program's container of the pool, periodic and capped."""
    from gemnet_pytorch_tpu_torch.data import DataContainer
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "pool.npz")
    np.savez(path, **pool)
    try:
        return DataContainer(path, cfg["cutoff"], cfg["int_cutoff"], cfg["triplets_only"],
                             max_neighbors=cfg["max_neighbors"])
    finally:
        os.remove(path)
        os.rmdir(tmp)


def run(cfg, mix, seed, seconds, trace, device, t_process) -> Record:
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import DataProvider
    from gemnet_pytorch_tpu_torch.training.trainer import Trainer

    from ..tracing import Spans

    pool = workload_slab.pool(mix)
    data = container(cfg, pool)
    build_s = build_kernels(device)
    spans = Spans()
    bs = mix["batch"]
    provider = DataProvider(data, len(pool["N"]), 0, bs, seed=provider_seed(seed),
                            shuffle=True, random_split=True)
    model, sd = program(cfg, seed, device)
    trainer = Trainer(model, TrainConfig.from_dict(cfg))
    state = trainer.init_state()
    names = [(k, p.numel()) for k, p in model.named_parameters()]
    p0 = np.concatenate([sd[k].detach().double().cpu().numpy().ravel() for k, _ in names])
    it = provider.get_dataset("train", prefetch_workers=mix["prefetch_workers"],
                              transform=trainer.packer.pack)
    sels = selections(len(pool["N"]), bs, provider_seed(seed))
    tracked = list(trainer.tracked_metrics)

    # set-up: the first steps, through the window's call and feed, which
    # capture the step; the check follows them
    prog = {"losses": [], "energy_mae": [], "force_mae": []}
    acc = state.metric_acc.double().cpu().numpy().copy()
    for k in range(CHECKED_STEPS):
        state, loss = trainer.train_on_batch(state, next(it), 1.0)
        prog["losses"].append(float(loss))
        now = state.metric_acc.double().cpu().numpy().copy()
        step = now - acc
        acc = now
        for key in ("energy_mae", "force_mae"):
            i = tracked.index(key)
            prog[key].append(step[i, 0] / step[i, 1] if step[i, 1] > 0 else float("nan"))
        if k == 0:  # the gradient as the optimizer took it: mu = (1 - b1) g
            prog["grad0"] = _leaf_norms((state.opt_state.mu / 0.1).double().cpu().numpy(), names)
    prog["change"] = {k: float((p.detach().double() - sd[k].double()).norm())
                      for k, p in model.named_parameters()}
    prog["ema"] = _leaf_norms(state.ema_params.double().cpu().numpy() - p0, names)
    checked = [next(sels) for _ in range(CHECKED_STEPS)]
    t_setup = setup_s(t_process, device)
    version = trainer.packer.version

    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        with spans("data_wait"):
            row = next(it)
        with spans("step_host"):
            state, loss = trainer.train_on_batch(state, row, 1.0)
        n += 1
    last = float(loss)  # the value fetch that ends the window
    window_s = time.perf_counter() - t0
    rec = Record("train", t_setup, window_s, n, n * bs, peak(device), spans.copy(),
                 failed=0 if np.isfinite(last) else n, build_s=build_s)
    rec.notes.append(halves(rec.spans, "data_wait", "step_host"))
    if trainer.packer.version != version:
        rec.notes.append("the pad dims grew in the window: the step was captured again")
    for _ in range(n):  # the window's batches
        next(sels)
    if trace:
        steps = [next(sels) for _ in range(TRACED_STEPS)]

        def step():
            with spans("data_wait"):
                row = next(it)
            with spans("step_host"):
                trainer.train_on_batch(state, row, 1.0)

        rec.trace_path = traced(spans, device, len(steps), step)
        rec.traced_steps = len(steps)
        rec.traced_counts = [
            {**graph_pbc.counts(check_pbc.graph(cfg, N, R, cell)), "molecules": len(N)}
            for N, _, R, _, _, cell, _ in check_pbc.batches_of(pool, steps)]
    if trainer._captured is not None:
        rec.launches = dict(trainer._captured[1].launches)
    dims = provider.pad_dims
    rec.padded = {"triplets": dims.n_triplets, "quads": dims.n_quads, "edges": dims.n_edges}
    rec.check = {"program": prog, "batches": checked, "pool": pool, "sd": sd}
    it.close()
    del trainer, state, model, it
    free(device)
    return rec


def numbers(cfg, rec, seed, device) -> dict:
    c = rec.check
    ref = check_pbc.reference_train(cfg, c["sd"], check_pbc.batches_of(c["pool"], c["batches"]),
                                    device)
    rec.notes.append("worst leaves, " + check.worst_leaves(c["program"], ref))
    return check.train_gaps(c["program"], ref)
