"""Training through the program's provider and captured train step, as its
`train.run` drives them: `Trainer.train_on_batch` on the packed rows of
`DataProvider.get_dataset("train", transform=trainer.packer.pack)`.

Set-up builds one trainer and drives its first `CHECKED_STEPS` steps
through the window's own call and feed; that same trainer then runs the
window. The check follows those first steps (`numbers`).
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from .. import check, workload
from ..reference import graph as ref_graph
from . import Record, build_kernels, free, halves, peak, program, setup_s, traced

# steps of a traced run that run under the profiler, after the window
TRACED_STEPS = 8
# training steps of set-up that the check follows
CHECKED_STEPS = 3


def selections(n_pool, batch, seed):
    """The molecule ids of the provider's train batches, in order, as the
    published data provider draws them: the whole pool is the train split,
    randomly permuted from the seed, and each epoch a permutation of it
    drawn from the seed, cut into batches."""
    idx = np.random.RandomState(seed).permutation(np.arange(n_pool))
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(idx)
        for i in range(0, len(order), batch):
            yield order[i:i + batch]


def provider_seed(seed: int) -> int:
    return seed % 2**32


def run(cfg, mix, seed, seconds, trace, device, t_process) -> Record:
    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider
    from gemnet_pytorch_tpu_torch.training.trainer import Trainer

    from ..tracing import Spans

    build_s = build_kernels(device)
    spans = Spans()
    pool = workload.pool(mix)
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "pool.npz")
    np.savez(path, **pool)
    container = DataContainer(path, cfg["cutoff"], cfg["int_cutoff"], cfg["triplets_only"])
    os.remove(path)
    os.rmdir(tmp)
    bs = mix["batch"]
    provider = DataProvider(container, len(pool["N"]), 0, bs, seed=provider_seed(seed),
                            shuffle=True, random_split=True)
    model, sd = program(cfg, seed, device)
    trainer = Trainer(model, TrainConfig.from_dict(cfg))
    state = trainer.init_state()
    names = [(k, p.numel()) for k, p in model.named_parameters()]
    p0 = np.concatenate([sd[k].detach().double().cpu().numpy().ravel() for k, _ in names])
    it = provider.get_dataset("train", transform=trainer.packer.pack)
    sels = selections(len(pool["N"]), bs, provider_seed(seed))
    tracked = list(trainer.tracked_metrics)

    # set-up: the first steps, through the window's call and feed, which
    # capture the step; the check follows them
    prog = {"losses": [], "energy_mae": [], "force_mae": []}
    acc = state.metric_acc.double().cpu().numpy().copy()
    for k in range(CHECKED_STEPS):
        state, loss = trainer.train_on_batch(state, next(it), 1.0)
        prog["losses"].append(float(loss))
        # the step's own metrics, as it accumulated them on the device
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
        rec.traced_counts = [_counts(cfg, b) for b in check.batches_of(pool, steps)]
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
    ref = check.reference_train(cfg, c["sd"], check.batches_of(c["pool"], c["batches"]), device)
    rec.notes.append("worst leaves, " + check.worst_leaves(c["program"], ref))
    return check.train_gaps(c["program"], ref)


def _leaf_norms(flat, names):
    out, off = {}, 0
    for k, n in names:
        out[k] = float(np.linalg.norm(flat[off:off + n]))
        off += n
    return out


def _counts(cfg, batch):
    N, Z, R, _, _ = batch
    g = ref_graph.build(R, N, cfg["cutoff"], cfg["int_cutoff"], cfg["triplets_only"])
    return {**ref_graph.counts(g), "molecules": len(N)}
