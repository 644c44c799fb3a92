"""Data-parallel training on periodic systems (traffic `oc20slab32x4`, for
a four-chip cell of `gemnet-dt-oc20` that BENCHMARK.json does not list
yet: PERF.md, Open questions): the program's
--dp path (`train.DPBatches`, `parallel/dp.py`'s step, captured on NCCL
with the gradient's all-reduce inside the graph) over `mix["ranks"]`
processes, one a chip, each rank on `train_pbc.py`'s slabs at a batch of
`mix["batch"]`: a global batch of ranks x batch structures a step, drawn as
every process draws them alike, each rank building only its own shard.

Rank 0 runs in the command's process and keeps the record; ranks 1.. are
spawned after rank 0 has built the container (so a program without the
periodic container fails before any rank starts) and the kernels (so the
ranks load them). A rank that fails ends every rank at once: rank 0 watches
the others and exits non-zero, the others leave when rank 0's process is
gone, and the process group's collectives time out after `TIMEOUT`. Each
rank takes an equal share of the host's cores for its torch threads.

Set-up on every rank builds its trainer and drives its first
`CHECKED_STEPS` steps; rank 0 times the window and the ranks stop together
(a flag all-reduced on a gloo group each step). The record's rate counts
the global structures, its peak is the largest rank's, its spans, counters
and trace are rank 0's; a note gives each rank's set-up phases. The check
follows rank 0's first steps against OCP's step over each whole global
batch in the plain reference (`check_pbc.py`).
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch

from .. import check, check_pbc, workload_slab
from ..reference import graph_pbc
from . import Record, build_kernels, free, halves, peak, setup_s, traced
from .train import CHECKED_STEPS, TRACED_STEPS, _leaf_norms, provider_seed, selections
from .train_pbc import container, program

# every collective's bound, and rank 0's wait for the others to exit
TIMEOUT = datetime.timedelta(seconds=120)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cfg, mix, seed, seconds, trace, device, t_process) -> Record:
    import multiprocessing as mp

    pool = workload_slab.pool(mix)
    data = container(cfg, pool)
    build_s = build_kernels(device)
    ranks, port = mix["ranks"], _free_port()
    ctx = mp.get_context("spawn")
    t_spawn = time.time()
    children = [ctx.Process(target=_child, args=(r, ranks, port, cfg, mix, seed, seconds, trace,
                                                 device.type, os.getpid(), t_spawn))
                for r in range(1, ranks)]
    for p in children:
        p.start()
    done = threading.Event()

    def watch():  # a rank that failed ends every rank at once
        while not done.wait(0.2):
            bad = [p.exitcode for p in children if p.exitcode not in (None, 0)]
            if bad:
                print(f"a rank exited {bad[0]}: ending every rank", file=sys.stderr, flush=True)
                for p in children:
                    p.kill()
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    try:
        rec = _rank(0, ranks, port, cfg, mix, seed, seconds, trace, device.type,
                    [("start", t_process), ("spawned", t_spawn)], data, pool)
        for p in children:
            p.join(TIMEOUT.total_seconds())
    finally:
        done.set()
        for p in children:
            if p.is_alive():
                p.kill()
    codes = [p.exitcode for p in children]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks 1-{ranks - 1} exited {codes}")
    rec.build_s = build_s
    return rec


def _child(r, ranks, port, cfg, mix, seed, seconds, trace, device_type, parent, t_spawn):
    phases = [("start", t_spawn), ("imports", time.time())]

    def orphaned():  # rank 0's process is gone: leave
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=orphaned, daemon=True).start()
    try:
        _rank(r, ranks, port, cfg, mix, seed, seconds, trace, device_type, phases)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _rank(r, ranks, port, cfg, mix, seed, seconds, trace, device_type, phases, data=None,
          pool=None):
    """Rank `r`'s part of the run; `phases` [(name, time)], the rank's
    start first. Rank 0 returns the record."""
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch.config import TrainConfig
    from gemnet_pytorch_tpu_torch.data import DataProvider
    from gemnet_pytorch_tpu_torch.parallel import dp, mesh
    from gemnet_pytorch_tpu_torch.train import DPBatches
    from gemnet_pytorch_tpu_torch.training.trainer import Trainer

    from ..tracing import Spans

    def mark(name):  # also printed as it happens: a run cut short shows its phases
        phases.append((name, time.time()))
        print(f"rank {r}: {name} at {phases[-1][1] - phases[0][1]:.1f} s", file=sys.stderr,
              flush=True)

    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or ranks) // ranks))
    device = torch.device("cuda", r) if device_type == "cuda" else torch.device("cpu")
    group = mesh.initialize_distributed(f"localhost:{port}", ranks, r, device=device,
                                        timeout=TIMEOUT)
    ctl = dist.new_group(list(range(ranks)), timeout=TIMEOUT, backend="gloo")
    mark("group")
    try:
        if data is None:
            pool = workload_slab.pool(mix)
            data = container(cfg, pool)
        mark("container")
        bs = mix["batch"]
        provider = DataProvider(data, len(pool["N"]), 0, bs, seed=provider_seed(seed),
                                shuffle=True, random_split=True)
        mark("pad estimate")
        model, sd = program(cfg, seed, device)
        trainer = Trainer(model, TrainConfig.from_dict(cfg))
        state = trainer.init_state()
        mark("model")
        names = [(k, p.numel()) for k, p in model.named_parameters()]
        p0 = np.concatenate([sd[k].detach().double().cpu().numpy().ravel() for k, _ in names])
        batches = DPBatches(trainer, provider, group)
        it = provider.get_dataset("train", prefetch_workers=mix["prefetch_workers"],
                                  raw_transform=batches.prepare, shard=(r, ranks))
        step_fn = dp.make_dp_train_step(trainer, group)
        tracked = list(trainer.tracked_metrics)
        spans = Spans()
        flag = torch.zeros(1, dtype=torch.int64)

        def stop(now: bool) -> bool:  # rank 0's clock decides for every rank
            flag.fill_(int(now))
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ctl)
            return bool(flag.item())

        def step():
            nonlocal state
            with spans("data_wait"):
                row = batches.row(next(it))
            with spans("step_host"):
                state, metrics, _ = step_fn(state, row, 1.0)
            return metrics["loss"]

        # set-up: the first steps, which capture the step; the check follows them
        prog = {"losses": [], "energy_mae": [], "force_mae": []}
        acc = state.metric_acc.double().cpu().numpy().copy()
        for k in range(CHECKED_STEPS):
            prog["losses"].append(float(step()))
            now = state.metric_acc.double().cpu().numpy().copy()
            part = now - acc
            acc = now
            for key in ("energy_mae", "force_mae"):
                i = tracked.index(key)
                prog[key].append(part[i, 0] / part[i, 1] if part[i, 1] > 0 else float("nan"))
            if k == 0:  # the all-reduced gradient as the optimizer took it: mu = (1 - b1) g
                prog["grad0"] = _leaf_norms((state.opt_state.mu / 0.1).double().cpu().numpy(),
                                            names)
        prog["change"] = {k: float((p.detach().double() - sd[k].double()).norm())
                          for k, p in model.named_parameters()}
        prog["ema"] = _leaf_norms(state.ema_params.double().cpu().numpy() - p0, names)
        mark("checked steps")
        t_setup = setup_s(phases[0][1], device)
        mark("set-up")
        version = trainer.packer.version
        spans.times.clear()

        n, loss = 0, torch.zeros(())
        t0 = time.perf_counter()
        while not stop(r == 0 and time.perf_counter() - t0 >= seconds):
            loss = step()
            n += 1
        last = float(loss)  # the value fetch that ends the window
        window_s = time.perf_counter() - t0
        mark("window")
        trace_path = None
        if trace and r == 0:
            trace_path = traced(spans, device, TRACED_STEPS, step)
        elif trace:
            for _ in range(TRACED_STEPS):
                step()
        mark("traced steps")
        stats = {"peak": peak(device), "phases": phases, "steps": n, "version": version,
                 "grown": trainer.packer.version != version, "finite": bool(np.isfinite(last))}
        gathered = [None] * ranks
        dist.all_gather_object(gathered, stats, group=ctl)
        launches = dict(trainer._captured[1].launches) if trainer._captured is not None else {}
        dims = provider.pad_dims
        it.close()
        del trainer, state, model, it
        free(device)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    if r:
        return None
    rec = Record("train", t_setup, window_s, n, n * bs * ranks, max(s["peak"] for s in gathered),
                 spans.copy(), failed=sum(not s["finite"] for s in gathered) * n)
    rec.notes.append(halves(rec.spans, "data_wait", "step_host"))
    rec.notes.append("set-up phases, s from rank 0's start or a rank's spawn: " + "; ".join(
        f"rank {i}: " + ", ".join(f"{name} {t - s['phases'][0][1]:.1f}"
                                  for name, t in s["phases"][1:])
        for i, s in enumerate(gathered)))
    if any(s["grown"] for s in gathered):
        rec.notes.append("the pad dims grew in the window: the step was captured again")
    sels = selections(len(pool["N"]), bs, provider_seed(seed))
    checked = [np.concatenate([next(sels) for _ in range(ranks)]) for _ in range(CHECKED_STEPS)]
    for _ in range(n * ranks):  # the window's batches
        next(sels)
    if trace:
        mine = [[next(sels) for _ in range(ranks)][0] for _ in range(TRACED_STEPS)]
        rec.trace_path = trace_path
        rec.traced_steps = TRACED_STEPS
        rec.traced_counts = [
            {**graph_pbc.counts(check_pbc.graph(cfg, N, R, cell)), "molecules": len(N)}
            for N, _, R, _, _, cell, _ in check_pbc.batches_of(pool, mine)]
    rec.launches = launches
    rec.padded = {"triplets": dims.n_triplets, "quads": dims.n_quads, "edges": dims.n_edges}
    rec.check = {"program": prog, "batches": checked, "pool": pool, "sd": sd}
    return rec


def numbers(cfg, rec, seed, device) -> dict:
    c = rec.check
    t0 = time.perf_counter()
    ref = check_pbc.reference_train(cfg, c["sd"], check_pbc.batches_of(c["pool"], c["batches"]),
                                    device)
    rec.notes.append(f"the reference's steps over the global batches: "
                     f"{time.perf_counter() - t0:.1f} s")
    rec.notes.append("worst leaves, " + check.worst_leaves(c["program"], ref))
    return check.train_gaps(c["program"], ref)
