"""Langevin MD through the program's calculator: `md.GemNetCalculator.calculate`
(the graph rebuilt on the host from the positions, and the captured
predict) at every step, driven by a copy of the port's `MDSimulator`
Langevin splitting, which stops on the clock where `MDSimulator.run`
cannot. The check recomputes E and -dE/dR at positions the window visited
(`check.md_numbers`).
"""

from __future__ import annotations

import time

import numpy as np

from .. import check, weights, workload
from ..reference import graph as ref_graph
from . import Record, build_kernels, free, halves, peak, program, setup_s, traced

# steps of a traced run that run under the profiler, after the window
TRACED_STEPS = 20

# ASE units (eV, A, amu); masses (amu) of Z = 1..9
KB_EV_PER_K = 8.617330337217213e-05
FS = 0.09822694788464063
MASSES = np.array([0.0, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
                   18.998403163])


def run(cfg, mix, seed, seconds, trace, device, t_process) -> Record:
    from gemnet_pytorch_tpu_torch.data.containers import Molecule
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator

    from ..tracing import Spans

    build_s = build_kernels(device)
    spans = Spans()
    cut, icut, trip = cfg["cutoff"], cfg["int_cutoff"], cfg["triplets_only"]

    def n_triplets(Z, R):
        return ref_graph.counts(ref_graph.build(R, [len(Z)], cut, icut, True))["triplets"]

    Z, R0, draws = workload.md_system(mix, n_triplets)
    model, sd = program(cfg, seed, device)
    mol = Molecule(R0, Z, cut, icut, triplets_only=trip)
    calc = GemNetCalculator(mol, model, device=device)
    traj = []  # (R as computed, E, F) of every step

    def calculate(R):
        E, F = calc.calculate(R)
        traj.append((np.asarray(mol.R).copy(), E, F))
        return E, F

    # the energy heads scaled so that the RMS force on the system is the
    # mix's (the first call captures the predict; loading the scaled weights
    # writes them in place, where its replays read them)
    _, F0 = calc.calculate(R0)
    weights.scale_heads(sd, mix["force_rms"] / np.sqrt(np.mean(np.sum(F0**2, axis=1))))
    model.load_state_dict(sd, strict=True)
    E0, F0 = calculate(R0)

    rng = np.random.default_rng([seed, 3])
    masses = MASSES[Z][:, None]
    T, dt, fr = mix["temperature_K"], mix["timestep_fs"] * FS, mix["friction"]
    sigma = np.sqrt(2 * T * KB_EV_PER_K * fr / masses)

    def start():
        """A trajectory from the system at rest, velocities drawn at T."""
        v = rng.normal(size=(len(Z), 3)) * np.sqrt(KB_EV_PER_K * T / masses)
        return R0.astype(np.float64), E0, F0, v - (masses * v).sum(axis=0) / masses.sum()

    R, E, F, v = start()
    steps = 0

    def step():
        """One Langevin step (the port's MDSimulator splitting); every
        `restart_every` steps a new trajectory from the system at rest."""
        nonlocal R, E, F, v, steps
        with spans("md_step"):
            with spans("integrate"):
                if steps and steps % mix["restart_every"] == 0:
                    R, E, F, v = start()
                xi = rng.normal(size=R.shape)
                v += 0.5 * dt * (F / masses - fr * v) + 0.5 * np.sqrt(dt) * sigma * xi
                R = R + dt * v
            with spans("calculate"):
                E, F = calculate(R)
            with spans("integrate"):
                xi = rng.normal(size=R.shape)
                v += 0.5 * dt * (F / masses - fr * v) + 0.5 * np.sqrt(dt) * sigma * xi
        steps += 1

    for _ in range(mix["warmup_steps"]):
        step()
    spans.times.clear()
    t_setup = setup_s(t_process, device)
    captures = calc.captured.captures if calc.captured is not None else 0
    first = len(traj)

    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step()
        n += 1
    window_s = time.perf_counter() - t0  # calculate() fetched E and F
    window = traj[first:]
    bad = sum(not (np.isfinite(e) and np.all(np.isfinite(f))) for _, e, f in window)
    rec = Record("md", t_setup, window_s, n, n, peak(device), spans.copy(), failed=bad,
                 build_s=build_s)
    ends = [ref_graph.counts(ref_graph.build(traj[i][0], [len(Z)], cut, icut, trip))["triplets"]
            for i in (first, -1)]
    fmax = max(float(np.max(np.linalg.norm(f, axis=1))) for _, _, f in window)
    closest = min(float(np.min(np.linalg.norm(r[:, None] - r[None], axis=-1)
                               + 1e9 * np.eye(len(Z)))) for r, _, _ in window)
    rec.notes.append(f"system drawn in {draws} draws; triplets {ends[0]} at the window's "
                     f"first step, {ends[1]} at its last; largest |F| {fmax:.4g} eV/A; "
                     f"closest pair {closest:.4g} A; "
                     f"E {window[0][1]:.6g} -> {window[-1][1]:.6g} eV")
    rec.notes.append(halves(rec.spans, "md_step", "calculate"))
    if calc.captured is not None and calc.captured.captures != captures:
        rec.notes.append("the padded dims grew in the window: the predict was captured again")
    if trace:
        k = len(traj)
        rec.trace_path = traced(spans, device, TRACED_STEPS, step)
        rec.traced_steps = TRACED_STEPS
        rec.traced_counts = [
            {**ref_graph.counts(ref_graph.build(r, [len(Z)], cut, icut, trip)), "molecules": 1}
            for r, _, _ in traj[k:]]
    if calc.captured is not None and calc.captured._captured is not None:
        rec.launches = dict(calc.captured._captured[1].launches)
    dims = mol.dims
    rec.padded = {"triplets": dims.n_triplets, "quads": dims.n_quads, "edges": dims.n_edges}
    rec.check = {"Z": Z, "window": window, "sd": sd}
    del calc, model, mol
    free(device)
    return rec


def numbers(cfg, rec, seed, device) -> dict:
    return check.md_numbers(cfg, rec.check, seed, device)
