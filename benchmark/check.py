"""The comparison that decides a run's `correct`: what the timed path
produced, against the plain reference at the same inputs. Each loop
(`loops/<name>.py`) says which of these its `numbers` compare.

Training (`loops/train.py`): the reference starts from the run's weights,
rebuilds the graphs of the batches of the program's first steps from the
molecules' Z and R, and takes the same steps. Compared, each by its gap to
the reference as a share of the reference:
- `loss_gap`: each step's loss, the largest gap of the steps;
- `energy_mae_gap`, `force_mae_gap`: the first step's mean absolute error
  of the energies and of the forces against the labels, as the captured
  step accumulated them on the device: E and -dE/dR of the first timed
  batch at the run's weights, each with its own weight (the loss gives E
  a weight of 1 - rho_force = 0.001). The later steps' are left out: from
  random weights the loss falls by half a step, so they mostly weigh the
  two updates' rounding, which `change_gap` and `ema_gap` judge;
- `grad_gap`: the first step's gradient as the optimizer took it, leaf by
  leaf: the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
- `change_gap`: the parameters' change over the steps, leaf by leaf, as
  `grad_gap`; leaves whose reference gradient is under a thousandth of the
  median leaf's (moved by round-off alone) are left out;
- `ema_gap`: the EMA's change over the steps (EMA less the initial
  weights), leaf by leaf, as `change_gap`;
- `first_loss_gap`, `grad_median_gap`, `change_median_gap`,
  `ema_median_gap`: the first step's loss alone, and the median leaf's gap
  in place of the worst's. A cell holds these instead where its worst
  leaves and later steps swing from seed to seed by the batch's rounding
  (q-bulk-train: PERF.md says what was looked at).
A cell's `correct` holds the numbers that its limits file names.
MD (`loops/md.py`): at a sample of the window's steps drawn from the seed,
and its last, the reference's E and -dE/dR at the positions the program
computed:
- `force_gap`: the largest per-atom error |F - F_ref| over the RMS of
  |F_ref| of its step, the worst step;
- `energy_gap`: |E - E_ref| per atom (eV), the worst step.
The limits of each cell are in `limits/<cell>.json`.
"""

from __future__ import annotations

import json
import os
import statistics

import numpy as np
import torch

from .reference import graph as ref_graph
from .reference import model as ref_model
from .reference import train as ref_train

HERE = os.path.dirname(os.path.abspath(__file__))
# sampled MD steps the reference recomputes, besides the last
MD_SAMPLE = 8
# triplet and quadruplet rows the reference differentiates at once: a batch
# of more is taken a group of molecules at a time, the gradients summed
REF_ROWS = 800_000


def limits(workload: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's)."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref
            if keep is None or k in keep}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep).values())


def median_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The median leaf's gap (`leaf_gaps`): steady where one leaf's
    rounding swings from seed to seed."""
    return statistics.median(leaf_gaps(prog, ref, keep).values())


def worst_leaves(prog: dict, ref: dict) -> str:
    """The leaves that set the leaf-wise gaps, for the log."""
    out = []
    for what in ("grad0", "change", "ema"):
        p, r = prog[what], ref[what]
        gaps = leaf_gaps(p, r)
        k = max(gaps, key=gaps.get)
        out.append(f"{what}: {k} {p[k]:.6g} vs {r[k]:.6g}")
    return "; ".join(out)


def reference_model(cfg, sd, device, tf32=False):
    """The reference at the state dict `sd`, in full fp32 or, as the
    control computes, with TF32 products."""
    ref_model.exact_fp32(not tf32)
    model = ref_model.GemNet(cfg).to(device)
    model.load_state_dict(sd, strict=True)
    return model


def reference_train(cfg, sd, batches, device, tf32=False) -> dict:
    """The reference over `batches` [(N, Z, R, E, F)], one step each: each
    step's loss and mean absolute errors of E and F ("losses",
    "energy_mae", "force_mae"), and by leaf the norms of the first gradient
    as the update took it ("grad0") and of the parameters' and the EMA's
    change over the steps ("change", "ema")."""
    model = reference_model(cfg, sd, device, tf32)
    opt = ref_train.AdamW(model, cfg)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    params = list(opt.params.values())
    out = {"losses": [], "energy_mae": [], "force_mae": []}
    for N, Z, R, E, F in batches:
        loss, grads, e_err, f_err = 0.0, None, 0.0, 0.0
        for N_g, Z_g, R_g, E_g, F_g in _groups(cfg, N, Z, R, E, F):
            g = ref_model.to_tensors(ref_graph.build(R_g, N_g, cfg["cutoff"], cfg["int_cutoff"],
                                                     cfg["triplets_only"]), device)
            Zt = torch.as_tensor(Z_g, dtype=torch.int64, device=device)
            Rt = torch.as_tensor(R_g, device=device)
            Ep, Fp = model.energy_and_forces(g, Zt, Rt, len(N_g), create_graph=True)
            E_t = torch.as_tensor(E_g, device=device).reshape(len(N_g), -1)
            F_t = torch.as_tensor(F_g, device=device)
            part = ref_train.loss(Ep, Fp, E_t, F_t, cfg, len(N), len(Z))
            gp = torch.autograd.grad(part, params)
            grads = gp if grads is None else [a + b for a, b in zip(grads, gp)]
            loss += float(part.detach())
            e_err += float(torch.sum(torch.abs(Ep.detach() - E_t)).double())
            f_err += float(torch.sum(torch.abs(Fp.detach() - F_t)).double())
            del g, Ep, Fp, part, gp
        used = opt.step(dict(zip(opt.params, grads)))
        out["losses"].append(loss)
        out["energy_mae"].append(e_err / E.size)
        out["force_mae"].append(f_err / F.size)
        if "grad0" not in out:
            out["grad0"] = {k: float(v.double().norm()) for k, v in used.items()}
        del grads, used
    out["change"] = {k: float((p.detach().double() - p0[k].double()).norm())
                     for k, p in model.named_parameters()}
    out["ema"] = {k: float((v.double() - p0[k].double()).norm()) for k, v in opt.ema.items()}
    return out


def _groups(cfg, N, Z, R, E, F):
    """The batch's molecules in consecutive groups of at most REF_ROWS
    triplet and quadruplet rows (a molecule of more alone)."""
    starts = np.concatenate([[0], np.cumsum(N)])
    rows = []
    for i in range(len(N)):
        n = ref_graph.counts(ref_graph.build(R[starts[i]:starts[i + 1]], N[i:i + 1],
                                             cfg["cutoff"], cfg["int_cutoff"],
                                             cfg["triplets_only"]))
        rows.append(n["triplets"] + n["quads"])
    group, total = [], 0
    for i in range(len(N) + 1):
        if group and (i == len(N) or total + rows[i] > REF_ROWS):
            a, b = starts[group[0]], starts[group[-1] + 1]
            yield N[group[0]:group[-1] + 1], Z[a:b], R[a:b], E[group[0]:group[-1] + 1], F[a:b]
            group, total = [], 0
        if i < len(N):
            group.append(i)
            total += rows[i]


def batches_of(pool, ids_list):
    """(N, Z, R, E, F) of each batch of molecule ids."""
    N_cum = np.concatenate([[0], np.cumsum(pool["N"])])
    out = []
    for ids in ids_list:
        atoms = np.concatenate([np.arange(N_cum[i], N_cum[i + 1]) for i in ids])
        out.append((pool["N"][ids], pool["Z"][atoms], pool["R"][atoms], pool["E"][ids],
                    pool["F"][atoms]))
    return out


def step_gap(prog: list, ref: list) -> float:
    """The largest gap of the steps, each as a share of the reference."""
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref, strict=True))


def train_gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared, from the readings (`reference_train`'s keys)
    of the program and of the reference."""
    med = statistics.median(ref["grad0"].values())
    moved = {k for k, v in ref["grad0"].items() if v >= 1e-3 * med}
    return {
        "loss_gap": step_gap(prog["losses"], ref["losses"]),
        "first_loss_gap": step_gap(prog["losses"][:1], ref["losses"][:1]),
        "energy_mae_gap": step_gap(prog["energy_mae"][:1], ref["energy_mae"][:1]),
        "force_mae_gap": step_gap(prog["force_mae"][:1], ref["force_mae"][:1]),
        "grad_gap": leaf_gap(prog["grad0"], ref["grad0"]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moved),
        "ema_gap": leaf_gap(prog["ema"], ref["ema"], moved),
        "grad_median_gap": median_leaf_gap(prog["grad0"], ref["grad0"]),
        "change_median_gap": median_leaf_gap(prog["change"], ref["change"], moved),
        "ema_median_gap": median_leaf_gap(prog["ema"], ref["ema"], moved),
    }


def md_sample(n_steps: int, seed: int) -> list[int]:
    rng = np.random.default_rng([seed, 4])
    k = min(MD_SAMPLE, max(n_steps - 1, 0))
    return sorted(rng.choice(n_steps - 1, size=k, replace=False).tolist()) + [n_steps - 1]


def reference_md(cfg, sd, Z, positions, device, tf32=False):
    """(E, F) of the reference at each of `positions`."""
    model = reference_model(cfg, sd, device, tf32)
    model.requires_grad_(False)
    Zt = torch.as_tensor(Z, dtype=torch.int64, device=device)
    out = []
    for R in positions:
        g = ref_model.to_tensors(
            ref_graph.build(R, [len(Z)], cfg["cutoff"], cfg["int_cutoff"],
                            cfg["triplets_only"]), device)
        E, F = model.energy_and_forces(g, Zt, torch.as_tensor(R, device=device), 1)
        out.append((float(E[0, 0]), F.cpu().numpy().astype(np.float64)))
    return out


def md_gaps(n_atoms, prog, ref) -> dict:
    """The numbers compared, from [(E, F)] of the program and of the
    reference at the same positions."""
    f_gap = e_gap = 0.0
    for (E_p, F_p), (E_r, F_r) in zip(prog, ref):
        rms = max(np.sqrt(np.mean(np.sum(F_r**2, axis=1))), 1e-12)
        f_gap = max(f_gap, float(np.max(np.linalg.norm(F_p - F_r, axis=1)) / rms))
        e_gap = max(e_gap, abs(E_p - E_r) / n_atoms)
    return {"force_gap": f_gap, "energy_gap": e_gap}


def md_numbers(cfg, check, seed, device) -> dict:
    window = check["window"]
    steps = md_sample(len(window), seed)
    ref = reference_md(cfg, check["sd"], check["Z"], [window[i][0] for i in steps], device)
    return md_gaps(len(check["Z"]), [window[i][1:] for i in steps], ref)
