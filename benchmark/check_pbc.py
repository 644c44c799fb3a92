"""The comparison that decides the `correct` of a periodic training run
(`loops/train_pbc.py`): the program's first steps against OCP's GemNet-dT
training step in the plain reference (`reference/model_dt.py`), from the
run's weights, on the graphs that `reference/graph_pbc.py` rebuilds from
each batch's Z, R and cells. The numbers compared are `check.train_gaps`'
(the loss of each step, the first step's energy and force MAE, the first
gradient, the parameters' and the EMA's change, leaf by leaf), with the
force MAE over the free atoms, as OCP's loss counts them.

The reference runs system by system, so that a batch at the published
widths fits: each system's part of the loss is its sums over the whole
batch's counts, and the parts' gradients add up to the batch's.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import graph_pbc, model_dt
from .reference import model as ref_model
from .reference import train as ref_train


def batches_of(pool, ids_list):
    """(N, Z, R, E, F, cell, tags) of each batch of system ids."""
    N_cum = np.concatenate([[0], np.cumsum(pool["N"])])
    out = []
    for ids in ids_list:
        atoms = np.concatenate([np.arange(N_cum[i], N_cum[i + 1]) for i in ids])
        out.append((pool["N"][ids], pool["Z"][atoms], pool["R"][atoms], pool["E"][ids],
                    pool["F"][atoms], pool["cell"][ids], pool["tags"][atoms]))
    return out


def graph(cfg, N, R, cell) -> dict:
    return graph_pbc.build(R, N, cell, cfg["cutoff"], cfg.get("max_neighbors"))


def reference_model(cfg, sd, device, tf32=False):
    ref_model.exact_fp32(not tf32)
    model = model_dt.GemNetDT(cfg).to(device)
    model.load_state_dict(sd, strict=True)
    return model


def reference_train(cfg, sd, batches, device, tf32=False) -> dict:
    """`check.reference_train`'s readings of OCP's step over `batches`."""
    model = reference_model(cfg, sd, device, tf32)
    opt = ref_train.AdamW(model, cfg)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    params = list(opt.params.values())
    out = {"losses": [], "energy_mae": [], "force_mae": []}
    for N, Z, R, E, F, cell, tags in batches:
        starts = np.concatenate([[0], np.cumsum(N)])
        n_mol, n_free = len(N), int((tags > 0).sum())
        loss, grads, e_err, f_err = 0.0, None, 0.0, 0.0
        for i in range(n_mol):
            a, b = starts[i], starts[i + 1]
            g = model_dt.to_tensors(graph(cfg, N[i:i + 1], R[a:b], cell[i:i + 1]),
                                    cell[i:i + 1], device)
            Ep, Fp = model(g, torch.as_tensor(Z[a:b], dtype=torch.int64, device=device),
                           torch.as_tensor(R[a:b], device=device), 1)
            E_t = torch.as_tensor(E[i:i + 1], device=device).reshape(1, -1)
            F_t = torch.as_tensor(F[a:b], device=device)
            free = torch.as_tensor(tags[a:b] > 0, device=device)
            part = model_dt.loss(Ep, Fp, E_t, F_t, free, cfg, n_mol, n_free)
            gp = torch.autograd.grad(part, params)
            grads = gp if grads is None else [x + y for x, y in zip(grads, gp)]
            loss += float(part.detach())
            e_err += float(torch.sum(torch.abs(Ep.detach() - E_t)).double())
            f_err += float(torch.sum(torch.abs(Fp.detach() - F_t)[free]).double())
            del g, Ep, Fp, part, gp
        used = opt.step(dict(zip(opt.params, grads)))
        out["losses"].append(loss)
        out["energy_mae"].append(e_err / n_mol)
        out["force_mae"].append(f_err / (3 * n_free))
        if "grad0" not in out:
            out["grad0"] = {k: float(v.double().norm()) for k, v in used.items()}
        del grads, used
    out["change"] = {k: float((p.detach().double() - p0[k].double()).norm())
                     for k, p in model.named_parameters()}
    out["ema"] = {k: float((v.double() - p0[k].double()).norm()) for k, v in opt.ema.items()}
    return out
