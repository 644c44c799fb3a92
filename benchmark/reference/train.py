"""The published training step in plain fp32 PyTorch: the loss, its
gradient through the force graph, and the AdamW/Adam update with its EMA.

TUM-DAML gemnet_pytorch, gemnet/training/trainer.py: loss = (1 - rho) *
MAE(E) + rho * {MAE|RMSE}(F), the RMSE being the mean per-atom L2 norm of
the force error; the gradient of the shared basis layers divided by the
number of blocks that share them (mlp_rbf_out by num_blocks + 1); the
gradient clipped to a global norm; AdamW (weight decay on every weight but
the atom embeddings and the Bessel frequencies) and Adam with amsgrad,
eps 1e-7; the learning rate warmed up linearly and decayed exponentially
(gemnet/training/schedules.py), evaluated at the step count before the
update; and an EMA of the weights after it.
"""

from __future__ import annotations

import torch

SHARED = {"mlp_rbf3": "blocks", "mlp_cbf3": "blocks", "mlp_rbf_h": "blocks",
          "mlp_rbf4": "blocks", "mlp_cbf4": "blocks", "mlp_sbf4": "blocks",
          "mlp_rbf_out": "blocks+1"}
B1, B2, EPS = 0.9, 0.999, 1e-7


def loss(E, F, E_t, F_t, c: dict, n_mol=None, n_atoms=None):
    """The training loss of a batch (every molecule and atom real); with
    `n_mol` and `n_atoms` given, the part of the batch's loss that these
    molecules contribute: their sums over the whole batch's counts."""
    n_mol = E.shape[0] if n_mol is None else n_mol
    n_atoms = F.shape[0] if n_atoms is None else n_atoms
    e_mae = torch.sum(torch.abs(E - E_t)) / (n_mol * E.shape[1])
    err = F - F_t
    if c["loss"] == "rmse":
        f = torch.sum(torch.sqrt(torch.clamp_min((err * err).sum(-1), 1e-24))) / n_atoms
    else:
        f = torch.sum(torch.abs(err)) / (3 * n_atoms)
    return (1 - c["rho_force"]) * e_mae + c["rho_force"] * f


def learning_rate(step: int, c: dict) -> float:
    w = max(c["warmup_steps"], 1)
    warm = min(1.0 / w + step / w, 1.0)
    expo = step / c["decay_steps"]
    if c.get("staircase"):
        expo = float(int(expo))
    return c["learning_rate"] * warm * c["decay_rate"] ** expo


class AdamW:
    """The optimizer over a model's named parameters, one tensor each."""

    def __init__(self, model: torch.nn.Module, c: dict):
        self.c = c
        self.params = dict(model.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu_max = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.ema = {k: p.detach().clone() for k, p in self.params.items()}
        self.count = 0
        nb = c["num_blocks"]
        self.divisor = {k: {"blocks": nb, "blocks+1": nb + 1}.get(SHARED.get(k.split(".")[0]), 1)
                        for k in self.params}
        self.decay = {k: 0.0 if ("atom_emb" in k or k.endswith("frequencies")
                                 or k.endswith("bias")) else c["weight_decay"]
                      for k in self.params}

    def gradient(self, raw: dict) -> dict:
        """The gradient as the update takes it: shared layers scaled, the
        whole clipped to the global norm."""
        g = {k: raw[k] * (1.0 / self.divisor[k]) for k in self.params}
        norm = torch.sqrt(sum(torch.sum(v * v) for v in g.values()))
        clip = self.c["grad_clip_max"]
        if float(norm) >= clip:
            g = {k: v * (clip / norm) for k, v in g.items()}
        return g

    @torch.no_grad()
    def step(self, raw: dict) -> dict:
        """One update in place; returns the gradient it took."""
        g = self.gradient(raw)
        lr = learning_rate(self.count, self.c)
        self.count += 1
        t = self.count
        for k, p in self.params.items():
            self.mu[k].mul_(B1).add_((1 - B1) * g[k])
            self.nu[k].mul_(B2).add_((1 - B2) * g[k] * g[k])
            torch.maximum(self.nu_max[k], self.nu[k], out=self.nu_max[k])
            upd = (self.mu[k] / (1 - B1**t)) / (torch.sqrt(self.nu_max[k] / (1 - B2**t)) + EPS)
            p.sub_(lr * (upd + self.decay[k] * p))
            self.ema[k].sub_((1 - self.c["ema_decay"]) * (self.ema[k] - p))
        return g
