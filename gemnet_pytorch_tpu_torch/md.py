"""Serving: energy/force predictions for one molecule (port of
`gemnet_pytorch_tpu/md.py::GemNetCalculator`; reference ase_calculator.py:102-170).

The calculator rebuilds the graph for every geometry, moves the padded batch
to the model's device and predicts; results come back as numpy. No `ase`
is imported. The MD integrators and the ASE adapter are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .data.batch import to_torch
from .data.containers import Molecule
from .models.gemnet import GemNet, energy_and_forces

# EPBE0 atomic reference energies in eV from QM7-X (reference
# ase_calculator.py:133-141)
ATOM_ENERGIES = {
    1: -13.641404161,
    6: -1027.592489146,
    7: -1484.274819088,
    8: -2039.734879322,
    16: -10828.707468187,
    17: -12516.444619523,
}


class GemNetCalculator:
    """Energy (eV) and forces (eV/A) of `molecule` under `model`, on `device`.

    The model's parameters are frozen here (inference builds no graph over
    them); forces come from -dE/dR or the direct head, as the model's
    configuration says."""

    def __init__(self, molecule: Molecule, model: GemNet, device="cuda",
                 add_atom_energies: bool = False):
        self.molecule = molecule
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.add_atom_energies = add_atom_energies

    def calculate(self, R: Optional[np.ndarray] = None) -> tuple[float, np.ndarray]:
        """Returns (energy, forces (nAtoms, 3)) for positions R (or the
        molecule's current ones)."""
        if R is not None:
            self.molecule.update(np.asarray(R, np.float32))
        batch = to_torch(self.molecule.get(), self.device)
        E, F = energy_and_forces(self.model, batch)
        n = len(self.molecule.Z)
        energy = float(E[0, 0])
        forces = F[:n, 0, :].detach().cpu().numpy()
        if self.add_atom_energies:
            energy += float(sum(ATOM_ENERGIES[int(z)] for z in self.molecule.Z))
        return energy, forces
