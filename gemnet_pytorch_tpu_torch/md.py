"""Serving and molecular dynamics (port of `gemnet_pytorch_tpu/md.py`;
reference ase_calculator.py:102-271).

`GemNetCalculator` rebuilds the graph for every geometry and predicts energy
and forces. On the card it is the counterpart of the JAX package's jitted
predict (md.py:52-96): `energy_and_forces` is captured into a CUDA graph
once per padded shape (`CapturedPredict`, `graphs.capture`), over a static
input buffer that each geometry's packed batch (`data.packer.BatchPacker`)
is copied into before a replay. `Molecule.get` keeps 25% headroom in the
padded dims, so a trajectory replays one graph; when the dims grow, the old
graph and its pool are dropped and the predict is captured again. On the
CPU it predicts eagerly. Results come back as numpy.

`MDSimulator` integrates with Velocity Verlet or Langevin dynamics in ASE's
units (eV, Angstrom, amu), from `maxwell_boltzmann_velocities`, into a
`Trajectory`; its loop is the path that replays the captured predict.
`make_ase_calculator` wraps the calculator as an ASE Calculator where `ase`
is installed (imported only there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import graphs
from .data.batch import to_torch
from .data.containers import Molecule
from .data.packer import BatchPacker
from .models.gemnet import GemNet, energy_and_forces

# ASE units: eV, Angstrom, amu; kB in eV/K; fs = 0.09822694788... sqrt(amu A^2/eV)
KB_EV_PER_K = 8.617330337217213e-05
FS = 0.09822694788464063  # 1 femtosecond in sqrt(amu)*A/sqrt(eV) units

# atomic masses (amu), Z = 1..20 (ase.data.atomic_masses values)
ATOMIC_MASSES = np.array([
    0.0, 1.008, 4.002602, 6.94, 9.0121831, 10.81, 12.011, 14.007, 15.999,
    18.998403163, 20.1797, 22.98976928, 24.305, 26.9815385, 28.085,
    30.973761998, 32.06, 35.45, 39.948, 39.0983, 40.078,
])

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


class CapturedPredict:
    """(E, F) of padded numpy batches under `model` on a CUDA device, the
    counterpart of the JAX package's jitted predict (md.py:66-73): each
    batch is packed and copied into a static buffer, and a CUDA graph of
    `energy_and_forces`, captured on the first batch of a padded shape,
    replays on it. When the shapes change (the packer's version), the old
    graph and its pool are dropped and the predict is captured again. A
    call also takes words this packer packed, already on the device. The
    outputs are the graph's, overwritten by the next call."""

    def __init__(self, model: GemNet, device):
        self.model = model
        self.device = torch.device(device)
        self.packer = BatchPacker()
        self.captures = 0
        # (packer version, graphs.Captured, static input buffer)
        self._captured = None

    def __call__(self, batch):
        if isinstance(batch, torch.Tensor):
            def fill(buf):
                buf.copy_(batch)
        else:
            row = self.packer.pack(batch)

            def fill(buf):
                self.packer.to_device(row, self.device, out=buf)
        if self._captured is None or self._captured[0] != self.packer.version:
            self._captured = None  # frees the old graph and its pool
            buf = torch.empty(self.packer.total, dtype=torch.int32, device=self.device)
            fill(buf)
            batch = self.packer.unpack(buf)
            cap = graphs.capture(lambda: energy_and_forces(self.model, batch), self.device)
            self._captured = (self.packer.version, cap, buf)
            self.captures += 1
        else:
            fill(self._captured[2])
        cap = self._captured[1]
        cap.graph.replay()
        return cap.outputs


class GemNetCalculator:
    """Energy (eV) and forces (eV/A) of `molecule` under `model`, on `device`.

    The model's parameters are frozen here (inference builds no graph over
    them); forces come from -dE/dR or the direct head, as the model's
    configuration says. On a CUDA device the predict is captured per padded
    shape (module docstring); a failed capture raises."""

    def __init__(self, molecule: Molecule, model: GemNet, device="cuda",
                 add_atom_energies: bool = False):
        self.molecule = molecule
        self.device = torch.device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.add_atom_energies = add_atom_energies
        self._shape_key = None  # the padded batch's (key, shape) pairs
        self.captured = (CapturedPredict(self.model, self.device)
                         if self.device.type == "cuda" else None)

    def _predict(self, batch_np):
        """(E, F) tensors of a padded numpy batch."""
        if self.captured is not None:
            return self.captured(batch_np)
        return energy_and_forces(self.model, to_torch(batch_np, self.device))

    def calculate(self, R: Optional[np.ndarray] = None) -> tuple[float, np.ndarray]:
        """Returns (energy, forces (nAtoms, 3)) for positions R (or the
        molecule's current ones)."""
        if R is not None:
            self.molecule.update(np.asarray(R, np.float32))
        batch_np = self.molecule.get()
        self._shape_key = tuple(sorted((k, v.shape) for k, v in batch_np.items()))
        E, F = self._predict(batch_np)
        n = len(self.molecule.Z)
        energy = float(E[0, 0])
        forces = F[:n, 0, :].detach().cpu().numpy()
        if self.add_atom_energies:
            energy += float(sum(ATOM_ENERGIES[int(z)] for z in self.molecule.Z))
        return energy, forces


def maxwell_boltzmann_velocities(
    Z: np.ndarray, temperature_K: float, rng: np.random.Generator
) -> np.ndarray:
    """Velocities from the Maxwell-Boltzmann distribution, with the
    center-of-mass motion removed (reference ase_calculator.py:225-233)."""
    masses = ATOMIC_MASSES[Z]
    sigma = np.sqrt(KB_EV_PER_K * temperature_K / masses)[:, None]
    v = rng.normal(size=(len(Z), 3)) * sigma
    p = masses[:, None] * v
    v -= p.sum(axis=0) / masses.sum()  # stationary center of mass
    return v


@dataclass
class Trajectory:
    """In-memory/npz trajectory store (stands in for ase.io.Trajectory)."""

    path: Optional[str] = None
    frames_R: list = field(default_factory=list)
    frames_E: list = field(default_factory=list)
    frames_v: list = field(default_factory=list)

    def write(self, R, E, v):
        self.frames_R.append(np.array(R))
        self.frames_E.append(float(E))
        self.frames_v.append(np.array(v))

    def close(self):
        if self.path:
            np.savez(
                self.path,
                R=np.stack(self.frames_R) if self.frames_R else np.zeros((0, 0, 3)),
                E=np.array(self.frames_E),
                v=np.stack(self.frames_v) if self.frames_v else np.zeros((0, 0, 3)),
            )

    def __len__(self):
        return len(self.frames_R)


class MDSimulator:
    """MD loop: Velocity Verlet or Langevin (reference MDSimulator,
    ase_calculator.py:173-271, as md.py:137-250), in ASE units, on the
    calculator of `model` on `device`."""

    def __init__(
        self,
        molecule: Molecule,
        model: GemNet,
        dynamics: str = "langevin",
        max_steps: int = 100,
        time: float = 0.5,  # fs
        temperature: float = 300.0,  # K
        langevin_friction: float = 0.002,
        interval: int = 10,
        traj_path: Optional[str] = "md_sim.traj.npz",
        vel: Optional[np.ndarray] = None,
        seed: int = 0,
        logfile: Optional[str] = "-",
        device="cuda",
    ):
        self.dynamics = dynamics.lower()
        if self.dynamics not in ("verlet", "langevin"):
            raise ValueError(f"unknown MD integrator {dynamics}")
        self.calc = GemNetCalculator(molecule, model, device=device)
        self.molecule = molecule
        self.max_steps = max_steps
        self.dt = time * FS
        self.temperature = temperature
        self.friction = langevin_friction
        self.interval = interval
        self.rng = np.random.default_rng(seed)
        self.masses = ATOMIC_MASSES[molecule.Z][:, None]
        self.v = (
            np.asarray(vel, np.float64)
            if vel is not None
            else maxwell_boltzmann_velocities(molecule.Z, temperature, self.rng)
        )
        self.traj = Trajectory(traj_path)
        self.logfile = logfile
        logging.info("Selected MD integrator: %s", self.dynamics)

    def _log(self, step, E_pot):
        E_kin = 0.5 * float((self.masses * self.v**2).sum())
        T = 2 * E_kin / (3 * len(self.molecule.Z) * KB_EV_PER_K)
        msg = (
            f"step {step}: Epot={E_pot:.6f} eV Ekin={E_kin:.6f} eV "
            f"Etot={E_pot + E_kin:.6f} eV T={T:.1f} K"
        )
        if self.logfile == "-":
            logging.info(msg)
        elif self.logfile:
            with open(self.logfile, "a") as f:
                f.write(msg + "\n")

    def run(self) -> Trajectory:
        R = np.asarray(self.molecule.R, np.float64)
        E, F = self.calc.calculate(R)
        for step in range(self.max_steps):
            if self.dynamics == "verlet":
                # velocity Verlet (ase.md.verlet semantics)
                self.v += 0.5 * self.dt * F / self.masses
                R = R + self.dt * self.v
                E, F = self.calc.calculate(R)
                self.v += 0.5 * self.dt * F / self.masses
            else:
                # Langevin thermostat (the JAX package's splitting: half a
                # kick with friction and noise, a drift, a new force, half a
                # kick)
                fr = self.friction
                sigma = np.sqrt(2 * self.temperature * KB_EV_PER_K * fr / self.masses)
                xi = self.rng.normal(size=R.shape)
                self.v += (
                    0.5 * self.dt * (F / self.masses - fr * self.v)
                    + 0.5 * np.sqrt(self.dt) * sigma * xi
                )
                R = R + self.dt * self.v
                E, F = self.calc.calculate(R)
                xi = self.rng.normal(size=R.shape)
                self.v += (
                    0.5 * self.dt * (F / self.masses - fr * self.v)
                    + 0.5 * np.sqrt(self.dt) * sigma * xi
                )
            if step % self.interval == 0:
                self.traj.write(R, E, self.v)
                self._log(step, E)
        self.traj.close()
        return self.traj


def make_ase_calculator(molecule: Molecule, model: GemNet, device="cuda",
                        add_atom_energies: bool = False, **kwargs):
    """ASE adapter (only if ase is installed): an ase Calculator whose
    calculate() defers to GemNetCalculator (reference ase_calculator.py:102-170)."""
    try:
        from ase.calculators.calculator import Calculator, all_changes
    except ImportError as e:
        raise ImportError(
            "ase is not installed; use GemNetCalculator / MDSimulator directly"
        ) from e

    inner = GemNetCalculator(molecule, model, device=device, add_atom_energies=add_atom_energies)

    class _GNNCalculator(Calculator):
        implemented_properties = ["energy", "forces"]

        def calculate(self, atoms=None, properties=("energy", "forces"),
                      system_changes=all_changes):
            super().calculate(atoms, properties, system_changes)
            energy, forces = inner.calculate(atoms.positions)
            self.results["energy"] = energy
            self.results["forces"] = forces

    return _GNNCalculator(**kwargs)
