"""The one generator of the benchmark's traffic: it reads a mix's parameters
(`traffic/<name>.json`) and makes its molecules from the run's seed.

Molecules are COLL-like: a self-avoiding random walk of H, C, N, O and F
atoms with jittered 1.5 A bonds, labelled by a smooth Morse-like pair
potential with analytic forces. Both are frozen copies of the port's
synthetic generator as it stood when the benchmark was defined, so that no
later change to the program changes the traffic.

A mix is one of two loops:
- "train": a pool of `pool` molecules of `atoms` = [lo, hi] atoms each (the
  size drawn uniformly), batches of `batch` drawn from it by the program's
  provider;
- "md": one system of `atoms` atoms, the first drawn whose triplet count
  lies in `triplets` = [lo, hi]; Langevin dynamics (`loops.md`).
The molecules come from the mix's own `pool_seed` or `system_seed`, so
every run's seed gets the same work: the run's seed draws the weights, the
order of the batches and the velocities and noise of the dynamics.
"""

from __future__ import annotations

import numpy as np

_ELEMENTS = np.array([1, 6, 7, 8, 9], dtype=np.int32)
_ELEMENT_P = np.array([0.4, 0.35, 0.1, 0.1, 0.05])


def random_molecule(rng: np.random.Generator, n_atoms: int, bond_length: float = 1.5,
                    jitter: float = 0.25):
    """Z and R of a random connected molecule: a self-avoiding walk with jitter."""
    Z = rng.choice(_ELEMENTS, size=n_atoms, p=_ELEMENT_P)
    R = np.zeros((n_atoms, 3), dtype=np.float64)
    for i in range(1, n_atoms):
        for _ in range(100):
            parent = rng.integers(0, i)
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            cand = R[parent] + direction * (bond_length + rng.normal() * jitter)
            if np.all(np.linalg.norm(R[:i] - cand, axis=1) > 0.9):
                R[i] = cand
                break
        else:
            R[i] = R[parent] + direction * 2.0
    return Z, R.astype(np.float32)


def toy_energy_forces(Z: np.ndarray, R: np.ndarray):
    """Energy and analytic forces of a Morse-like pair potential."""
    n = len(Z)
    diff = R[:, None, :] - R[None, :, :]
    d = np.sqrt((diff**2).sum(-1) + np.eye(n))
    w = np.sqrt(np.outer(Z, Z)).astype(np.float64)
    r0, a = 1.5, 1.2
    x = np.exp(-a * (d - r0))
    E = 0.05 * (w * (x**2 - 2 * x) * (1 - np.eye(n))).sum() / 2
    dpair = w * (-2 * a * x**2 + 2 * a * x) * (1 - np.eye(n))
    grad = 0.05 * (dpair[:, :, None] * diff / d[:, :, None]).sum(axis=1)
    return float(E), (-grad).astype(np.float32)


def pool(mix: dict) -> dict[str, np.ndarray]:
    """The training pool of a "train" mix in the npz schema (N, Z, R, E, F)."""
    rng = np.random.default_rng([mix["pool_seed"], 1])
    lo, hi = mix["atoms"]
    N = rng.integers(lo, hi + 1, size=mix["pool"])
    mols = [random_molecule(rng, int(n)) for n in N]
    labels = [toy_energy_forces(Z, R) for Z, R in mols]
    return {
        "N": N.astype(np.int64),
        "Z": np.concatenate([m[0] for m in mols]),
        "R": np.concatenate([m[1] for m in mols]),
        "E": np.array([e for e, _ in labels], dtype=np.float32),
        "F": np.concatenate([f for _, f in labels]),
    }


def md_system(mix: dict, n_triplets) -> tuple[np.ndarray, np.ndarray, int]:
    """(Z, R, draws) of an "md" mix: the first system drawn whose triplet
    count `n_triplets(Z, R)` lies in the mix's band."""
    rng = np.random.default_rng([mix["system_seed"], 2])
    lo, hi = mix["triplets"]
    for draw in range(1, mix.get("max_draws", 1000) + 1):
        Z, R = random_molecule(rng, mix["atoms"])
        if lo <= n_triplets(Z, R) <= hi:
            return Z, R, draw
    raise RuntimeError(f"no system of {mix['atoms']} atoms with {lo}..{hi} triplets in "
                       f"{mix.get('max_draws', 1000)} draws")
