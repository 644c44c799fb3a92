"""Synthetic COLL-like molecular data (copy of
`gemnet_pytorch_tpu/data/synthetic.py`): small organic-like molecules in the
reference npz schema (keys N, Z, R, F, E; reference data_container.py:61)."""

from __future__ import annotations

import numpy as np

# H, C, N, O, F — typical organic elements
_ELEMENTS = np.array([1, 6, 7, 8, 9], dtype=np.int32)
_ELEMENT_P = np.array([0.4, 0.35, 0.1, 0.1, 0.05])


def random_molecule(
    rng: np.random.Generator, n_atoms: int, bond_length: float = 1.5, jitter: float = 0.25
) -> tuple[np.ndarray, np.ndarray]:
    """Random connected molecule: self-avoiding random walk + jitter."""
    Z = rng.choice(_ELEMENTS, size=n_atoms, p=_ELEMENT_P)
    R = np.zeros((n_atoms, 3), dtype=np.float64)
    for i in range(1, n_atoms):
        for _ in range(100):
            parent = rng.integers(0, i)
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            cand = R[parent] + direction * (bond_length + rng.normal() * jitter)
            d = np.linalg.norm(R[:i] - cand, axis=1)
            if np.all(d > 0.9):
                R[i] = cand
                break
        else:
            R[i] = R[parent] + direction * 2.0
    return Z, R.astype(np.float32)


def toy_energy_forces(Z: np.ndarray, R: np.ndarray) -> tuple[float, np.ndarray]:
    """Smooth toy pairwise Morse-like potential for labels; analytic forces."""
    n = len(Z)
    diff = R[:, None, :] - R[None, :, :]
    d = np.sqrt((diff**2).sum(-1) + np.eye(n))
    w = np.sqrt(np.outer(Z, Z)).astype(np.float64)
    r0 = 1.5
    a = 1.2
    x = np.exp(-a * (d - r0))
    pair_e = w * (x**2 - 2 * x) * (1 - np.eye(n))
    E = 0.05 * pair_e.sum() / 2
    dpair_dd = w * (-2 * a * x**2 + 2 * a * x) * (1 - np.eye(n))
    grad = 0.05 * (dpair_dd[:, :, None] * diff / d[:, :, None]).sum(axis=1)
    return float(E), (-grad).astype(np.float32)


def make_dataset(
    path: str,
    n_molecules: int = 256,
    min_atoms: int = 4,
    max_atoms: int = 12,
    seed: int = 0,
) -> str:
    """Write a synthetic dataset npz at `path`; returns the path."""
    rng = np.random.default_rng(seed)
    N, Zs, Rs, Es, Fs = [], [], [], [], []
    for _ in range(n_molecules):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        Z, R = random_molecule(rng, n)
        E, F = toy_energy_forces(Z, R)
        N.append(n)
        Zs.append(Z)
        Rs.append(R)
        Es.append(E)
        Fs.append(F)
    np.savez(
        path,
        N=np.array(N, dtype=np.int64),
        Z=np.concatenate(Zs),
        R=np.concatenate(Rs),
        E=np.array(Es, dtype=np.float32),
        F=np.concatenate(Fs),
    )
    return path
