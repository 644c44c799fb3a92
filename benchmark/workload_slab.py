"""The generator of the periodic traffic: OC20-like slabs with adsorbates,
made from a mix's parameters (`traffic/<name>.json`, loop "train_pbc")
and its `pool_seed`, so every run's seed gets the same work.

A system is an fcc(111) slab of lattice constant `lattice` = [lo, hi] A,
a surface supercell of n x m, n and m drawn from `surface` = [lo, hi], and
`layers` = [lo, hi] layers in ABC stacking, of one metal; `vacuum` A of
empty space above it along z, and periodic in all three directions, as
OC20 stores its systems. An adsorbate of `adsorbate` = [lo, hi] atoms of H,
C, N and O sits `height` = [lo, hi] A above a top, bridge or hollow site
of the surface, its further atoms bonded 1.2-1.5 A to the ones before,
above them. Every position is jittered by N(0, `jitter`^2). Tags, as
OC20's: 0 for the slab's atoms below its top two layers, 1 for those two,
2 for the adsorbate; the force loss counts the free atoms (tag > 0).
`atoms` caps a system's atoms: a draw of more takes a smaller adsorbate,
then a smaller surface cell, then fewer layers, down to one of each.

The labels are a smooth Morse pair potential over every periodic pair
within 6 A, tapered by the polynomial envelope, with analytic forces. The
generator, like `workload.py`, imports nothing of the program.
"""

from __future__ import annotations

import itertools

import numpy as np

METALS = np.array([13, 28, 29, 45, 46, 47, 77, 78, 79], dtype=np.int32)
ADSORBATE = np.array([1, 6, 7, 8], dtype=np.int32)
# radii of the pair potential's equilibrium distance r0 = r_i + r_j, A
_RADIUS = {1: 0.35, 6: 0.75, 7: 0.7, 8: 0.65}
METAL_RADIUS = 1.35
LABEL_CUTOFF = 6.0


def _draw(rng, lohi):
    lo, hi = lohi
    return int(rng.integers(lo, hi + 1))


def slab(rng: np.random.Generator, mix: dict):
    """(Z, R, cell, tags) of one system of the mix."""
    a = rng.uniform(*mix["lattice"])
    n, m, L, k = (_draw(rng, mix["surface"]), _draw(rng, mix["surface"]),
                  _draw(rng, mix["layers"]), _draw(rng, mix["adsorbate"]))
    while n * m * L + k > mix["atoms"] and (L, k, n, m) != (1, 1, 1, 1):
        if k > 1:
            k -= 1
        elif max(n, m) > 1:
            n, m = (n - 1, m) if n >= m else (n, m - 1)
        else:
            L -= 1
    metal = rng.choice(METALS)
    d = a / np.sqrt(2.0)  # nearest-neighbour distance on the (111) surface
    a1 = np.array([d, 0.0, 0.0])
    a2 = np.array([0.5 * d, 0.5 * np.sqrt(3.0) * d, 0.0])
    h = a / np.sqrt(3.0)  # (111) layer spacing
    pos, tags = [], []
    for layer in range(L):  # layer L - 1 on top
        shift = (layer % 3) * (a1 + a2) / 3.0
        for i, j in itertools.product(range(n), range(m)):
            pos.append(i * a1 + j * a2 + shift + np.array([0.0, 0.0, layer * h]))
            tags.append(1 if layer >= L - 2 else 0)
    top_z = (L - 1) * h
    top = [p for p in pos if abs(p[2] - top_z) < 1e-9]
    site = top[int(rng.integers(len(top)))] + [np.zeros(3), 0.5 * a1, (a1 + a2) / 3.0][
        int(rng.integers(3))]
    ads = [site + np.array([0.0, 0.0, rng.uniform(*mix["height"])])]
    for _ in range(k - 1):
        for _ in range(100):
            v = rng.normal(size=3)
            v[2] = abs(v[2]) + 0.2
            bond = v / np.linalg.norm(v) * rng.uniform(1.2, 1.5)
            cand = ads[int(rng.integers(len(ads)))] + bond
            if np.all(np.linalg.norm(np.array(ads) - cand, axis=1) > 0.9):
                break
        ads.append(cand)
    Z = np.concatenate([np.full(n * m * L, metal, np.int32), rng.choice(ADSORBATE, size=k)])
    R = np.concatenate([np.array(pos), np.array(ads)])
    R = R + rng.normal(scale=mix["jitter"], size=R.shape)
    height = top_z + mix["vacuum"]
    cell = np.stack([n * a1, m * a2, np.array([0.0, 0.0, height])])
    tags = np.concatenate([np.array(tags, np.int64), np.full(k, 2, np.int64)])
    return Z, R.astype(np.float32), cell.astype(np.float32), tags


def _shells(cell, cutoff):
    C = cell.astype(np.float64)
    vol = abs(np.linalg.det(C))
    return [int(np.ceil(cutoff * np.linalg.norm(np.cross(C[(i + 1) % 3], C[(i + 2) % 3]))
                        / vol)) for i in range(3)]


def labels(Z, R, cell):
    """Energy and forces of the tapered Morse pair potential, periodic."""
    C = cell.astype(np.float64)
    R = R.astype(np.float64)
    r = np.array([_RADIUS.get(int(z), METAL_RADIUS) for z in Z])
    shells = _shells(C, LABEL_CUTOFF)
    offs = np.array(list(itertools.product(*[range(-s, s + 1) for s in shells])))
    shift = offs @ C
    dvec = R[None, :, None, :] - R[:, None, None, :] + shift[None, None, :, :]  # [t, s, o]
    dist = np.linalg.norm(dvec, axis=-1)
    on = (dist > 1e-2) & (dist < LABEL_CUTOFF)
    dd = np.where(on, dist, 1.0)
    r0 = (r[:, None] + r[None, :])[:, :, None]
    alpha, depth, p = 1.5, 0.3, 5
    x = np.exp(-alpha * (dd - r0))
    phi = depth * ((1 - x) ** 2 - 1)
    dphi = depth * 2 * (1 - x) * alpha * x
    u = dd / LABEL_CUTOFF
    env = (1 - (p + 1) * (p + 2) / 2 * u**p + p * (p + 2) * u ** (p + 1)
           - p * (p + 1) / 2 * u ** (p + 2))
    denv = (-(p + 1) * (p + 2) / 2 * p * u ** (p - 1) + p * (p + 2) * (p + 1) * u**p
            - p * (p + 1) / 2 * (p + 2) * u ** (p + 1)) / LABEL_CUTOFF
    E = 0.5 * np.sum(np.where(on, phi * env, 0.0))
    g = np.where(on, dphi * env + phi * denv, 0.0)  # d(phi env)/d dist
    F = np.sum(g[..., None] * dvec / dd[..., None], axis=(1, 2))
    return float(E), F.astype(np.float32)


def pool(mix: dict) -> dict[str, np.ndarray]:
    """The training pool of a slab mix in the npz schema (N, Z, R, E, F,
    cell, tags)."""
    rng = np.random.default_rng([mix["pool_seed"], 3])
    systems = [slab(rng, mix) for _ in range(mix["pool"])]
    lab = [labels(Z, R, cell) for Z, R, cell, _ in systems]
    return {
        "N": np.array([len(s[0]) for s in systems], np.int64),
        "Z": np.concatenate([s[0] for s in systems]),
        "R": np.concatenate([s[1] for s in systems]),
        "E": np.array([e for e, _ in lab], np.float32),
        "F": np.concatenate([f for _, f in lab]),
        "cell": np.stack([s[2] for s in systems]),
        "tags": np.concatenate([s[3] for s in systems]),
    }
