"""Radial / circular / spherical Fourier-Bessel basis functions.

Port of `gemnet_pytorch_tpu/models/basis.py` (reference basis_layers.py,
envelope.py, basis_utils.py). The closed forms reduce once, at construction
and with numpy/scipy in float64, to coefficient tables; each forward is a
handful of vectorized ops (Horner evaluations and sin/cos):

- spherical Bessel j_l(x) = sin(x)·P_l(1/x) + cos(x)·Q_l(1/x), with P/Q
  integer-coefficient polynomials from j_{l+1} = (2l+1)/x·j_l − j_{l−1};
- Bessel zeros and normalizers via scipy (basis_utils.py:14-29,47-80);
- associated Legendre / real spherical harmonics via the standard
  recurrences, in the reference's (l, m) order: per degree l,
  m = 0, +1..+l, −l..−1.

The tables live in non-persistent buffers, so they follow the module to its
device and stay out of the state dict (the reference schema has none).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from scipy import special as sp_special
from scipy.optimize import brentq
from torch import nn


@lru_cache(maxsize=None)
def spherical_bessel_sincos_coeffs(n: int) -> tuple[tuple, tuple]:
    """Integer coefficients (a, b) with j_l(x) = sin(x)·Σ_k a[l][k] x^-(k+1)
    + cos(x)·Σ_k b[l][k] x^-(k+1), for l = 0..n-1."""
    a = [[1]]  # j_0 = sin(x)/x
    b = [[0]]
    if n > 1:
        a.append([0, 1])  # j_1 = sin/x^2 - cos/x
        b.append([-1, 0])
    for l in range(2, n):
        # j_l = (2l-1)/x j_{l-1} - j_{l-2}
        fa, fb = [0] + a[l - 1], [0] + b[l - 1]
        fa = [(2 * l - 1) * c for c in fa]
        fb = [(2 * l - 1) * c for c in fb]
        ga = a[l - 2] + [0] * (len(fa) - len(a[l - 2]))
        gb = b[l - 2] + [0] * (len(fb) - len(b[l - 2]))
        a.append([x - y for x, y in zip(fa, ga)])
        b.append([x - y for x, y in zip(fb, gb)])
    return tuple(tuple(r) for r in a), tuple(tuple(r) for r in b)


@lru_cache(maxsize=None)
def bessel_zeros(n: int, k: int) -> np.ndarray:
    """First k zeros of j_l for l = 0..n-1 (reference basis_utils.py:14-29)."""
    zeros = np.zeros((n, k))
    zeros[0] = np.arange(1, k + 1) * np.pi
    points = np.arange(1, k + n) * np.pi
    roots = np.zeros(k + n - 1)
    for l in range(1, n):
        for j in range(k + n - 1 - l):
            roots[j] = brentq(lambda r: sp_special.spherical_jn(l, r), points[j], points[j + 1])
        points = roots.copy()
        zeros[l][:k] = roots[:k]
    return zeros


@lru_cache(maxsize=None)
def bessel_normalizers(n: int, k: int) -> np.ndarray:
    """Normalizers 1/sqrt(0.5·j_{l+1}(z_{l,n})²) (reference basis_utils.py:60-69)."""
    zeros = bessel_zeros(n, k)
    norm = np.zeros((n, k))
    for l in range(n):
        norm[l] = 1.0 / np.sqrt(0.5 * sp_special.spherical_jn(l + 1, zeros[l]) ** 2)
    return norm


def sph_harm_prefactor(l: int, m: int) -> float:
    return math.sqrt(
        (2 * l + 1) / (4 * math.pi) * math.factorial(l - abs(m)) / math.factorial(l + abs(m))
    )


def _horner_inv(coeffs, inv_x):
    """Σ_k coeffs[k]·inv_x^(k+1), Horner-evaluated."""
    acc = torch.zeros_like(inv_x)
    for c in coeffs[::-1]:
        acc = acc * inv_x + float(c)
    return acc * inv_x


class Envelope:
    """Polynomial smooth cutoff 1 + a·d^p + b·d^(p+1) + c·d^(p+2), zero beyond
    d=1 (reference envelope.py:14-29)."""

    def __init__(self, p: int):
        assert p > 0
        self.p = p
        self.a = -(p + 1) * (p + 2) / 2
        self.b = p * (p + 2)
        self.c = -p * (p + 1) / 2

    def __call__(self, d_scaled):
        # same operation order as the reference (separate powers), so fp32
        # rounding matches near the cutoff where env -> 0
        env = (
            1.0
            + self.a * d_scaled**self.p
            + self.b * d_scaled ** (self.p + 1)
            + self.c * d_scaled ** (self.p + 2)
        )
        return torch.where(d_scaled < 1, env, torch.zeros_like(d_scaled))


class RadialBasis(nn.Module):
    """1D Bessel basis with trainable frequencies (reference basis_layers.py:10-49)."""

    def __init__(self, num_radial: int, cutoff: float, envelope_exponent: int = 5):
        super().__init__()
        self.inv_cutoff = 1.0 / cutoff
        self.norm_const = math.sqrt(2.0 * self.inv_cutoff)
        self.envelope = Envelope(envelope_exponent)
        self.frequencies = nn.Parameter(
            torch.from_numpy(np.pi * np.arange(1, num_radial + 1, dtype=np.float32)))

    def forward(self, d):
        """d: (nEdges,) guarded distances -> (nEdges, num_radial)."""
        d = d[:, None]
        d_scaled = d * self.inv_cutoff
        env = self.envelope(d_scaled)
        return env * self.norm_const * torch.sin(self.frequencies[None, :] * d_scaled) / d


class _BesselEnvBase(nn.Module):
    """Shared radial part of the 2D/3D bases: j̃_{ln}(d/c)·envelope·c^-1.5."""

    def __init__(self, num_spherical: int, num_radial: int, cutoff: float, envelope_exponent: int):
        super().__init__()
        assert num_radial <= 64
        self.num_spherical = num_spherical
        self.num_radial = num_radial
        self.inv_cutoff = 1.0 / cutoff
        self.norm_const = self.inv_cutoff**1.5
        self.envelope = Envelope(envelope_exponent)
        self._sin_c, self._cos_c = spherical_bessel_sincos_coeffs(num_spherical)
        zeros = bessel_zeros(num_spherical, num_radial).astype(np.float32)
        norms = bessel_normalizers(num_spherical, num_radial).astype(np.float32)
        self.register_buffer("zeros", torch.from_numpy(zeros), persistent=False)
        self.register_buffer("norms", torch.from_numpy(norms), persistent=False)

    def rbf_env(self, d, mask):
        """Enveloped radial part, (nEdges, num_spherical, num_radial); `mask`
        zeroes padded rows (their guarded d would give a nonzero envelope)."""
        d_scaled = d * self.inv_cutoff
        u = self.envelope(d_scaled) * mask.to(d.dtype)
        outs = []
        for l in range(self.num_spherical):
            arg = d_scaled[:, None] * self.zeros[l][None, :]
            inv = 1.0 / arg
            val = torch.sin(arg) * _horner_inv(self._sin_c[l], inv)
            if any(self._cos_c[l]):
                val = val + torch.cos(arg) * _horner_inv(self._cos_c[l], inv)
            outs.append(val * self.norms[l][None, :])
        rbf = torch.stack(outs, dim=1)
        return rbf * self.norm_const * u[:, None, None]


class CircularBasis(_BesselEnvBase):
    """2D Fourier-Bessel basis j̃_{ln}(d)·Y_l0(angle) (reference basis_layers.py:52-162)."""

    def __init__(self, num_spherical, num_radial, cutoff, envelope_exponent=5):
        super().__init__(num_spherical, num_radial, cutoff, envelope_exponent)
        # Legendre polynomial coefficients P_l(z), z = cos(angle)
        coeffs = [np.array([1.0]), np.array([0.0, 1.0])]
        for l in range(2, num_spherical):
            c = np.zeros(l + 1)
            c[1:] += (2 * l - 1) * coeffs[l - 1] / l
            c[: l - 1] -= (l - 1) * coeffs[l - 2][: l - 1] / l
            coeffs.append(c)
        self._leg = [c * sph_harm_prefactor(l, 0) for l, c in enumerate(coeffs[:num_spherical])]

    def cbf(self, angle):
        """Y_l0(angle): (N,) -> (N, num_spherical)."""
        z = torch.cos(angle)
        outs = []
        for c in self._leg:
            acc = torch.full_like(z, float(c[-1]))
            for coef in c[-2::-1]:
                acc = acc * z + float(coef)
            outs.append(acc)
        return torch.stack(outs, dim=1)


class SphericalBasis(_BesselEnvBase):
    """3D Fourier-Bessel basis j̃_{ln}(d)·Y_lm(α, θ) over all (l, m)
    (reference basis_layers.py:165-295)."""

    def __init__(self, num_spherical, num_radial, cutoff, envelope_exponent=5):
        super().__init__(num_spherical, num_radial, cutoff, envelope_exponent)
        # degree l of each of the S^2 rows (2l+1 orders per degree)
        degree = np.repeat(np.arange(num_spherical), np.arange(num_spherical) * 2 + 1)
        self.register_buffer("degree_of_row", torch.from_numpy(degree), persistent=False)

    def rbf_env3(self, d, mask):
        """(nEdges, num_spherical**2, num_radial): the radial part repeated
        over the orders of each degree (an exact row gather)."""
        return self.rbf_env(d, mask)[:, self.degree_of_row]

    def sbf(self, alpha, theta):
        """Real spherical harmonics Y_lm(alpha, theta): (N,) -> (N, S**2).
        alpha is the polar angle, theta the azimuthal/dihedral angle."""
        S = self.num_spherical
        z = torch.cos(alpha)
        s = torch.sin(alpha)  # = sqrt(1-z^2) for alpha in [0, pi]
        P = {(0, 0): torch.ones_like(z)}
        for m in range(1, S):
            P[(m, m)] = (1 - 2 * m) * s * P[(m - 1, m - 1)]
        for m in range(0, S - 1):
            P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
        for l in range(2, S):
            for m in range(l - 1):
                P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]) / (l - m)
        outs = []
        sqrt2 = math.sqrt(2.0)
        for l in range(S):
            outs.append(sph_harm_prefactor(l, 0) * P[(l, 0)])
            for m in range(1, l + 1):
                outs.append(sqrt2 * (-1) ** m * sph_harm_prefactor(l, m) * P[(l, m)] * torch.cos(m * theta))
            for m in range(l, 0, -1):
                outs.append(sqrt2 * (-1) ** m * sph_harm_prefactor(l, m) * P[(l, m)] * torch.sin(m * theta))
        return torch.stack(outs, dim=1)
