"""Efficient bilinear basis contraction (port of
`gemnet_pytorch_tpu/ops/bilinear.py`; reference efficient.py:40-57,120-189).

The neighbour sum  sum_k[s, e, m] = sum_t sph[t, s] * m[t, m]  runs as the
segment-outer-sum kernel K1 (ops/segment_outer.py), exact or in the split3
mode (K4) as `precision` says, or its plain version as `implementation`
says; two plain products finish the contraction.
"""

from __future__ import annotations

import torch

from .segment_outer import segment_outer_sum


def down_projection(rbf_env, weight):
    """Per-order radial down-projection: (nEdges, S, R) x (S, R, I) -> (nEdges, I, S)."""
    return torch.einsum("esr,sri->eis", rbf_env, weight)


def _neighbour_sum(rbf_W1, sph_rows, m, id_reduce, plan, mask, precision, implementation):
    """sum_k (S, nEdges, M) in rbf_W1's dtype."""
    if mask is not None:
        # outside the kernel: the VJP gives padded rows a non-zero db, and
        # only this mask zeroes it upstream
        m = m * mask.to(m.dtype)[:, None]
    sum_k = segment_outer_sum(sph_rows.contiguous(), m.contiguous(), id_reduce, plan,
                              precision, implementation)
    # finish in the compute dtype (bilinear.py:62-70): bf16 in bf16 mode
    return sum_k.to(rbf_W1.dtype)


def bilinear(rbf_W1, sph_rows, m, id_reduce, plan, weight, mask=None, precision="exact",
             implementation="auto"):
    """Bilinear contraction + neighbour summation.

    rbf_W1: (nEdges, I, S) down-projected radial basis
    sph_rows: (nRows, S) per-row spherical values (sorted by id_reduce)
    m: (nRows, emb) grouped neighbour messages (sorted by id_reduce)
    plan: the SegmentPlan of id_reduce (data/batch.py)
    weight: (emb, I, out); returns (nEdges, out)
    precision: "exact" or "split3" (fp32 streams only), for K1 and the
      K2/K1 of its backwards
    implementation: "auto", "pallas" or "xla", the kernels or their plain
      versions (`ops._cuda.use_kernel`)
    """
    sum_k = _neighbour_sum(rbf_W1, sph_rows, m, id_reduce, plan, mask, precision,
                           implementation)
    rbf_w1_sum_k = torch.einsum("eis,sem->eim", rbf_W1, sum_k)  # (E, I, M)
    return torch.einsum("eim,mio->eo", rbf_w1_sum_k, weight)


def hadamard(rbf_W1, sph_rows, m, id_reduce, plan, weight, mask=None, precision="exact",
             implementation="auto"):
    """Efficient hadamard + summation (JAX `ops/bilinear.py:73-99`, the
    reference's EfficientInteractionHadamard, efficient.py:60-117, which the
    released models do not use). weight (emb, 1, I):
    out[e, m] = sum_i weight[m, 0, i] * sum_s rbf_W1[e, i, s] * sum_k[s, e, m];
    the other arguments as `bilinear`'s."""
    sum_k = _neighbour_sum(rbf_W1, sph_rows, m, id_reduce, plan, mask, precision,
                           implementation)
    inner = torch.einsum("eis,sem->eim", rbf_W1, sum_k)
    return torch.einsum("eim,mi->em", inner, weight[:, 0, :])
