"""Core network layers (port of `gemnet_pytorch_tpu/models/layers.py`).

Module and parameter names follow the reference state-dict schema
(gemnet/model/layers/base_layers.py, embedding_block.py,
atom_update_block.py, efficient.py, scaling.py), without the reference's
`.linear.` and `seq_energy` aliases. Numerics as in the reference:
ScaledSiLU (x1/0.6), 1/sqrt(2) residual scaling, bias-free Dense,
he_orthogonal init.

`dtype` is a layer's compute dtype, as flax's `dtype=` in the JAX package:
None computes in the inputs' dtype (fp32), torch.bfloat16 casts the inputs
and the fp32 master parameters to bf16 per call (compute_dtype="bfloat16").
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bilinear as bil_ops
from ..ops.segment import masked_segment_sum
from .initializers import atom_embedding_, he_orthogonal_


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(c, dtype=dtype))


def scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x * c` with the constant rounded to x's dtype first, as JAX's
    weak-typed Python scalars are: in bf16, 1/0.6 is 1.6640625 and 2**-0.5 is
    0.70703125 (torch would multiply by the fp32 constant). A no-op in fp32."""
    return x * _rounded(c, x.dtype)


def scaled_silu(x):
    """SiLU scaled by 1/0.6 (reference base_layers.py:51-58)."""
    return scale(F.silu(x), 1.0 / 0.6)


def _resolve_activation(activation: Optional[str]):
    if activation is None:
        return None
    if activation.lower() in ("swish", "silu"):
        return scaled_silu
    raise NotImplementedError(f"activation {activation}")


def _cast(x, dtype: Optional[torch.dtype]):
    return x if dtype is None else x.to(dtype)


class Dense(nn.Module):
    """Bias-free linear layer with he_orthogonal init and optional ScaledSiLU
    (reference base_layers.py:5-48). `weight` is (out, in)."""

    def __init__(self, in_features: int, out_features: int, activation: Optional[str] = None,
                 *, generator: torch.Generator, zero_init: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if zero_init:
            nn.init.zeros_(self.weight)
        else:
            he_orthogonal_(self.weight, generator)
        self.act = _resolve_activation(activation)
        self.dtype = dtype

    def forward(self, x):
        x = F.linear(_cast(x, self.dtype), _cast(self.weight, self.dtype))
        return self.act(x) if self.act is not None else x


class ResidualLayer(nn.Module):
    """Two Dense layers + skip, scaled 1/sqrt(2) (reference base_layers.py:61-89)."""

    def __init__(self, units: int, activation: Optional[str] = None, n_layers: int = 2,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense_mlp = nn.Sequential(*[
            Dense(units, units, activation, generator=generator, dtype=dtype)
            for _ in range(n_layers)])

    def forward(self, x):
        return scale(x + self.dense_mlp(x), 2.0**-0.5)


class AtomEmbedding(nn.Module):
    """93-element embedding table, input Z-1 (reference embedding_block.py:7-34)."""

    def __init__(self, emb_size: int, *, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embeddings = nn.Embedding(93, emb_size)
        atom_embedding_(self.embeddings.weight, generator)
        self.dtype = dtype

    def forward(self, Z):
        return _cast(self.embeddings(Z - 1), self.dtype)


class EdgeEmbedding(nn.Module):
    """Dense over [h[id_first] ‖ h[id_second] ‖ m] (reference embedding_block.py:37-75);
    also the interaction block's concat layer."""

    def __init__(self, in_features: int, out_features: int, activation: Optional[str] = None,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = Dense(in_features, out_features, activation, generator=generator,
                           dtype=dtype)

    def forward(self, h, m_rbf, id_first, id_second):
        return self.dense(torch.cat([h[id_first], h[id_second], m_rbf], dim=-1))


def _masked_feature_var(t, mask):
    """(mean over features of the masked unbiased per-feature variance, the
    masked row count), in fp32 (JAX `models/layers.py:140-150`)."""
    t2 = t.reshape(t.shape[0], -1).float()
    if mask is None:
        n = t2.new_tensor(float(t2.shape[0]))
        mean = t2.mean(dim=0)
        var = ((t2 - mean) ** 2).sum(dim=0) / torch.clamp_min(n - 1, 1.0)
    else:
        m = mask.to(t2.dtype)[:, None]
        n = m.sum()
        mean = (t2 * m).sum(dim=0) / torch.clamp_min(n, 1.0)
        var = (((t2 - mean) ** 2) * m).sum(dim=0) / torch.clamp_min(n - 1, 1.0)
    return var.mean(), n


class ScalingFactor(nn.Module):
    """Non-trainable activation-variance scale (reference scaling.py:150-174),
    keyed by its global name for scaling_factors.json.

    `stats` is None, and the layer is one multiply, except inside
    `scaling.collect_stats`: there each call also appends the statistics of
    its reference input `x_ref` and its scaled output, [var_in·n, var_out·n,
    n] with n the output's masked row count (JAX `models/layers.py:115-161`,
    the `scale_stats` it sows), which `training.fit_scaling` sums."""

    def __init__(self, scale_name: str):
        super().__init__()
        self.scale_name = scale_name
        self.register_buffer("scale_factor", torch.tensor(1.0))
        self.stats: Optional[list] = None

    def forward(self, y, x_ref=None, mask_ref=None, mask_y=None):
        # the fp32 scale is cast down to y's dtype, never y up (layers.py:134-136)
        y = y * self.scale_factor.to(y.dtype)
        if self.stats is not None:
            with torch.no_grad():
                var_in, _ = _masked_feature_var(x_ref, mask_ref)
                var_out, n_out = _masked_feature_var(y, mask_y)
                # the reference weighs both variances by the output's rows
                # (scaling.py:107-120)
                self.stats.append(torch.stack([var_in * n_out, var_out * n_out, n_out]))
        return y


class EfficientInteractionDownProjection(nn.Module):
    """Per-order radial down-projection weight (S, R, I) (reference efficient.py:5-57)."""

    def __init__(self, num_spherical: int, num_radial: int, emb_size_interm: int,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_spherical, num_radial, emb_size_interm))
        he_orthogonal_(self.weight, generator)
        self.dtype = dtype

    def forward(self, rbf_env):
        """(nEdges, S, R) -> (nEdges, I, S)."""
        return bil_ops.down_projection(_cast(rbf_env, self.dtype), _cast(self.weight, self.dtype))


class EfficientInteractionBilinear(nn.Module):
    """Bilinear contraction + neighbour sum, weight (emb, I, out)
    (reference efficient.py:120-189), on the segment-outer-sum kernel;
    `precision` ("exact" or "split3") is the kernels' mode and
    `implementation` ("auto", "pallas", "xla") chooses the kernels or their
    plain versions."""

    def __init__(self, emb_size: int, emb_size_interm: int, units_out: int,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact", implementation: str = "auto"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(emb_size, emb_size_interm, units_out))
        he_orthogonal_(self.weight, generator)
        self.dtype = dtype
        self.precision = precision
        self.implementation = implementation

    def forward(self, rbf_W1, sph_rows, m, id_reduce, plan, mask=None):
        return bil_ops.bilinear(rbf_W1, sph_rows, m, id_reduce, plan,
                                _cast(self.weight, self.dtype), mask=mask,
                                precision=self.precision, implementation=self.implementation)


def _atom_mlp(emb_size_edge, emb_size_atom, n_hidden, activation, generator, dtype):
    return nn.ModuleList(
        [Dense(emb_size_edge, emb_size_atom, activation, generator=generator, dtype=dtype)]
        + [ResidualLayer(emb_size_atom, activation, generator=generator, dtype=dtype)
           for _ in range(n_hidden)])


class AtomUpdateBlock(nn.Module):
    """Edge->atom aggregation + MLP (reference atom_update_block.py:9-72)."""

    def __init__(self, emb_size_atom: int, emb_size_edge: int, emb_size_rbf: int,
                 n_hidden: int, activation: Optional[str] = None,
                 scale_name: str = "atom_update_sum", *, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense_rbf = Dense(emb_size_rbf, emb_size_edge, generator=generator, dtype=dtype)
        self.scale_sum = ScalingFactor(scale_name)
        self.layers = _atom_mlp(emb_size_edge, emb_size_atom, n_hidden, activation, generator,
                                dtype)

    def forward(self, h, m, rbf, id_target, edge_mask, atom_mask):
        x = m * self.dense_rbf(rbf)
        x = self.scale_sum(masked_segment_sum(x, id_target, h.shape[0], mask=edge_mask), m,
                           edge_mask, atom_mask)
        for layer in self.layers:
            x = layer(x)
        return x


class OutputBlock(nn.Module):
    """Atom update + energy head, and the direct per-edge force head when
    `direct_forces` (reference atom_update_block.py:75-193)."""

    def __init__(self, emb_size_atom: int, emb_size_edge: int, emb_size_rbf: int,
                 n_hidden: int, num_targets: int, activation: Optional[str] = None,
                 direct_forces: bool = True, output_init: str = "HeOrthogonal",
                 scale_prefix: str = "OutBlock_0", *, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if output_init.lower() not in ("heorthogonal", "zeros"):
            raise ValueError(f"Unknown output_init: {output_init}")
        zero = output_init.lower() == "zeros"
        g = generator
        self.direct_forces = direct_forces
        self.num_targets = num_targets
        self.dense_rbf = Dense(emb_size_rbf, emb_size_edge, generator=g, dtype=dtype)
        self.scale_sum = ScalingFactor(scale_prefix + "_sum")
        self.layers = _atom_mlp(emb_size_edge, emb_size_atom, n_hidden, activation, g, dtype)
        # no bias: atoms without edges must predict exactly zero
        self.out_energy = Dense(emb_size_atom, num_targets, generator=g, zero_init=zero,
                                dtype=dtype)
        if direct_forces:
            self.scale_rbf = ScalingFactor(scale_prefix + "_had")
            self.seq_forces = _atom_mlp(emb_size_edge, emb_size_edge, n_hidden, activation, g,
                                        dtype)
            self.out_forces = Dense(emb_size_edge, num_targets, generator=g, zero_init=zero,
                                    dtype=dtype)

    def forward(self, h, m, rbf, id_target, edge_mask, atom_mask):
        x = m * self.dense_rbf(rbf)

        x_E = self.scale_sum(masked_segment_sum(x, id_target, h.shape[0], mask=edge_mask), m,
                             edge_mask, atom_mask)
        for layer in self.layers:
            x_E = layer(x_E)
        x_E = self.out_energy(x_E)

        if self.direct_forces:
            x_F = self.scale_rbf(x, m, edge_mask, edge_mask)
            for layer in self.seq_forces:
                x_F = layer(x_F)
            x_F = self.out_forces(x_F)
        else:
            x_F = x_E.new_zeros((m.shape[0], self.num_targets))
        return x_E, x_F
