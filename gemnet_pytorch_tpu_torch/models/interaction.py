"""Interaction blocks: one message-passing round over the index hierarchy.

Port of `gemnet_pytorch_tpu/models/interaction.py` (reference
interaction_block.py), single-device path. Merge scalings (1/sqrt(3) with
quadruplets, 1/sqrt(2) without; reference interaction_block.py:202-203,
390-391) and every skip's 1/sqrt(2) match the reference. The expand gathers
carry their sort metadata, so their VJPs run as the sorted segment sum K3.
`dtype` is every layer's compute dtype (None: fp32; torch.bfloat16 in the
bf16 mode), passed through as `gemnet_pytorch_tpu/models/interaction.py`
does; `precision` is the bilinears' kernel mode ("split3" when
matmul_precision="high", else "exact") and `implementation`
(bilinear_implementation) picks the kernels or their plain versions for the
bilinears and the expand gathers' VJPs, as the JAX blocks thread it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.expand_gather import expand_gather
from .layers import (
    AtomUpdateBlock,
    Dense,
    EdgeEmbedding,
    EfficientInteractionBilinear,
    ResidualLayer,
    ScalingFactor,
    scale,
)

_INV_SQRT2 = 2.0**-0.5
_INV_SQRT3 = 3.0**-0.5


class QuadrupletInteraction(nn.Module):
    """Quadruplet-based message passing (reference interaction_block.py:425-566)."""

    def __init__(self, emb_size_edge, emb_size_quad, emb_size_bilinear, emb_size_rbf,
                 emb_size_cbf, emb_size_sbf, activation=None, scale_prefix="QuadInteraction_1",
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact", implementation: str = "auto"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.dense_db = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        self.mlp_rbf = Dense(emb_size_rbf, emb_size_edge, **kw)
        self.scale_rbf = ScalingFactor(scale_prefix + "_had_rbf")
        self.mlp_cbf = Dense(emb_size_cbf, emb_size_quad, **kw)
        self.scale_cbf = ScalingFactor(scale_prefix + "_had_cbf")
        self.implementation = implementation
        self.mlp_sbf = EfficientInteractionBilinear(
            emb_size_quad, emb_size_sbf, emb_size_bilinear, precision=precision,
            implementation=implementation, **kw)
        self.scale_sbf_sum = ScalingFactor(scale_prefix + "_sum_sbf")
        self.down_projection = Dense(emb_size_edge, emb_size_quad, activation, **kw)
        self.up_projection_ca = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)
        self.up_projection_ac = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)

    def forward(self, m, rbf, cbf, sbf, ind, masks):
        x_db = self.dense_db(m)
        x_db = self.scale_rbf(x_db * self.mlp_rbf(rbf), x_db, masks["edge"], masks["edge"])
        x_db = self.down_projection(x_db)

        # circular basis hadamard on the intermediate d->b space
        x_db = expand_gather(x_db, ind["id4_expand_intm_db"], *ind["intm_db_sort"],
                             implementation=self.implementation)
        x_db = self.scale_cbf(x_db * self.mlp_cbf(cbf), x_db, masks["intm_db"], masks["intm_db"])

        # spherical basis bilinear over quadruplets -> edges
        x_db = expand_gather(x_db, ind["id4_expand_abd"], *ind["quad_abd_sort"],
                             implementation=self.implementation)
        rbf_W1, sph_rows = sbf
        x = self.mlp_sbf(rbf_W1, sph_rows, x_db, ind["id4_reduce_ca"],
                         ind["id4_reduce_ca_plan"], mask=masks["quad"])
        x = self.scale_sbf_sum(x, x_db, masks["quad"], masks["edge"])

        x_ca = self.up_projection_ca(x)
        x_ac = self.up_projection_ac(x)[ind["id_swap"]]
        return scale(x_ca + x_ac, _INV_SQRT2)


class TripletInteraction(nn.Module):
    """Triplet-based message passing (reference interaction_block.py:569-696)."""

    def __init__(self, emb_size_edge, emb_size_trip, emb_size_bilinear, emb_size_rbf,
                 emb_size_cbf, activation=None, scale_prefix="TripInteraction_1",
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact", implementation: str = "auto"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.dense_ba = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        self.mlp_rbf = Dense(emb_size_rbf, emb_size_edge, **kw)
        self.scale_rbf = ScalingFactor(scale_prefix + "_had_rbf")
        self.implementation = implementation
        self.mlp_cbf = EfficientInteractionBilinear(
            emb_size_trip, emb_size_cbf, emb_size_bilinear, precision=precision,
            implementation=implementation, **kw)
        self.scale_cbf_sum = ScalingFactor(scale_prefix + "_sum_cbf")
        self.down_projection = Dense(emb_size_edge, emb_size_trip, activation, **kw)
        self.up_projection_ca = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)
        self.up_projection_ac = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)

    def forward(self, m, rbf3, cbf3, ind, masks):
        x_ba = self.dense_ba(m)
        x_ba = self.scale_rbf(x_ba * self.mlp_rbf(rbf3), x_ba, masks["edge"], masks["edge"])
        x_ba = self.down_projection(x_ba)

        x_ba = expand_gather(x_ba, ind["id3_expand_ba"], *ind["trip_ba_sort"],
                             implementation=self.implementation)
        rbf_W1, sph_rows = cbf3
        x = self.mlp_cbf(rbf_W1, sph_rows, x_ba, ind["id3_reduce_ca"],
                         ind["id3_reduce_ca_plan"], mask=masks["trip"])
        x = self.scale_cbf_sum(x, x_ba, masks["trip"], masks["edge"])

        x_ca = self.up_projection_ca(x)
        x_ac = self.up_projection_ac(x)[ind["id_swap"]]
        return scale(x_ca + x_ac, _INV_SQRT2)


class InteractionBlock(nn.Module):
    """Full interaction block; the quadruplet path is optional (reference
    InteractionBlock and InteractionBlockTripletsOnly, interaction_block.py:11-422)."""

    def __init__(self, emb_size_atom, emb_size_edge, emb_size_trip, emb_size_quad,
                 emb_size_rbf, emb_size_cbf, emb_size_sbf, emb_size_bil_trip,
                 emb_size_bil_quad, num_before_skip, num_after_skip, num_concat, num_atom,
                 triplets_only: bool, block_nr: int = 1, activation: Optional[str] = None,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact", implementation: str = "auto"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.triplets_only = triplets_only
        self.dense_ca = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        if not triplets_only:
            self.quad_interaction = QuadrupletInteraction(
                emb_size_edge, emb_size_quad, emb_size_bil_quad, emb_size_rbf, emb_size_cbf,
                emb_size_sbf, activation, f"QuadInteraction_{block_nr}", precision=precision,
                implementation=implementation, **kw)
        self.trip_interaction = TripletInteraction(
            emb_size_edge, emb_size_trip, emb_size_bil_trip, emb_size_rbf, emb_size_cbf,
            activation, f"TripInteraction_{block_nr}", precision=precision,
            implementation=implementation, **kw)
        self.layers_before_skip = nn.ModuleList(
            [ResidualLayer(emb_size_edge, activation, **kw) for _ in range(num_before_skip)])
        self.layers_after_skip = nn.ModuleList(
            [ResidualLayer(emb_size_edge, activation, **kw) for _ in range(num_after_skip)])
        self.atom_update = AtomUpdateBlock(
            emb_size_atom, emb_size_edge, emb_size_rbf, num_atom, activation,
            f"AtomUpdate_{block_nr}_sum", **kw)
        self.concat_layer = EdgeEmbedding(
            2 * emb_size_atom + emb_size_edge, emb_size_edge, activation, **kw)
        self.residual_m = nn.ModuleList(
            [ResidualLayer(emb_size_edge, activation, **kw) for _ in range(num_concat)])

    def forward(self, h, m, basis, ind, masks):
        x_ca_skip = self.dense_ca(m)
        x3 = self.trip_interaction(m, basis["rbf3"], basis["cbf3"], ind, masks)
        if self.triplets_only:
            x = scale(x_ca_skip + x3, _INV_SQRT2)
        else:
            x4 = self.quad_interaction(m, basis["rbf4"], basis["cbf4"], basis["sbf4"], ind, masks)
            x = scale(x_ca_skip + x3 + x4, _INV_SQRT3)

        for layer in self.layers_before_skip:
            x = layer(x)
        m = scale(m + x, _INV_SQRT2)
        for layer in self.layers_after_skip:
            m = layer(m)

        h2 = self.atom_update(h, m, basis["rbf_h"], ind["id_a"], masks["edge"], masks["atom"])
        h = scale(h + h2, _INV_SQRT2)

        m2 = self.concat_layer(h, m, ind["id_c"], ind["id_a"])
        for layer in self.residual_m:
            m2 = layer(m2)
        m = scale(m + m2, _INV_SQRT2)
        return h, m
