"""Interaction blocks: one message-passing round over the index hierarchy.

Port of `gemnet_pytorch_tpu/models/interaction.py` (reference
interaction_block.py), single-device path. Merge scalings (1/sqrt(3) with
quadruplets, 1/sqrt(2) without; reference interaction_block.py:202-203,
390-391) and every skip's 1/sqrt(2) match the reference. Each gather by an
index column reads that column's sort metadata from `ind["sorts"]`
(`data.batch.gather_sorts`): the expand gathers and the concat layer's
gathers of atom rows to edge rows take the sorted segment sum K3 as their
VJP where the batch carries it, and are plain where it does not; the
reverse edges' rows x[id_swap] take the permutation's own VJP
(`ops.expand_gather.swap_rows`) on every path. `dtype` is every layer's
compute dtype (None: fp32; torch.bfloat16 in the bf16 mode), passed through
as `gemnet_pytorch_tpu/models/interaction.py` does; `precision` is the
bilinears' kernel mode ("split3" when matmul_precision="high", else
"exact").

The halo mode (`parallel/halo.py`; JAX `models/interaction.py:43-100`,
`:236-310`): `ind["halo_group"]` is set and the index columns are a
shard's. Each message-passing path runs in two stages, `prelude` (the dense
layers up to the activations that are the halo payload) and `finish` (the
expand gather, the bilinear, the up-projections); the block issues the edge
exchange after the triplet prelude, then the quadruplet prelude and the
intermediate exchange, then both finishes, in the JAX package's order. The
shard carries no sort metadata (`ind["sorts"]` is empty), so the expand and
concat gathers there are plain gathers: the sort metadata of a global batch
is invalid for a shard's re-sliced rows (JAX `:64-70`, `:86-98`).

Rung 2a (`parallel/ep.py`): `ind["ep_group"]` is set, the row columns are
a shard's chunk with global edge ids, the gathers are plain for the same
reason, and each path psums its bilinear output right after the bilinear,
before `scale_*_sum`, as JAX does (`models/interaction.py:117-120`,
`:192-195`): the factor's statistics (`scaling.collect_stats`) read the
combined output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.expand_gather import gather, swap_rows
from ..parallel.collectives import psum
from ..parallel.halo import halo_extend
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


def _gather(x, ind, column):
    """x[ind[column]], sorted where the batch carries the column's sort
    metadata (`ind["sorts"]`), plain where it does not."""
    return gather(x, ind[column], ind["sorts"].get(column))


class QuadrupletInteraction(nn.Module):
    """Quadruplet-based message passing (reference interaction_block.py:425-566)."""

    def __init__(self, emb_size_edge, emb_size_quad, emb_size_bilinear, emb_size_rbf,
                 emb_size_cbf, emb_size_sbf, activation=None, scale_prefix="QuadInteraction_1",
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.dense_db = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        self.mlp_rbf = Dense(emb_size_rbf, emb_size_edge, **kw)
        self.scale_rbf = ScalingFactor(scale_prefix + "_had_rbf")
        self.mlp_cbf = Dense(emb_size_cbf, emb_size_quad, **kw)
        self.scale_cbf = ScalingFactor(scale_prefix + "_had_cbf")
        self.mlp_sbf = EfficientInteractionBilinear(
            emb_size_quad, emb_size_sbf, emb_size_bilinear, precision=precision, **kw)
        self.scale_sbf_sum = ScalingFactor(scale_prefix + "_sum_sbf")
        self.down_projection = Dense(emb_size_edge, emb_size_quad, activation, **kw)
        self.up_projection_ca = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)
        self.up_projection_ac = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)

    def prelude(self, m, rbf, cbf, ind, masks):
        """Up to the intermediate-db activations (the halo payload)."""
        x_db = self.dense_db(m)
        x_db = self.scale_rbf(x_db * self.mlp_rbf(rbf), x_db, masks["edge"], masks["edge"])
        x_db = self.down_projection(x_db)

        # circular basis hadamard on the intermediate d->b space (halo: the
        # intm_db rows live with their d->b edge, so the gather is local)
        x_db = _gather(x_db, ind, "id4_expand_intm_db")
        return self.scale_cbf(x_db * self.mlp_cbf(cbf), x_db, masks["intm_db"], masks["intm_db"])

    def finish(self, x_db, sbf, ind, masks):
        """From the (halo-extended) intermediate-db activations on."""
        # spherical basis bilinear over quadruplets -> edges
        x_db = _gather(x_db, ind, "id4_expand_abd")
        rbf_W1, sph_rows = sbf
        x = self.mlp_sbf(rbf_W1, sph_rows, x_db, ind["id4_reduce_ca"],
                         ind["id4_reduce_ca_plan"], mask=masks["quad"])
        x = psum(x, ind.get("ep_group"))  # rung 2a: the shards' rows combine
        x = self.scale_sbf_sum(x, x_db, masks["quad"], masks["edge"])

        x_ca = self.up_projection_ca(x)
        x_ac = swap_rows(self.up_projection_ac(x), ind["id_swap"])
        return scale(x_ca + x_ac, _INV_SQRT2)

    def forward(self, m, rbf, cbf, sbf, ind, masks):
        return self.finish(self.prelude(m, rbf, cbf, ind, masks), sbf, ind, masks)


class TripletInteraction(nn.Module):
    """Triplet-based message passing (reference interaction_block.py:569-696)."""

    def __init__(self, emb_size_edge, emb_size_trip, emb_size_bilinear, emb_size_rbf,
                 emb_size_cbf, activation=None, scale_prefix="TripInteraction_1",
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.dense_ba = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        self.mlp_rbf = Dense(emb_size_rbf, emb_size_edge, **kw)
        self.scale_rbf = ScalingFactor(scale_prefix + "_had_rbf")
        self.mlp_cbf = EfficientInteractionBilinear(
            emb_size_trip, emb_size_cbf, emb_size_bilinear, precision=precision, **kw)
        self.scale_cbf_sum = ScalingFactor(scale_prefix + "_sum_cbf")
        self.down_projection = Dense(emb_size_edge, emb_size_trip, activation, **kw)
        self.up_projection_ca = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)
        self.up_projection_ac = Dense(emb_size_bilinear, emb_size_edge, activation, **kw)

    def prelude(self, m, rbf3, masks):
        """Up to the down-projected edge activations (the halo payload)."""
        x_ba = self.dense_ba(m)
        x_ba = self.scale_rbf(x_ba * self.mlp_rbf(rbf3), x_ba, masks["edge"], masks["edge"])
        return self.down_projection(x_ba)

    def finish(self, x_ba, cbf3, ind, masks):
        """From the (halo-extended) edge activations on."""
        x_ba = _gather(x_ba, ind, "id3_expand_ba")
        rbf_W1, sph_rows = cbf3
        x = self.mlp_cbf(rbf_W1, sph_rows, x_ba, ind["id3_reduce_ca"],
                         ind["id3_reduce_ca_plan"], mask=masks["trip"])
        x = psum(x, ind.get("ep_group"))  # rung 2a: the shards' rows combine
        x = self.scale_cbf_sum(x, x_ba, masks["trip"], masks["edge"])

        x_ca = self.up_projection_ca(x)
        x_ac = swap_rows(self.up_projection_ac(x), ind["id_swap"])
        return scale(x_ca + x_ac, _INV_SQRT2)

    def forward(self, m, rbf3, cbf3, ind, masks):
        return self.finish(self.prelude(m, rbf3, masks), cbf3, ind, masks)


class InteractionBlock(nn.Module):
    """Full interaction block; the quadruplet path is optional (reference
    InteractionBlock and InteractionBlockTripletsOnly, interaction_block.py:11-422)."""

    def __init__(self, emb_size_atom, emb_size_edge, emb_size_trip, emb_size_quad,
                 emb_size_rbf, emb_size_cbf, emb_size_sbf, emb_size_bil_trip,
                 emb_size_bil_quad, num_before_skip, num_after_skip, num_concat, num_atom,
                 triplets_only: bool, block_nr: int = 1, activation: Optional[str] = None,
                 *, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                 precision: str = "exact"):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype)
        self.triplets_only = triplets_only
        self.dense_ca = Dense(emb_size_edge, emb_size_edge, activation, **kw)
        if not triplets_only:
            self.quad_interaction = QuadrupletInteraction(
                emb_size_edge, emb_size_quad, emb_size_bil_quad, emb_size_rbf, emb_size_cbf,
                emb_size_sbf, activation, f"QuadInteraction_{block_nr}", precision=precision,
                **kw)
        self.trip_interaction = TripletInteraction(
            emb_size_edge, emb_size_trip, emb_size_bil_trip, emb_size_rbf, emb_size_cbf,
            activation, f"TripInteraction_{block_nr}", precision=precision, **kw)
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
        group = ind.get("halo_group")
        if group is not None:
            # halo: the edge exchange before the quadruplet prelude, the
            # intermediate exchange before the triplet finish (JAX's order)
            x_ba = self.trip_interaction.prelude(m, basis["rbf3"], masks)
            x_ba = halo_extend(x_ba, *ind["edge_send"], group)
            if not self.triplets_only:
                x_db = self.quad_interaction.prelude(m, basis["rbf4"], basis["cbf4"], ind, masks)
                x_db = halo_extend(x_db, *ind["intm_send"], group)
            x3 = self.trip_interaction.finish(x_ba, basis["cbf3"], ind, masks)
            if not self.triplets_only:
                x4 = self.quad_interaction.finish(x_db, basis["sbf4"], ind, masks)
        else:
            x3 = self.trip_interaction(m, basis["rbf3"], basis["cbf3"], ind, masks)
            if not self.triplets_only:
                x4 = self.quad_interaction(m, basis["rbf4"], basis["cbf4"], basis["sbf4"], ind,
                                           masks)
        if self.triplets_only:
            x = scale(x_ca_skip + x3, _INV_SQRT2)
        else:
            x = scale(x_ca_skip + x3 + x4, _INV_SQRT3)

        for layer in self.layers_before_skip:
            x = layer(x)
        m = scale(m + x, _INV_SQRT2)
        for layer in self.layers_after_skip:
            m = layer(m)

        h2 = self.atom_update(h, m, basis["rbf_h"], ind["id_a"], masks["edge"], masks["atom"],
                              psum_group=group)
        h = scale(h + h2, _INV_SQRT2)

        sorts = ind["sorts"]
        m2 = self.concat_layer(h, m, ind["id_c"], ind["id_a"],
                               (sorts.get("id_c"), sorts.get("id_a")))
        for layer in self.residual_m:
            m2 = layer(m2)
        m = scale(m + m2, _INV_SQRT2)
        return h, m
