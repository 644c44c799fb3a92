"""The row-space edge partition ("rung 2a" of the JAX package,
`gemnet_pytorch_tpu/parallel/ep.py`): ONE batched graph across the ranks of
a process group, by rows of its triplet and quadruplet spaces, where nearly
all of the FLOPs live. Everything else stays replicated.

- The canonical row spaces are sorted by reduce edge (`data/padding.py`),
  so contiguous row chunks partition them (`partition_batch`, a numpy copy
  of the JAX package's, array for array). A shard keeps GLOBAL edge ids, so
  its segment plans cover all `len(id_c)` edges (`shard_ep_batch`), and the
  bilinear's segment reduction (kernel K1) writes the full-width (S, nEdges,
  M) accumulation, which is zero outside the shard's band of edges. A
  segment's rows may straddle two shards: the chunks are cut by row count,
  not at segment boundaries. Each shard's padding rows carry the padded
  column's last id with mask False.
- The bilinear is linear in that accumulation, so the ranks combine with one
  psum of the bilinear OUTPUT, (nEdges, units), in each triplet and
  quadruplet path of each block (`models/interaction.py`), before its
  `scale_*_sum`, as in JAX.
- The edge, atom and intermediate spaces, the output blocks and the energy
  and force aggregation compute replicated, the same on every rank. With
  direct forces F comes out replicated with no collective.
- The chunks carry no sort metadata (it is stripped: the global perms are
  wrong for a chunk), so the expand gathers are plain gathers and the sorted
  segment sum K3 is off this path.

Gradients. JAX differentiates outside a `shard_map` with `check_vma=True`
and lets it track which values vary over the axis. Here every rank's
autograd sees only its own graph, so the port uses the rule of the halo
mode (`parallel/halo.py`), which is the exact adjoint of the program
unrolled over the P ranks. Take the objective L = (1/P) sum_r L_r, each
L_r a rank's copy of the replicated loss (or of the energy sum, for
F = -dE/dR), all equal, so L is the single-device objective:

- each rank seeds its replicated scalar with 1/P, so its replicated parts
  (the edge and atom layers, the output blocks, the parameters they use)
  carry 1/P of their cotangent, and the P ranks' parts add to one;
- a psum y = sum_s x_s feeds every rank, so x_s's cotangent is the sum of
  every rank's cotangent of y: psum's backward is a psum
  (`collectives.Psum`), and each rank's rows get the whole cotangent of the
  bilinear output, (1/P) g summed over P ranks;
- the parameter gradient is then the sum of the ranks' parts: one
  all-reduce of the flat gradient (`training.trainer.flat_gradient`), and
  F = -psum(dE/dR) (`models.gemnet.energy_and_forces`).

The train step differentiates twice (its force loss backpropagates through
-dE/dR); psum's backward is the same Function, so the rule holds again. No
cotangent of a replicated operand is all-reduced: JAX's transpose of the
vma-tracked `shard_map` does that for the rbf/cbf streams and intermediate
embeddings the rows read, 213 MB a shard a step at the small bench shape
(`gemnet_pytorch_tpu/parallel/ep.py:15-21`). What the port's step moves is
in `collectives.CALLS` and `collectives.BYTES`: for GemNet-Q, 2 psums of
(nEdges, units) a block in the forward, as many in the -dE/dR backward and
twice as many in the loss's backward, the psum of dE/dR, and the flat
gradient's all-reduce (`chip_smoke.py` phase 15 counts them).

The halo mode (`parallel/halo.py`) shards the edge spaces too and holds
less a rank; the JAX driver deprecates this mode for it (`train.py
--ep` logs so).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np

from ..data.batch import strip_sort_metadata, to_torch
from ..data.padding import EDGE_BLOCK, ROW_BLOCK, _row_splits
from . import mesh

EP_AXIS = "ep"

# batch keys living on the triplet row space
TRIP_ROW_KEYS = ("id3_reduce_ca", "id3_expand_ba", "trip_mask")
# batch keys living on the quadruplet row space
QUAD_ROW_KEYS = (
    "id4_reduce_ca", "id4_expand_db", "id4_reduce_cab", "id4_expand_abd",
    "quad_mask",
)
# every key with a leading (n_shards,) axis after `partition_batch`
ROW_KEYS = TRIP_ROW_KEYS + QUAD_ROW_KEYS + ("trip_row_splits", "quad_row_splits")
# the reduce id columns a shard's segment plans are built from
_REDUCE_KEYS = ("id3_reduce_ca", "id4_reduce_ca")


# ======================================================================
# host partitioner (numpy copy of the JAX package's)
# ======================================================================


def _split_rows(ids, mask, extras, n_shards, n_edges_pad, chunk=None):
    """Split one sorted row space into n_shards contiguous padded chunks."""
    n_real = int(mask.sum())
    bounds = [round(n_real * s / n_shards) for s in range(n_shards + 1)]
    need = max(b1 - b0 for b0, b1 in zip(bounds, bounds[1:]))
    need = -(-max(need, 1) // ROW_BLOCK) * ROW_BLOCK  # pad to kernel chunks
    # a caller-fixed chunk keeps shapes (and captures) stable across batches;
    # it only grows, on an outlier batch that does not fit it
    chunk = need if chunk is None else max(chunk, need)
    pad_id = ids[-1] if len(ids) else 0  # max id (padding keeps sortedness)

    out_ids = np.full((n_shards, chunk), pad_id, ids.dtype)
    out_mask = np.zeros((n_shards, chunk), np.bool_)
    out_extras = {
        k: np.zeros((n_shards, chunk), v.dtype) for k, v in extras.items()
    }
    out_splits = np.zeros((n_shards, n_edges_pad // EDGE_BLOCK + 1), np.int32)
    for s in range(n_shards):
        b0, b1 = bounds[s], bounds[s + 1]
        n = b1 - b0
        out_ids[s, :n] = ids[b0:b1]
        out_mask[s, :n] = True
        for k, v in extras.items():
            out_extras[k][s, :n] = v[b0:b1]
        out_splits[s] = _row_splits(out_ids[s], n_edges_pad)
    return out_ids, out_mask, out_extras, out_splits


def partition_batch(
    batch: dict[str, np.ndarray], n_shards: int,
    trip_chunk: int | None = None, quad_chunk: int | None = None,
) -> dict:
    """Host-side row partitioner: a batch whose row-space arrays (ROW_KEYS)
    have a leading (n_shards,) axis, every other key replicated unchanged,
    and no sort metadata. Fixed chunk sizes keep the shapes of one run's
    batches (and of the dp shards, `parallel/hybrid.py`) the same."""
    n_edges_pad = len(batch["id_c"])
    out = dict(batch)

    ids, mask, extras, splits = _split_rows(
        batch["id3_reduce_ca"], batch["trip_mask"],
        {"id3_expand_ba": batch["id3_expand_ba"]}, n_shards, n_edges_pad,
        chunk=trip_chunk,
    )
    out["id3_reduce_ca"] = ids
    out["trip_mask"] = mask
    out["id3_expand_ba"] = extras["id3_expand_ba"]
    out["trip_row_splits"] = splits

    if "id4_reduce_ca" in batch:
        extras_in = {
            k: batch[k] for k in ("id4_expand_db", "id4_reduce_cab", "id4_expand_abd")
        }
        ids, mask, extras, splits = _split_rows(
            batch["id4_reduce_ca"], batch["quad_mask"], extras_in,
            n_shards, n_edges_pad, chunk=quad_chunk,
        )
        out["id4_reduce_ca"] = ids
        out["quad_mask"] = mask
        out.update(extras)
        out["quad_row_splits"] = splits
    # the sort metadata is a single-device layout contract
    # (data/batch.py SORTED_GATHERS): sliced row spaces invalidate it
    strip_sort_metadata(out)
    return out


# ======================================================================
# the rank's shard
# ======================================================================


def local_ep_batch(batch: dict, shard: int) -> dict:
    """Shard `shard`'s numpy batch of a partition: its row of every ROW_KEYS
    array and the replicated rest. Its reduce ids must be ascending (a chunk
    of the sorted space): the segment plans are built from them."""
    out = {k: (v[shard] if k in ROW_KEYS else v) for k, v in batch.items()}
    for key in _REDUCE_KEYS:
        if key in out and np.any(np.diff(out[key].astype(np.int64)) < 0):
            raise ValueError(f"shard {shard}'s {key} is not ascending")
    return out


def shard_ep_batch(batch: dict, group, device="cuda") -> dict:
    """This rank's shard of a partition as tensors on `device`
    (`data.to_torch`): its segment plans come from its own `id3_reduce_ca`
    and `id4_reduce_ca` over all `len(id_c)` edges, at capacity, so every
    batch of one chunk size gives plans of one shape and a captured ep step
    replays across them. Every process partitions the same batch and takes
    its own shard."""
    return to_torch(local_ep_batch(batch, mesh.rank(group)), device)


# ======================================================================
# the ep model and its steps
# ======================================================================


def ep_model(model, group):
    """`model` (a GemNet) run in rung 2a over `group`: a view that shares
    every parameter, buffer and submodule with `model` (the trainer's flat
    buffer and EMA rebinding reach it), with ep_axis="ep", ep_halo=False
    and the group (JAX: `make_model(replace(cfg, ep_axis=EP_AXIS))` with the
    same variables)."""
    if model.cfg.ep_axis is not None:
        raise ValueError("the model is already a partitioned model")
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, ep_axis=EP_AXIS, ep_halo=False)
    view.group = group
    return view


# the JAX package's name for it (`parallel/ep.py::make_model_ep`)
make_model_ep = ep_model


def make_ep_apply(model, group):
    """(ep shard batch) -> (E, F), replicated on every rank and equal to the
    single-device model's (F = -dE/dR, or the direct head)."""
    from ..models.gemnet import energy_and_forces

    em = ep_model(model, group)
    return lambda batch: energy_and_forces(em, batch)


def make_ep_loss_and_grad(model, group, loss_fn):
    """(ep shard batch) -> (loss, grads): `loss_fn(E, F, batch)` over the
    replicated outputs, and its gradient per parameter (`model.parameters()`
    order), exact and equal on every rank (`training.trainer.flat_gradient`:
    the loss seeded with 1/P, the flat gradient all-reduced once)."""
    from ..models.gemnet import energy_and_forces
    from ..training.trainer import flat_gradient

    em = ep_model(model, group)

    def loss_and_grad(batch):
        params = list(model.parameters())
        E, F = energy_and_forces(em, batch, create_graph=True)
        loss = loss_fn(E, F, batch)
        flat = flat_gradient(loss, params, group, replicated=group)
        return loss.detach(), [v.view_as(p) for v, p in
                               zip(flat.split([p.numel() for p in params]), params)]

    return loss_and_grad


def make_ep_train_step(trainer, group):
    """(state, batch, lr_scale) -> (state, metrics): one training step of the
    ep model on this rank's shard (its host batch, packed row, or tensors on
    a CPU or gloo trainer), exact gradients (module docstring), then the
    trainer's optimizer, EMA and metric accumulation, the same on every rank.
    Captured on an NCCL group, eager on a gloo group."""
    step = trainer.train_step_fn(model=ep_model(trainer.model, group))

    def ep_step(state, batch, lr_scale):
        state, metrics, _ = step(state, batch, lr_scale)
        return state, metrics

    return ep_step
