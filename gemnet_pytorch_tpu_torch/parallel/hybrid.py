"""Data parallelism times an edge partition on a 2-D mesh of process groups
(port of `gemnet_pytorch_tpu/parallel/hybrid.py`).

`mesh.make_hybrid_mesh(n_dp, n_ep)` cuts the world into n_dp rows of n_ep
ranks: rank r = dp_index * n_ep + ep_index, JAX's `devices.reshape(n_dp,
n_ep)`. Each row (its ep group) owns one padded batch of molecules and
partitions it over its n_ep ranks; the rows split the global batch as data
parallelism does (their column groups are the dp axis).

- dp x ep: each row's batch is partitioned by rows of its triplet and
  quadruplet spaces (`parallel/ep.py`, rung 2a), with one chunk size common
  to every row (`build_hybrid_batch`);
- dp x halo, the JAX driver's production layout (its `train.py:68-72`):
  each row's batch is halo-partitioned (`parallel/halo.py`), with one
  `HaloPads` common to every row (`build_dp_halo_batch`).

Each rank builds the same stacked batch from the same seed and takes its
own (dp, ep) slice (`shard_hybrid_batch`, `shard_dp_halo_batch`), as
`halo.shard_halo_batch` does.

Gradients: the rules of the two axes compose. Over dp, each rank's loss is
its row's LOCAL numerator over the GLOBAL denominator (num/den all-reduced
over the dp group, `training.trainer._ratios`); within a row, that loss is
replicated over the ep group, so it is seeded with 1/n_ep, and the model's
collectives (the bilinear psums of rung 2a, the halo's all-to-alls and
psums) ride the ep group. Summing the ranks' parts over a row gives the
exact gradient of the row's term (`parallel/ep.py`'s argument), summing
over the rows that of the global masked mean: the flat gradient is
all-reduced ONCE, over the world (`Trainer.train_step`'s `grad_group`).
The metrics that drive a run's decisions are broadcast from ep rank 0 of
each row: the rows' dp all-reduces then agree on every rank (the halo
eval's reason, `parallel/halo.py::make_halo_eval_step`).
"""

from __future__ import annotations

import numpy as np

from ..data.batch import to_torch
from ..data.padding import ROW_BLOCK
from .ep import ep_model, local_ep_batch, partition_batch
from .halo import broadcast_metrics, halo_model, local_halo_batch


def _loss_and_grad(model, view, hmesh, loss_parts_fn):
    """(batch) -> (loss, grads) of the global masked mean over the mesh:
    `loss_parts_fn(E, F, batch)` -> (numerator, denominator) of this rank's
    row, `view` the partitioned model over the row's ep group."""
    from ..models.gemnet import energy_and_forces
    from ..training.trainer import _ratios, flat_gradient

    def loss_and_grad(batch):
        params = list(model.parameters())
        E, F = energy_and_forces(view, batch, create_graph=True)
        local, loss = _ratios(loss_parts_fn(E, F, batch), hmesh.dp)
        flat = flat_gradient(local, params, hmesh.world, replicated=hmesh.ep)
        return loss, [v.view_as(p) for v, p in
                      zip(flat.split([p.numel() for p in params]), params)]

    return loss_and_grad


# ======================================================================
# dp x ep
# ======================================================================


def build_hybrid_batch(batches: list[dict], n_ep: int) -> dict:
    """Stack dp shards of ep-partitioned batches: row arrays (ep.ROW_KEYS)
    -> (n_dp, n_ep, rows...), the others -> (n_dp, ...). One chunk size a
    space, from the dp shard with the most real rows, so the stacked shapes
    agree."""

    def common_chunk(mask_key):
        worst = max(int(b[mask_key].sum()) for b in batches)
        per = -(-worst // n_ep)
        return -(-max(per, 1) // ROW_BLOCK) * ROW_BLOCK

    trip_chunk = common_chunk("trip_mask")
    quad_chunk = common_chunk("quad_mask") if "id4_reduce_ca" in batches[0] else None
    parts = [
        partition_batch(b, n_ep, trip_chunk=trip_chunk, quad_chunk=quad_chunk)
        for b in batches
    ]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def local_hybrid_batch(batch: dict, dp_index: int, ep_index: int) -> dict:
    """The (dp_index, ep_index) shard of a `build_hybrid_batch` stack, as
    `ep.local_ep_batch` gives it."""
    return local_ep_batch({k: v[dp_index] for k, v in batch.items()}, ep_index)


def shard_hybrid_batch(batch: dict, hmesh, device="cuda") -> dict:
    """This rank's shard of a dp x ep stack as tensors on `device`, with the
    segment plans of its own rows (`ep.shard_ep_batch`)."""
    return to_torch(local_hybrid_batch(batch, hmesh.dp_index, hmesh.ep_index), device)


def make_hybrid_loss_and_grad(model, hmesh, loss_parts_fn):
    """(shard batch) -> (loss, grads): the global loss sum(num) / sum(den)
    over the dp rows (`loss_parts_fn(E, F, batch)` -> (num, den) of this
    rank's row), its gradient per parameter (`model.parameters()` order),
    exact and the same on every rank; the model's psums ride the ep group."""
    return _loss_and_grad(model, ep_model(model, hmesh.ep), hmesh, loss_parts_fn)


# ======================================================================
# dp x halo
# ======================================================================


def build_dp_halo_batch(graph_tuples, n_ep: int, triplets_only: bool = False, pads=None):
    """Halo-partition each dp shard's graph over `n_ep` with ONE common
    HaloPads, so the stacked shapes agree.

    graph_tuples: per-dp-shard (g, Z, R, E, F) tuples. Returns
    (stacked batch, the pads used): halo SHARDED_KEYS get a leading
    (n_dp, n_ep, ...) axis, the keys replicated within a row (n_dp, ...).
    `pads` (from a previous call or `halo.estimate_halo_pads`) keeps one
    shape across a run's batches."""
    from .halo import build_halo_partition, device_batch_halo

    def part(tup, pads):
        g, Z, R, E, F = tup
        return build_halo_partition(
            g, Z, R, n_ep, E=E, F=F, triplets_only=triplets_only, pads=pads)

    first = [part(t, pads) for t in graph_tuples]
    common = first[0]["halo_pads"]
    for p in first[1:]:
        common = common.grow_to(p["halo_pads"])
    # rebuild any shard whose natural sizes were below the common pads
    parts = [
        p if p["halo_pads"] == common else part(t, common)
        for p, t in zip(first, graph_tuples)
    ]
    stacked = {
        k: np.stack([device_batch_halo(p)[k] for p in parts])
        for k in device_batch_halo(parts[0])
    }
    return stacked, common


def local_dp_halo_batch(batch: dict, dp_index: int, ep_index: int) -> dict:
    """The (dp_index, ep_index) shard of a `build_dp_halo_batch` stack, as
    `halo.local_halo_batch` gives it."""
    return local_halo_batch({k: v[dp_index] for k, v in batch.items()}, ep_index)


def shard_dp_halo_batch(batch: dict, hmesh, device="cuda") -> dict:
    """This rank's shard of a dp x halo stack as tensors on `device`, with
    the segment plans of its own reduce ids (`halo.shard_halo_batch`)."""
    return to_torch(local_dp_halo_batch(batch, hmesh.dp_index, hmesh.ep_index), device)


def make_dp_halo_loss_and_grad(model, hmesh, loss_parts_fn):
    """(shard batch) -> (loss, grads), as `make_hybrid_loss_and_grad` with
    the halo model over each row's ep group."""
    return _loss_and_grad(model, halo_model(model, hmesh.ep), hmesh, loss_parts_fn)


def make_dp_halo_eval_step(trainer, hmesh):
    """(state, batch, use_ema=False) -> (metrics, counts) on the dp x halo
    mesh: GLOBAL ratios over the dp rows, the same on every rank (ep rank
    0's, broadcast over each row). `batch` is what the trainer's
    `eval_step_fn()` takes for this rank's shard; captured where every
    group is NCCL. A row with no batch takes a copy of another's with its
    mol and atom masks zeroed, which adds nothing."""
    step = trainer.eval_step_fn(group=hmesh.dp, model=halo_model(trainer.model, hmesh.ep))

    def eval_step(state, batch, use_ema=False):
        metrics, counts = step(state, batch, use_ema)
        return broadcast_metrics(metrics, hmesh.ep), counts

    return eval_step


def make_dp_halo_train_step(trainer, hmesh):
    """(state, batch, lr_scale) -> (state, metrics): one training step on
    the dp x halo mesh (module docstring's gradients), then the trainer's
    optimizer, EMA and metric accumulation, the same on every rank.
    Captured where every group is NCCL (a 1x1 mesh on one card), eager on
    gloo."""
    step = trainer.train_step_fn(group=hmesh.dp, model=halo_model(trainer.model, hmesh.ep),
                                 grad_group=hmesh.world)

    def dp_halo_step(state, batch, lr_scale):
        state, metrics, _ = step(state, batch, lr_scale)
        return state, metrics

    return dp_halo_step

