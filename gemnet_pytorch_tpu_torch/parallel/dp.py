"""Data parallelism over a process group (port of
`gemnet_pytorch_tpu/parallel/dp.py`).

Each rank owns one padded batch (a shard of molecules); the parameters,
optimizer state and EMA are replicated, one copy a rank. The loss is in
global num/den form (`training.trainer._ratios` with the group): each rank
differentiates its LOCAL numerators over the GLOBAL denominators, so the
all-reduced gradient is the exact gradient of the global masked mean, equal
to single-device training on the concatenated batch up to summation order;
the metrics and counts are global and the same on every rank.

Every process draws the same global batches (as the JAX package's
multi-process contract: the provider is seeded identically everywhere) and
takes its own shard (`shard_batch_to_mesh`).

On an NCCL group the train and eval steps are captured into CUDA graphs
(`Trainer.train_step_fn` / `eval_step_fn`, `graphs.capture`), the
gradient's all-reduce inside the graph: the counterpart of JAX's jitted
`shard_map`. On a gloo group they run eagerly: gloo's collectives run on
the host, which a graph cannot replay. The predict has no collective on
its hot path.
"""

from __future__ import annotations

import numpy as np

from ..data.batch import to_torch
from . import mesh
from .collectives import all_gather

AXIS = "dp"


def stack_shards(batches):
    """Stack per-rank batches (dicts or packed rows) along a new leading
    rank axis."""
    if isinstance(batches[0], dict):
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    return np.stack(batches)


def shard_batch_to_mesh(stacked, group, device=None):
    """This rank's shard of host-stacked batches: row `rank(group)` of every
    array. Packed rows stay a host row (the captured step copies it into its
    static buffer); a dict becomes `data.to_torch` tensors (and segment
    plans) on `device` when one is given, else stays numpy."""
    r = mesh.rank(group)
    if not isinstance(stacked, dict):
        return np.asarray(stacked[r])
    local = {k: v[r] for k, v in stacked.items()}
    return local if device is None else to_torch(local, device)


def make_dp_train_step(trainer, group):
    """(state, batch, lr_scale) -> (state, metrics, counts): the data-parallel
    step on this rank's shard (a host batch, its packed row, or tensors on a
    CPU or gloo trainer). The flat gradient is all-reduced once (dp.py:62);
    the per-tensor optimizer's (tree mode, AGC) as one coalesced buffer.
    Captured on an NCCL group, eager on a gloo group (module docstring)."""
    return trainer.train_step_fn(group=group)


def make_dp_eval_step(trainer, group):
    """(state, batch, use_ema=False) -> (metrics, counts), GLOBAL masked
    ratios, the same on every rank. A remainder group is padded with
    `trainer.packer.zero_masks(row)` rows (or batches with zeroed masks),
    which add zero to every num/den pair. Captured on an NCCL group."""
    return trainer.eval_step_fn(group=group)


def make_dp_predict_fn(model, group):
    """(batch, gather=False) -> (E, F) of `model` on this rank's shard (the
    model's force path, -dE/dR through autograd where it has no direct
    head): no collective on the hot path. With `gather=True` every rank's E
    and F are gathered into JAX's (n_dev, ...) layout."""
    from ..models.gemnet import energy_and_forces

    def predict(batch, gather: bool = False):
        E, F = energy_and_forces(model, batch)
        if gather:
            return all_gather(E, group), all_gather(F, group)
        return E, F

    return predict

