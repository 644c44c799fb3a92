"""The numpy -> torch boundary of a padded batch.

`pad_batch` emits some index columns as int16 (`padding._shrink_ids`), which
torch indexing rejects. `to_torch` widens every index column to int64, keeps
the sort metadata (`*_perm`/`*_sorted`, kernel inputs) as int32, and adds one
`SegmentPlan` per sorted id column the CUDA segment kernels reduce over,
computed once per batch on the host.

A plan cuts each segment's rows into work items of at most `item_rows` rows.
The kernels run one item at a time per thread block (K1, K2 and K4 at the
quadruplet shape) or warp (K1 and the K4 forward at the triplet shape, K3),
so a segment that
holds thousands of rows — the padded rows all share one segment id — is
spread over many SMs instead of serializing one. An item of a segment with
a single item writes the output directly; the items of a split segment
write partial sums to scratch slots, which are added in a fixed order: by
the last of the segment's items to finish, counted in `arrivals` (K3);
through a merge tree of at most MERGE_FAN children a node, each node added
by the last of its children to finish, counted in `tree_arrivals` (K1 and
the K4 forward at the model's shapes); or, at the shapes those kernels do
not take, by a second kernel over `merge_ptr` / `merge_seg` (K1's general
kernel, the K4 forward's wmma kernel).
Every output is written once and the order of summation is fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .graph import ragged_range
from .padding import SORT_META_KEYS


class SegmentPlan(NamedTuple):
    """Work items of one sorted id column (int32 tensors on the batch's device).

    items: (n_items, 4) rows of [segment, first row, end row, partial slot],
      slot -1 where the item writes the output itself;
    merge_ptr: (n_merge+1,) the slots of split segment j are
      [merge_ptr[j], merge_ptr[j+1]), in row order;
    merge_seg: (n_merge,) the split segments;
    arrivals: (n_merge,) zeros: K3's count of the finished items of each
      split segment, which the kernel returns to zero (one stream at a
      time may launch K3 on a plan);
    tree_nodes: (n_nodes, 4) the merge tree of the split segments, as K1
      and the K4 forward add their partial tiles: node i adds slots [first, end)
      in slot order (at most MERGE_FAN of them) into slot `out`, or into
      the output of `segment` where out is -1 (the segment's root);
    tree_parent: (n_tree_slots,) the node each partial slot feeds (items'
      slots first, then the inner nodes' outputs);
    tree_arrivals: (n_nodes,) zeros: the count of a node's children that
      have finished, returned to zero by the last of them."""

    items: torch.Tensor
    merge_ptr: torch.Tensor
    merge_seg: torch.Tensor
    n_segments: int
    n_partials: int
    arrivals: torch.Tensor
    tree_nodes: torch.Tensor
    tree_parent: torch.Tensor
    tree_arrivals: torch.Tensor
    n_tree_slots: int


# children a merge-tree node adds in sequence
MERGE_FAN = 16


def merge_tree(merge_ptr: np.ndarray, merge_seg: np.ndarray,
               n_partials: int) -> tuple[np.ndarray, np.ndarray]:
    """(nodes, parent) of the split segments' merge trees: split segment j's
    item slots [merge_ptr[j], merge_ptr[j+1]) are cut into groups of at most
    MERGE_FAN consecutive slots, each group a node whose sum takes a new slot
    (numbered from n_partials on); those slots are grouped again, and so on,
    until one group is left, the root, which writes the segment's output.
    Every node's children are consecutive slots."""
    nodes, parent = [], np.full(n_partials, -1, np.int64)
    next_slot = n_partials
    for j, seg in enumerate(merge_seg):
        level = np.arange(merge_ptr[j], merge_ptr[j + 1])
        while True:
            groups = [level[i:i + MERGE_FAN] for i in range(0, len(level), MERGE_FAN)]
            root = len(groups) == 1
            outs = np.arange(next_slot, next_slot + (0 if root else len(groups)))
            next_slot += len(outs)
            parent = np.concatenate([parent, np.full(len(outs), -1)])
            for k, grp in enumerate(groups):
                parent[grp] = len(nodes)
                nodes.append((grp[0], grp[-1] + 1, -1 if root else outs[k], seg))
            if root:
                break
            level = outs
    return np.asarray(nodes, np.int64).reshape(-1, 4), parent


# plan key -> (sorted id column, column whose length is the number of
# segments, rows per work item). K1/K2 items at the quadruplet shape hold
# whole (S, M) tiles, so they are long enough that real quadruplet segments
# (~63 rows) stay whole. At the triplet shape a K1 item is one warp's work
# (real segments ~8 rows): 16-row items spread the padded segment's ~1600
# rows over ~100 warps, where a warp streaming 128-row items was the
# launch's long pole, and its ~100 partial tiles merge in two tree levels
# (on the H100, 0.0119 ms against 0.0164 ms with 128-row items, PERF.md
# §6, scripts/k1_parts.py); the K4 forward runs K1's warp kernel on the same
# items. K2 reads the triplet rows' ids, not the items, and K4's triplet
# backward takes any item size. A K3 item is one warp's work, 64 rows at
# most (two loads of 32 perm entries), so the padded segment's ~9600 rows
# at the bench quad shape spread over ~150 warps and the last of them adds
# ~150 partial rows.
SEGMENT_PLANS = {
    "id3_reduce_ca_plan": ("id3_reduce_ca", "id_c", 16),
    "id4_reduce_ca_plan": ("id4_reduce_ca", "id_c", 128),
    "trip_ba_plan": ("trip_ba_sorted", "id_c", 64),
    "intm_db_plan": ("intm_db_sorted", "id_c", 64),
    "quad_abd_plan": ("quad_abd_sorted", "id4_reduce_intm_ca", 64),
    "quad_cab_plan": ("quad_cab_sorted", "id4_reduce_intm_ca", 64),
}


def segment_plan(sorted_ids: np.ndarray, n_segments: int, item_rows: int,
                 device) -> SegmentPlan:
    """Work items of ascending `sorted_ids` over `n_segments` segments.

    Raises when an id lies outside [0, n_segments): the kernels own every row
    through exactly one segment, and would leave such a row unwritten."""
    sorted_ids = np.asarray(sorted_ids)
    ptr = np.searchsorted(sorted_ids, np.arange(n_segments + 1), side="left")
    if len(sorted_ids) and (ptr[-1] != len(sorted_ids) or sorted_ids[0] < 0):
        raise ValueError(f"segment ids outside [0, {n_segments})")
    lengths = np.diff(ptr)
    per_seg = np.maximum(1, -(-lengths // item_rows))  # every segment gets an item
    seg = np.repeat(np.arange(n_segments), per_seg)
    row0 = ptr[seg] + ragged_range(per_seg).astype(np.int64) * item_rows
    row1 = np.minimum(row0 + item_rows, ptr[seg + 1])
    split = per_seg[seg] > 1
    slot = np.where(split, np.cumsum(split) - 1, -1)
    merge_seg = np.nonzero(per_seg > 1)[0]
    merge_ptr = np.concatenate([[0], np.cumsum(per_seg[merge_seg])])
    items = np.stack([seg, row0, row1, slot], axis=1).astype(np.int32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

    n_partials = int(split.sum())
    nodes, parent = merge_tree(merge_ptr, merge_seg, n_partials)
    return SegmentPlan(t(items), t(merge_ptr), t(merge_seg), int(n_segments), n_partials,
                       t(np.zeros(len(merge_seg))), t(nodes), t(parent), t(np.zeros(len(nodes))),
                       len(parent))


def to_torch(batch: dict[str, np.ndarray], device) -> dict:
    """Padded numpy batch -> tensors on `device`, plus the segment plans."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if k in SORT_META_KEYS:
            v = v.astype(np.int32)
        elif np.issubdtype(v.dtype, np.integer):
            v = v.astype(np.int64)
        elif np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    for key, (ids_key, size_key, item_rows) in SEGMENT_PLANS.items():
        if ids_key in batch:
            out[key] = segment_plan(batch[ids_key], len(batch[size_key]), item_rows, device)
    return out
