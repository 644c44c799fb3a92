"""The numpy -> torch boundary of a padded batch.

`pad_batch` emits some index columns as int16 (`padding._shrink_ids`), which
torch indexing rejects. `to_torch` widens every index column to int64, keeps
the sort metadata (`*_perm`/`*_sorted`, kernel inputs) as int32, and adds one
`SegmentPlan` per sorted id column the CUDA segment kernels reduce over,
computed once per batch on the host.

A plan cuts each segment's rows into work items of at most `item_rows` rows.
The kernels run one item per thread block (K1, K2) or thread group (K3), so a
segment that holds thousands of rows — the padded rows all share one segment
id — is spread over many SMs instead of serializing one. An item of a
segment with a single item writes the output directly; the items of a split
segment write partial sums to scratch slots, which a second pass adds in
order. Every output is written once and the order of summation is fixed.
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
    merge_seg: (n_merge,) the split segments."""

    items: torch.Tensor
    merge_ptr: torch.Tensor
    merge_seg: torch.Tensor
    n_segments: int
    n_partials: int


# plan key -> (sorted id column, column whose length is the number of
# segments, rows per work item). K1/K2 items hold whole (S, M) tiles, so
# their items are long enough that real quadruplet segments (~63 rows) stay
# whole; K3 items cost one thread per feature, so they are short.
SEGMENT_PLANS = {
    "id3_reduce_ca_plan": ("id3_reduce_ca", "id_c", 128),
    "id4_reduce_ca_plan": ("id4_reduce_ca", "id_c", 128),
    "trip_ba_plan": ("trip_ba_sorted", "id_c", 32),
    "intm_db_plan": ("intm_db_sorted", "id_c", 32),
    "quad_abd_plan": ("quad_abd_sorted", "id4_reduce_intm_ca", 32),
    "quad_cab_plan": ("quad_cab_sorted", "id4_reduce_intm_ca", 32),
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

    return SegmentPlan(t(items), t(merge_ptr), t(merge_seg), int(n_segments), int(split.sum()))


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
