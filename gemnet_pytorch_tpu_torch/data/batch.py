"""The numpy -> torch boundary of a padded batch.

`pad_batch` emits some index columns as int16 (`padding._shrink_ids`), which
torch indexing rejects. `to_torch` widens every index column to int64, keeps
the sort metadata (`*_perm`/`*_sorted`, kernel inputs) as int32 and the
periodic cell offsets (NARROW_KEYS) as int8 (`device_width`, as the packer
does), adds the edges' sort metadata (`edge_sort_metadata`) to a batch that
carries the single-device sort metadata, and adds one `SegmentPlan` per
sorted id column the CUDA segment kernels reduce over, computed once per
batch on the host.

`SORTED_GATHERS` is the one table of the model's sorted gathers: for each
index column a gather reads, the batch keys of its sort metadata (perm,
sorted ids, plan), from which the key lists below derive; `gather_sorts`
reads a device batch's metadata through it for `ops.expand_gather.gather`.

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

A plan has a fixed capacity (`plan_capacity`): its items, merges, tree
nodes and slots are padded to bounds set by the row count, the segment
count and `item_rows` alone, so two batches of one `PadDims` give plans of
the same shapes and the same Python ints, and a CUDA graph captured on one
replays on the other. A padding item is [-1, 0, 0, -1] (segment -1: no
kernel mistakes it for an empty real segment, whose item writes zeros), a
padding merge has segment -1 and an empty slot range, a padding tree node
[0, 0, -1, -1] is never reached (no real slot feeds it). The kernels skip
them; the real items keep their order, so a capacity plan gives the same
bits as the exact one (`capacity=False`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .graph import ragged_range

# index column -> (perm key, or None where the column ascends; sorted ids
# key; plan key) of each gather whose VJP runs as the sorted segment sum K3
# on a single-device batch: the triplet geometry's and the triplet
# interaction's by id3_reduce_ca and id3_expand_ba, the quadruplet
# interaction's by id4_expand_intm_db and id4_expand_abd (the latter and
# id4_reduce_cab also the quadruplet geometry's), and the gathers of atom
# rows to edge rows by id_a and id_c (one sorted column and plan,
# `edge_sort_metadata`). `pad_batch` derives every other column's metadata.
SORTED_GATHERS = {
    "id3_reduce_ca": (None, "id3_reduce_ca", "id3_reduce_ca_plan"),
    "id3_expand_ba": ("trip_ba_perm", "trip_ba_sorted", "trip_ba_plan"),
    "id4_expand_intm_db": ("intm_db_perm", "intm_db_sorted", "intm_db_plan"),
    "id4_expand_abd": ("quad_abd_perm", "quad_abd_sorted", "quad_abd_plan"),
    "id4_reduce_cab": ("quad_cab_perm", "quad_cab_sorted", "quad_cab_plan"),
    "id_a": ("edge_a_perm", "edge_sorted", "edge_plan"),
    "id_c": ("edge_c_perm", "edge_sorted", "edge_plan"),
}
EDGE_COLUMNS = ("id_a", "id_c")
# the sort metadata `pad_batch` emits (an ascending column has none), and the
# edges' (`edge_sort_metadata`: two perms of one sorted column)
SORT_META_KEYS = tuple(k for c, (perm, ids, _) in SORTED_GATHERS.items()
                       if perm is not None and c not in EDGE_COLUMNS for k in (perm, ids))
EDGE_SORT_KEYS = tuple(SORTED_GATHERS[c][0] for c in EDGE_COLUMNS) + (SORTED_GATHERS["id_a"][1],)
# integer keys the model reads at their own width (not widened to int64):
# the periodic edges' int8 cell offsets
NARROW_KEYS = frozenset({"edge_offset"})
# integer keys the kernels read as int32: the sort metadata
INT32_KEYS = frozenset(SORT_META_KEYS + EDGE_SORT_KEYS)


def device_width(key: str, value: np.ndarray) -> np.ndarray:
    """`value` at the width the model reads key `key` at."""
    value = np.asarray(value)
    if key in INT32_KEYS:
        return value.astype(np.int32)
    if key in NARROW_KEYS:
        return value
    if np.issubdtype(value.dtype, np.integer):
        return value.astype(np.int64)
    if np.issubdtype(value.dtype, np.floating):
        return value.astype(np.float32)
    return value


def sort_keys(batch: dict) -> tuple[str, ...]:
    """Every key of the table rows of the columns `batch` has: what a
    single-device batch carries."""
    return tuple(dict.fromkeys(k for c, row in SORTED_GATHERS.items() if c in batch
                               for k in row if k is not None))


def strip_sort_metadata(batch: dict) -> dict:
    """Drop the sort metadata of every column that is not ascending, perms,
    sorted ids and plans, from `batch` in place (and return it): any
    re-slicing of a row space invalidates it."""
    for perm, ids, plan in SORTED_GATHERS.values():
        if perm is not None:
            for k in (perm, ids, plan):
                batch.pop(k, None)
    return batch


def gather_sorts(batch: dict) -> dict[str, tuple]:
    """{index column: (perm, sorted ids, plan)} of the sorted gathers of a
    device batch: on a single-device batch (one that carries SORT_META_KEYS,
    as `with_edge_sort_metadata` tests) every table row whose column it has;
    on a halo or ep shard, whose re-sliced rows carry none, {}: every gather
    there is plain."""
    if SORT_META_KEYS[0] not in batch:
        return {}
    return {c: (None if perm is None else batch[perm], batch[ids], batch[plan])
            for c, (perm, ids, plan) in SORTED_GATHERS.items() if c in batch}


class PlanCapacity(NamedTuple):
    """Sizes of a plan at capacity (see `plan_capacity`)."""

    items: int
    partials: int
    merges: int
    nodes: int
    tree_slots: int


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
    Every node's children are consecutive slots.

    Nodes are numbered segment by segment, level by level within a segment
    and group by group within a level, and the non-root nodes' slots follow
    the same order, so a segment's tree takes one run of node numbers and
    one run of slots. All segments are built at once: a loop over the tree
    levels (at most 5 up to 2^20 items) lists each segment's level sizes,
    c_0 = ceil(k / 16), c_1 = ceil(c_0 / 16), ... down to its root, and from
    those sizes every node and every `parent` entry is filled in one
    vectorized step over all segments and levels."""
    merge_ptr = np.asarray(merge_ptr, np.int64)
    merge_seg = np.asarray(merge_seg, np.int64)
    # one block per segment and level: the segment, its children there, its
    # nodes there (1: the root), the segment's nodes before the block and
    # before its children's level (-1 at level 0: the children are items)
    blocks, active, width = [], np.arange(len(merge_seg)), np.diff(merge_ptr)
    per_seg = np.zeros(len(merge_seg), np.int64)
    last = np.full(len(merge_seg), -1, np.int64)
    while True:
        n = -(-width // MERGE_FAN)
        blocks.append((active, width, n, per_seg[active], last[active]))
        last[active] = per_seg[active]
        per_seg[active] += n
        active, width = active[n > 1], n[n > 1]
        if not len(active):
            break
    seg, width, n, before, children_before = map(np.concatenate, zip(*blocks))
    node_base = np.cumsum(per_seg) - per_seg
    first_node = node_base[seg] + before
    # a non-root node's slot: one per node before it, less one root per earlier segment
    out_base = n_partials + node_base[seg] - seg
    first_child = np.where(children_before < 0, merge_ptr[seg], out_base + children_before)
    nodes = np.empty((int(per_seg.sum()), 4), np.int64)
    parent = np.full(n_partials + len(nodes) - len(merge_seg), -1, np.int64)
    # slot first_child + c feeds the block's node c // MERGE_FAN
    b, c = np.repeat(np.arange(len(seg)), width), ragged_range(width)
    parent[first_child[b] + c] = first_node[b] + c // MERGE_FAN
    # node g adds slots [first_child + g MERGE_FAN, first_child + min((g + 1) MERGE_FAN, width))
    b, g = np.repeat(np.arange(len(seg)), n), ragged_range(n)
    first = first_child[b] + g * MERGE_FAN
    nodes[first_node[b] + g] = np.stack([
        first, np.minimum(first + MERGE_FAN, (first_child + width)[b]),
        np.where(n[b] > 1, (out_base + before)[b] + g, -1), merge_seg[seg[b]]], 1)
    return nodes, parent


def plan_capacity(n_rows: int, n_segments: int, item_rows: int) -> PlanCapacity:
    """Bounds on a plan's sizes over any ids of `n_rows` rows in `n_segments`
    segments cut into items of `item_rows` (tests/test_torch_plans.py holds
    them against every plan it draws):
    - items: a segment of l rows takes max(1, ceil(l / r)) <= 1 + floor(l / r)
      items, so items <= n_segments + floor(n_rows / r) <= n_segments +
      ceil(n_rows / r);
    - partials: the items of split segments (l > r), ceil(l / r) <=
      2 floor(l / r) each, so partials <= 2 floor(n_rows / r), and <= items;
    - merges: a split segment has at least 2 items, so merges <= partials // 2;
    - the merge tree (`merge_tree`) of a split segment of k items has levels
      of c_0 = ceil(k / 16), c_1 = ceil(c_0 / 16), ... nodes down to one
      root; a level of c >= 2 nodes feeds one of at most c / 2, so the
      non-root nodes number at most 2 c_0 <= (k + 15) / 8, which is 0 for
      k <= 16 and <= k / 4 beyond: inner nodes <= partials // 4 in all. A
      node's output takes a slot unless it is a root, and every split
      segment has one root: tree slots <= partials + partials // 4, nodes <=
      merges + partials // 4."""
    items = n_segments + -(-n_rows // item_rows)
    partials = min(items, 2 * (n_rows // item_rows))
    inner = partials // 4
    return PlanCapacity(items, partials, partials // 2, partials // 2 + inner, partials + inner)


def _pad_rows(x: np.ndarray, n: int, fill) -> np.ndarray:
    """x with rows of `fill` appended up to n rows (raises past n)."""
    if len(x) > n:
        raise ValueError(f"{len(x)} rows exceed the plan's capacity {n}")
    pad = np.broadcast_to(np.asarray(fill, x.dtype), (n - len(x),) + x.shape[1:])
    return np.concatenate([x, pad])


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
# ~150 partial rows. K3 also reduces over `id3_reduce_ca_plan`'s 16-row
# items (the triplet geometry's gather by the ascending reduce column).
SEGMENT_PLANS = {
    "id3_reduce_ca_plan": ("id3_reduce_ca", "id_c", 16),
    "id4_reduce_ca_plan": ("id4_reduce_ca", "id_c", 128),
    "trip_ba_plan": ("trip_ba_sorted", "id_c", 64),
    "intm_db_plan": ("intm_db_sorted", "id_c", 64),
    "quad_abd_plan": ("quad_abd_sorted", "id4_reduce_intm_ca", 64),
    "quad_cab_plan": ("quad_cab_sorted", "id4_reduce_intm_ca", 64),
    "edge_plan": ("edge_sorted", "Z", 64),
}


def edge_sort_metadata(batch: dict) -> dict[str, np.ndarray]:
    """The sort metadata (EDGE_SORT_KEYS, int32) of the model's gathers of
    atom rows to edge rows, h[id_c], h[id_a], R[id_c], R[id_a], over the
    padded edges: `edge_a_perm`, the stable argsort of id_a; `edge_sorted`,
    id_a in that order; `edge_c_perm` = id_swap[edge_a_perm], which sorts
    id_c into the same column, so both gathers share one column and one
    plan with no second sort.

    That holds because every edge's reverse is its id_swap row,
    id_c[id_swap] == id_a (a padded edge is its own reverse, with id_c =
    id_a = 0), as `data.graph` builds every graph. Raises where a batch
    breaks that, or where id_swap is not an involution, which
    `ops.expand_gather.swap_rows` relies on."""
    id_c, id_a, swap = (np.asarray(batch[k], np.int64) for k in ("id_c", "id_a", "id_swap"))
    if not np.array_equal(swap[swap], np.arange(len(swap))):
        raise ValueError("id_swap is not an involution")
    if not np.array_equal(id_c[swap], id_a):
        raise ValueError("id_c[id_swap] != id_a: an edge's reverse is not at its id_swap row")
    perm_a = np.argsort(id_a, kind="stable")
    return {"edge_a_perm": perm_a.astype(np.int32), "edge_c_perm": swap[perm_a].astype(np.int32),
            "edge_sorted": id_a[perm_a].astype(np.int32)}


def with_edge_sort_metadata(batch: dict) -> dict:
    """`batch` and its `edge_sort_metadata` where it carries the
    single-device sort metadata (a halo or ep shard's re-sliced rows do
    not) and not yet the edges'; else `batch` itself."""
    if SORT_META_KEYS[0] not in batch or EDGE_SORT_KEYS[0] in batch:
        return batch
    return {**batch, **edge_sort_metadata(batch)}


# the plan's int32 arrays, in the order SegmentPlan holds them; the arrival
# counters are not among them (they start at zero, see SegmentPlan)
PLAN_ARRAYS = ("items", "merge_ptr", "merge_seg", "tree_nodes", "tree_parent")


def plan_arrays(sorted_ids: np.ndarray, n_segments: int, item_rows: int,
                capacity: bool = True) -> tuple[dict[str, np.ndarray], int, int]:
    """(the PLAN_ARRAYS as int32 numpy arrays, n_partials, n_tree_slots) of
    `segment_plan`."""
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
    items = np.stack([seg, row0, row1, slot], axis=1)
    n_partials = int(split.sum())
    nodes, parent = merge_tree(merge_ptr, merge_seg, n_partials)
    n_tree_slots = len(parent)
    if capacity:
        cap = plan_capacity(len(sorted_ids), n_segments, item_rows)
        items = _pad_rows(items, cap.items, [-1, 0, 0, -1])
        merge_ptr = _pad_rows(merge_ptr, cap.merges + 1, merge_ptr[-1])
        merge_seg = _pad_rows(merge_seg, cap.merges, -1)
        nodes = _pad_rows(nodes, cap.nodes, [0, 0, -1, -1])
        parent = _pad_rows(parent, cap.tree_slots, -1)
        n_partials, n_tree_slots = cap.partials, cap.tree_slots
    arrays = dict(zip(PLAN_ARRAYS, (items, merge_ptr, merge_seg, nodes, parent)))
    return ({k: np.ascontiguousarray(v, dtype=np.int32) for k, v in arrays.items()},
            n_partials, n_tree_slots)


def segment_plan(sorted_ids: np.ndarray, n_segments: int, item_rows: int, device,
                 capacity: bool = True) -> SegmentPlan:
    """Work items of ascending `sorted_ids` over `n_segments` segments, padded
    to `plan_capacity` (or exactly as many as the ids need, `capacity=False`).

    Raises when an id lies outside [0, n_segments): the kernels own every row
    through exactly one segment, and would leave such a row unwritten."""
    arrays, n_partials, n_tree_slots = plan_arrays(sorted_ids, n_segments, item_rows, capacity)
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    return make_plan(t, int(n_segments), n_partials, n_tree_slots,
                     torch.zeros(len(arrays["merge_seg"]), dtype=torch.int32, device=device),
                     torch.zeros(len(arrays["tree_nodes"]), dtype=torch.int32, device=device))


def make_plan(arrays: dict, n_segments: int, n_partials: int, n_tree_slots: int,
              arrivals: torch.Tensor, tree_arrivals: torch.Tensor) -> SegmentPlan:
    """A SegmentPlan of the PLAN_ARRAYS tensors `arrays` (items as given, or
    flat and made (n, 4)) and zeroed arrival counters."""
    return SegmentPlan(arrays["items"].reshape(-1, 4), arrays["merge_ptr"], arrays["merge_seg"],
                       n_segments, n_partials, arrivals, arrays["tree_nodes"].reshape(-1, 4),
                       arrays["tree_parent"], tree_arrivals, n_tree_slots)


def plans_of(batch: dict):
    """(plan key, sorted ids, n_segments, item_rows) of each SEGMENT_PLANS
    entry whose sorted ids `batch` carries."""
    for key, (ids_key, size_key, item_rows) in SEGMENT_PLANS.items():
        if ids_key in batch:
            yield key, batch[ids_key], len(batch[size_key]), item_rows


def to_torch(batch: dict[str, np.ndarray], device) -> dict:
    """Padded numpy batch -> tensors on `device` at their `device_width`,
    plus the edges' sort metadata (`with_edge_sort_metadata`) and the
    segment plans at capacity."""
    batch = with_edge_sort_metadata(batch)
    out = {k: torch.from_numpy(np.ascontiguousarray(device_width(k, v))).to(device)
           for k, v in batch.items()}
    for key, ids, n_segments, item_rows in plans_of(batch):
        out[key] = segment_plan(ids, n_segments, item_rows, device)
    return out
