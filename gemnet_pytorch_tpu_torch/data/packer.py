"""One buffer per host->device transfer: the counterpart of the JAX
package's `BatchPacker` (gemnet_pytorch_tpu/training/trainer.py:56-153).

`pack` lays a padded numpy batch and its capacity segment plans
(`data.batch.plan_arrays`) into ONE int32 host buffer, at the widths
`data.to_torch` hands the model: int64 index columns, int32 sort metadata
and plans, int8 cell offsets, fp32 floats, bool masks. `unpack` turns one
buffer (on the CPU or the card) into the batch dict of `to_torch` as
zero-copy views: each key a slice of words viewed as its dtype. A CUDA
graph captured on the views of a static device buffer replays on every
batch copied into it.

The layout is frozen on first use: the keys in sorted order, the keys the
model never reads (`UNUSED_DEVICE_KEYS`) skipped, then the edges' sort
metadata (`data.batch.with_edge_sort_metadata`), then each plan's arrays;
every key starts on a 256-byte boundary, as a tensor of PyTorch's caching
allocator does: the kernels read the plans' items as 16-byte vectors, and
an int64 view of int32 words needs an even word offset (the JAX packer's
4-byte alignment serves only its 4-byte bitcasts). A batch of other shapes re-freezes it and bumps `version`, on
which captured steps capture again. The plans' arrival counters are not
packed: each plan of an unpacked batch takes a static zeroed buffer per
device, which the kernels return to zero after every launch.

`to_device` stages rows in a pinned host buffer and sends them in one
non-blocking copy. Each pinned buffer is reused only after the event
recorded behind its last copy has passed, so staging never overwrites rows
still in flight.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..perf import spans
from .batch import (EDGE_SORT_KEYS, PLAN_ARRAYS, device_width, make_plan, plan_arrays,
                    plan_capacity, plans_of, with_edge_sort_metadata)

# batch keys the model never reads, left out of the buffer (trainer.py:43-46)
UNUSED_DEVICE_KEYS = frozenset({
    "Kidx3", "Kidx4", "kmax3_static", "kmax4_static", "id4_expand_db",
    "intm_ca_mask", "n_mol", "N",
})
MASK_KEYS = ("mol_mask", "atom_mask")
# bytes every key's offset is a multiple of
ALIGN = 256
# pinned staging buffers per size: one filled while the other is in flight
STAGING_DEPTH = 2
_TORCH_DTYPE = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
                np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool,
                np.dtype(np.int8): torch.int8}


def _entries(batch) -> list[tuple[str, np.ndarray]]:
    """(key, array) of everything packed, in layout order: the padded batch's
    keys sorted, then the edges' sort metadata (`with_edge_sort_metadata`,
    already in `batch`), then each plan's arrays as "<plan key>.<array>"."""
    keys = [k for k in sorted(batch) if k not in UNUSED_DEVICE_KEYS and k not in EDGE_SORT_KEYS]
    keys += [k for k in EDGE_SORT_KEYS if k in batch]
    out = [(k, device_width(k, batch[k])) for k in keys]
    for key, ids, n_segments, item_rows in plans_of(batch):
        arrays, _, _ = plan_arrays(ids, n_segments, item_rows)
        out += [(f"{key}.{name}", arrays[name]) for name in PLAN_ARRAYS]
    return out


class BatchPacker:
    """Packs padded host batches into one int32 buffer and unpacks them
    into views (module docstring)."""

    def __init__(self):
        self.layout = None  # [(key, byte offset, nbytes, shape, numpy dtype)]
        # plan key -> (n_segments, n_partials, n_tree_slots, n_merges, n_nodes)
        self.plans: dict[str, tuple] = {}
        self.total = 0  # words
        self.version = 0  # bumped on re-freeze: captured steps capture again
        self._shapes = None  # {batch key: (shape, dtype)} the layout was frozen on
        self._counters: dict = {}  # (device, plan key) -> (arrivals, tree_arrivals)
        self._staging: dict = {}  # words -> [[pinned tensor, event or None]]
        self._lock = threading.Lock()

    # -- layout --
    def _shapes_of(self, batch):
        return {k: (np.shape(v), np.asarray(v).dtype) for k, v in batch.items()
                if k not in UNUSED_DEVICE_KEYS}

    def _freeze(self, batch, entries):
        layout, off = [], 0
        for key, arr in entries:
            layout.append((key, off, arr.nbytes, arr.shape, arr.dtype))
            off = (off + arr.nbytes + ALIGN - 1) // ALIGN * ALIGN
        plans = {}
        for key, ids, n_segments, item_rows in plans_of(batch):
            cap = plan_capacity(len(ids), n_segments, item_rows)
            plans[key] = (n_segments, cap.partials, cap.tree_slots, cap.merges, cap.nodes)
        self.layout, self.plans, self.total = layout, plans, off // 4
        self._shapes = self._shapes_of(batch)

    def pack(self, batch) -> np.ndarray:
        """The batch and its capacity plans in one int32 array of `total`
        words (thread-safe: the provider's prefetch threads pack)."""
        with spans.span("pack"):
            batch = with_edge_sort_metadata(batch)
            entries = _entries(batch)
            with self._lock:
                if self.layout is None:
                    self._freeze(batch, entries)
                elif self._shapes_of(batch) != self._shapes:
                    # the pad dims grew (a rare outlier batch): captured steps
                    # see the new version and capture again
                    self._freeze(batch, entries)
                    self.version += 1
                layout = self.layout
                total = self.total
            buf = np.zeros(total, np.int32)
            u8 = buf.view(np.uint8)
            for (key, arr), (lkey, off, nb, shape, dtype) in zip(entries, layout):
                if key != lkey or arr.shape != shape or arr.dtype != dtype:
                    raise ValueError(f"{key} {arr.shape} {arr.dtype} does not fit the layout's "
                                     f"{lkey} {shape} {dtype}")
                u8[off:off + nb] = np.ascontiguousarray(arr).view(np.uint8).ravel()
            return buf

    def zero_masks(self, row: np.ndarray) -> np.ndarray:
        """A copy of a packed row with mol_mask and atom_mask zeroed: a batch
        that adds nothing to any masked metric (trainer.py:119-133)."""
        if self.layout is None:
            raise RuntimeError("pack a batch first")
        out = np.array(row, copy=True)
        u8 = out.view(np.uint8)
        for key, off, nb, _, _ in self.layout:
            if key in MASK_KEYS:
                u8[off:off + nb] = 0
        return out

    # -- views --
    def unpack(self, words: torch.Tensor) -> dict:
        """One int32 buffer of `total` words (CPU or CUDA) -> the batch dict
        of `data.to_torch`, every tensor a view of `words`, the plans with
        this packer's static arrival counters on that device."""
        if self.layout is None:
            raise RuntimeError("pack a batch first")
        if words.dtype != torch.int32 or words.shape != (self.total,):
            raise ValueError(f"expected ({self.total},) int32 words, got {tuple(words.shape)} "
                             f"{words.dtype}")
        out, plans = {}, {}
        for key, off, nb, shape, dtype in self.layout:
            raw = words[off // 4:off // 4 + (nb + 3) // 4]
            tdt = _TORCH_DTYPE[np.dtype(dtype)]
            if tdt in (torch.bool, torch.int8):
                arr = raw.view(torch.uint8)[:nb].view(tdt)
            else:
                arr = raw.view(tdt)
            arr = arr.reshape(shape)
            if "." in key:
                plan, name = key.split(".")
                plans.setdefault(plan, {})[name] = arr
            else:
                out[key] = arr
        for key, arrays in plans.items():
            n_segments, n_partials, n_tree_slots, n_merges, n_nodes = self.plans[key]
            arrivals, tree_arrivals = self._counters_on(words.device, key, n_merges, n_nodes)
            out[key] = make_plan(arrays, n_segments, n_partials, n_tree_slots, arrivals,
                                 tree_arrivals)
        return out

    def _counters_on(self, device, key, n_merges, n_nodes):
        hit = self._counters.get((device, key))
        if hit is None or hit[0].numel() != n_merges or hit[1].numel() != n_nodes:
            hit = (torch.zeros(n_merges, dtype=torch.int32, device=device),
                   torch.zeros(n_nodes, dtype=torch.int32, device=device))
            self._counters[(device, key)] = hit
        return hit

    # -- transfer --
    def to_device(self, rows: np.ndarray, device, out: torch.Tensor | None = None) -> torch.Tensor:
        """Packed rows (one row, or a (K, total) stack) as an int32 tensor on
        `device`: on the CPU the array itself; on a CUDA device, through a
        pinned staging buffer in one non-blocking copy into `out` (or a new
        tensor). The wait for a staging buffer is the span `upload.wait`."""
        with spans.span("upload"):
            rows = np.ascontiguousarray(rows, dtype=np.int32)
            device = torch.device(device)
            if device.type != "cuda":
                src = torch.from_numpy(rows)
                return src if out is None else out.copy_(src)
            ring = self._staging.setdefault(rows.size, [])
            if len(ring) < STAGING_DEPTH:
                ring.append([torch.empty(rows.size, dtype=torch.int32, pin_memory=True), None])
            slot = ring.pop(0)
            ring.append(slot)
            staging, event = slot
            if event is not None:
                with spans.span("upload.wait"):
                    event.synchronize()  # its last copy has left the buffer
            np.copyto(staging.numpy(), rows.reshape(-1))
            if out is None:
                out = torch.empty(rows.shape, dtype=torch.int32, device=device)
            out.view(-1).copy_(staging, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(torch.cuda.current_stream(device))
            return out
