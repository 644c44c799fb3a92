"""Expand gather with a sorted-reduction VJP, and the sorted segment sum
(kernel K3).

Port of `gemnet_pytorch_tpu/ops/pallas/expand_gather.py`.
`expand_gather(table, idx, perm, sorted_ids, plan)` computes `table[idx]`,
carrying the host-computed sort metadata of `idx` (`perm` = stable argsort of
idx, or None where idx is ascending already, `sorted_ids` = idx[perm], `plan`
their `data.batch.SegmentPlan`), so its VJP is the sorted segment sum

    out[e, m] = sum_{t: sorted_ids[t] = e} x[perm[t], m]

which on a CUDA tensor runs the hand-written kernel of
`csrc/expand_gather.cu` with the permute fused in, and on a CPU tensor the
plain version below (the counterpart of `_segsum_xla` after `x[perm]`). Every
sorted segment sum on a CUDA tensor goes through the kernel, at any row count
and width. The segment sum's own VJP is `expand_gather` again, so the pair
differentiates to any order.

`gather(table, idx, sort)` is the model's gather of rows: the expand gather
where the batch carries the sort metadata of `idx` (`data.batch.gather_sorts`
reads it from the table `SORTED_GATHERS`), a plain gather (whose VJP is
`index_put_`'s serial runs over equal indices) where it does not, as on a
halo or ep shard. `swap_rows(x, id_swap)` is the gather by an involution,
whose VJP is the same gather, on every path. Each call counts its route in
the counters `gather.sorted` (K3's VJP, or the swap's) and `gather.plain`
(`perf.spans.count`), once per Python run of the site: per eager step, and
once per capture of a CUDA graph.

Dtypes follow the JAX package (`_segsum_xla`, `_segsum_pallas`): fp32 rows
give fp32 sums; bf16 rows (compute_dtype="bfloat16") are summed in fp32 and
rounded once to bf16. The geometry streams of the force path stay fp32 in
both modes. fp32 and bf16 are the only dtypes taken: any other raises.
"""

from __future__ import annotations

import torch

from ..perf import spans
from . import _cuda


def _segsum_plain(xp, sorted_ids, n_segments):
    # fp32 sums; bf16 rows round the output at the end (expand_gather.py:61-68)
    out = xp.new_zeros((n_segments, xp.shape[1]), dtype=torch.float32)
    return out.index_add(0, sorted_ids.long(), xp.float()).to(xp.dtype)


def _segsum_cuda(x, perm, plan):
    dev, dt = x.device, x.dtype
    _cuda.check_tensor(x, "x", dt, dev)
    _cuda.check_plan(plan, dev)
    n, M = x.shape
    if perm is not None:
        _cuda.check_tensor(perm, "perm", torch.int32, dev)
        if perm.shape != (n,):
            raise ValueError(f"perm {tuple(perm.shape)} for {n} rows")
    n_seg = plan.n_segments
    out = torch.empty((n_seg, M), dtype=dt, device=dev)
    partial = torch.empty((plan.n_partials, M), dtype=torch.float32, device=dev)
    _cuda.launch(f"gemnet_sorted_segsum_{_cuda.DTYPE_SUFFIX[dt]}", (n, M, n_seg), dev,
                 x.data_ptr(), 0 if perm is None else perm.data_ptr(),
                 plan.items.data_ptr(), plan.items.shape[0],
                 plan.merge_ptr.data_ptr(), plan.merge_seg.numel(), plan.arrivals.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), M)
    return out


def sorted_segsum_values(x, perm, sorted_ids, plan):
    """K3 without autograd: sum of the rows of x grouped by idx, through the
    sorted order (perm None: x's own order), in x's dtype. The kernel on a
    CUDA tensor, the plain version on the CPU (`_cuda.use_kernel`); the
    census counts the card's launch on either."""
    if x.dtype not in _cuda.DTYPE_SUFFIX:
        raise TypeError(f"x is {x.dtype}: only float32 and bfloat16 are supported")
    suffix = _cuda.DTYPE_SUFFIX[x.dtype]
    kernel = _cuda.use_kernel(x.device)
    _cuda.note_kernel("K3", "backward", suffix, f"gemnet_sorted_segsum_{suffix}",
                      (x.shape[0], x.shape[1], plan.n_segments))
    if kernel:
        return _segsum_cuda(x, perm, plan)
    xp = x if perm is None else x[perm.long()]
    return _segsum_plain(xp, sorted_ids, plan.n_segments)


class ExpandGather(torch.autograd.Function):
    """table[idx]; backward: the sorted segment sum (expand_gather.py:199-215)."""

    @staticmethod
    def forward(ctx, table, idx, perm, sorted_ids, plan):
        if plan.n_segments != table.shape[0]:
            raise ValueError(
                f"sort metadata covers {plan.n_segments} rows, table has {table.shape[0]}")
        ctx.save_for_backward(idx, perm, sorted_ids)
        ctx.plan = plan
        return table[idx]

    @staticmethod
    def backward(ctx, cot):
        idx, perm, sorted_ids = ctx.saved_tensors
        d_table = SortedSegsum.apply(cot.contiguous(), perm, sorted_ids, ctx.plan, idx)
        return d_table.to(cot.dtype), None, None, None, None


class SortedSegsum(torch.autograd.Function):
    """Sum of x rows grouped by idx (the VJP of ExpandGather); backward:
    ExpandGather again (expand_gather.py:255-271)."""

    @staticmethod
    def forward(ctx, x, perm, sorted_ids, plan, idx):
        ctx.save_for_backward(idx, perm, sorted_ids)
        ctx.plan = plan
        # the cotangent of x must carry x's dtype (the JAX package keeps a
        # zero-size sentinel residual for this)
        ctx.x_dtype = x.dtype
        return sorted_segsum_values(x, perm, sorted_ids, plan)

    @staticmethod
    def backward(ctx, g):
        idx, perm, sorted_ids = ctx.saved_tensors
        dx = ExpandGather.apply(g.to(ctx.x_dtype), idx, perm, sorted_ids, ctx.plan)
        return dx, None, None, None, None


def expand_gather(table, idx, perm, sorted_ids, plan):
    """table[idx] with a sorted-segment-sum VJP. idx int64; perm int32 (or
    None: idx ascending) and sorted_ids with sorted_ids == idx[perm]
    ascending (int32; idx itself where perm is None); plan their
    SegmentPlan over table's rows."""
    return ExpandGather.apply(table, idx, perm, sorted_ids, plan)


def sorted_segsum(x, perm, sorted_ids, plan, idx):
    """(n_src, M) sums of the rows of x grouped by idx."""
    return SortedSegsum.apply(x, perm, sorted_ids, plan, idx)


def gather(table, idx, sort=None):
    """table[idx]: the sorted expand gather, whose VJP is K3, where `sort`
    (perm, sorted ids, plan: `data.batch.gather_sorts`) is given; a plain
    gather where it is None."""
    if sort is None:
        spans.count("gather.plain")
        return table[idx]
    spans.count("gather.sorted")
    return expand_gather(table, idx, *sort)


class SwapRows(torch.autograd.Function):
    """x[swap] for an involution `swap` (swap[swap] is the identity): a
    permutation's VJP is its inverse, here the same gather, so the backward
    sums nothing and every order of derivative is exact."""

    @staticmethod
    def forward(ctx, x, swap):
        ctx.save_for_backward(swap)
        return x[swap]

    @staticmethod
    def backward(ctx, g):
        (swap,) = ctx.saved_tensors
        return SwapRows.apply(g, swap), None


def swap_rows(x, id_swap):
    """x[id_swap] for the reverse edges' rows, through `SwapRows`: every
    id_swap the port builds is an involution (`data.graph`; a halo shard's
    j +- half on real rows and j on padded ones; an ep shard's global one)."""
    spans.count("gather.sorted")
    return SwapRows.apply(x, id_swap)
