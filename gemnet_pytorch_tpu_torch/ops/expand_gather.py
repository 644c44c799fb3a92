"""Expand gather with a sorted-reduction VJP, and the sorted segment sum
(kernel K3).

Port of `gemnet_pytorch_tpu/ops/pallas/expand_gather.py`.
`expand_gather(table, idx, perm, sorted_ids, plan)` computes `table[idx]`,
carrying the host-computed sort metadata of `idx` (`perm` = stable argsort of
idx, `sorted_ids` = idx[perm], `plan` their `data.batch.SegmentPlan`), so its
VJP is the sorted segment sum

    out[e, m] = sum_{t: sorted_ids[t] = e} x[perm[t], m]

which on a CUDA tensor runs the hand-written kernel of
`csrc/expand_gather.cu` with the permute fused in, and on a CPU tensor the
plain version below (the counterpart of `_segsum_xla` after `x[perm]`). Every
sorted segment sum on a CUDA tensor goes through the kernel, at any row count
and width. The segment sum's own VJP is `expand_gather` again, so the pair
differentiates to any order.

Dtypes follow the JAX package (`_segsum_xla`, `_segsum_pallas`): fp32 rows
give fp32 sums; bf16 rows (compute_dtype="bfloat16") are summed in fp32 and
rounded once to bf16. The geometry streams of the force path stay fp32 in
both modes. fp32 and bf16 are the only dtypes taken: any other raises.
"""

from __future__ import annotations

import torch

from . import _cuda


def _segsum_plain(xp, sorted_ids, n_segments):
    # fp32 sums; bf16 rows round the output at the end (expand_gather.py:61-68)
    out = xp.new_zeros((n_segments, xp.shape[1]), dtype=torch.float32)
    return out.index_add(0, sorted_ids.long(), xp.float()).to(xp.dtype)


def _segsum_cuda(x, perm, plan):
    dev, dt = x.device, x.dtype
    _cuda.check_tensor(x, "x", dt, dev)
    _cuda.check_tensor(perm, "perm", torch.int32, dev)
    _cuda.check_plan(plan, dev)
    n, M = x.shape
    if perm.shape != (n,):
        raise ValueError(f"perm {tuple(perm.shape)} for {n} rows")
    n_seg = plan.n_segments
    out = torch.empty((n_seg, M), dtype=dt, device=dev)
    partial = torch.empty((plan.n_partials, M), dtype=torch.float32, device=dev)
    _cuda.launch(f"gemnet_sorted_segsum_{_cuda.DTYPE_SUFFIX[dt]}", (n, M, n_seg), dev,
                 x.data_ptr(), perm.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                 plan.merge_ptr.data_ptr(), plan.merge_seg.numel(), plan.arrivals.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), M)
    return out


def sorted_segsum_values(x, perm, sorted_ids, plan):
    """K3 without autograd: sum of the rows of x grouped by idx, through the
    sorted order, in x's dtype. The kernel on a CUDA tensor, the plain
    version on CPU."""
    if x.dtype not in _cuda.DTYPE_SUFFIX:
        raise TypeError(f"x is {x.dtype}: only float32 and bfloat16 are supported")
    if x.device.type == "cuda":
        return _segsum_cuda(x, perm, plan)
    if x.device.type == "cpu":
        return _segsum_plain(x[perm.long()], sorted_ids, plan.n_segments)
    raise ValueError(f"no sorted segment sum for device {x.device}")


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
    """table[idx] with a sorted-segment-sum VJP. idx int64; perm and
    sorted_ids int32 with sorted_ids == idx[perm] ascending; plan their
    SegmentPlan over table's rows."""
    return ExpandGather.apply(table, idx, perm, sorted_ids, plan)


def sorted_segsum(x, perm, sorted_ids, plan, idx):
    """(n_src, M) sums of the rows of x grouped by idx."""
    return SortedSegsum.apply(x, perm, sorted_ids, plan, idx)
