"""Bilinear neighbour reduction (kernel K1) and its VJP (kernel K2).

Port of `gemnet_pytorch_tpu/ops/pallas/segment_outer.py`. For rows grouped
by sorted segment ids (triplets/quadruplets sorted by their reduce edge):

    segment_outer_sum:        out[s, e, m] = sum_{t: seg(t)=e} a[t, s] * b[t, m]
    segment_gather_contract:  da[t, s] = sum_m cot[s, seg(t), m] * b[t, m]
                              db[t, m] = sum_s cot[s, seg(t), m] * a[t, s]

The output layout is the JAX package's (S, nSegments, M). On a CUDA tensor
each op launches its hand-written kernel (`csrc/segment_outer.cu`); on a CPU
tensor it runs the plain PyTorch version below, a line-for-line counterpart
of `_outer_sum_xla` / `_gather_contract_xla`. fp32 only: other dtypes raise.

`plan` is the `data.batch.SegmentPlan` of the sorted ids (work items of the
kernels); the plain versions use `seg_ids`. The two ops are
`torch.autograd.Function`s whose backwards call each other, so they
differentiate to any order (grad-of-grad for force training), as the JAX
custom VJPs do.
"""

from __future__ import annotations

import torch

from . import _cuda


def _outer_sum_plain(a, b, seg_ids, n_segments):
    outer = (a.float()[:, :, None] * b.float()[:, None, :]).reshape(a.shape[0], -1)
    out = outer.new_zeros((n_segments, outer.shape[1])).index_add(0, seg_ids.long(), outer)
    return out.reshape(n_segments, a.shape[1], b.shape[1]).permute(1, 0, 2).contiguous()


def _gather_contract_plain(cot, a, b, seg_ids):
    cot_rows = cot[:, seg_ids.long(), :]  # (S, N, M)
    da = torch.einsum("stm,tm->ts", cot_rows, b.to(cot.dtype))
    db = torch.einsum("stm,ts->tm", cot_rows, a.to(cot.dtype))
    return da.to(a.dtype), db.to(b.dtype)


def _check_float32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: only float32 is supported")


def _outer_sum_cuda(a, b, plan):
    dev = a.device
    _cuda.check_tensor(a, "a", torch.float32, dev)
    _cuda.check_tensor(b, "b", torch.float32, dev)
    _cuda.check_plan(plan, dev)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    if b.shape[0] != n:
        raise ValueError(f"a has {n} rows, b has {b.shape[0]}")
    if _cuda.function("gemnet_segment_outer_sum_threads")(S, M) == 0:
        raise ValueError(f"segment_outer_sum kernel takes no S={S}, M={M}")
    if _cuda.function("gemnet_segment_outer_sum_smem")(S, M) > 48 * 1024:
        raise ValueError(f"segment_outer_sum kernel: S={S}, M={M} exceed 48 KB of shared memory")
    out = torch.empty((S, n_seg, M), dtype=torch.float32, device=dev)
    partial = torch.empty((plan.n_partials, S, M), dtype=torch.float32, device=dev)
    _cuda.launch("gemnet_segment_outer_sum_f32", (n, S, M, n_seg), dev,
                 a.data_ptr(), b.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                 plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                 partial.data_ptr(), out.data_ptr(), n_seg, S, M)
    return out


def _gather_contract_cuda(cot, a, b, plan):
    dev = a.device
    for name, t in (("cot", cot), ("a", a), ("b", b)):
        _cuda.check_tensor(t, name, torch.float32, dev)
    _cuda.check_plan(plan, dev)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    if b.shape[0] != n or tuple(cot.shape) != (S, n_seg, M):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, cot {tuple(cot.shape)}")
    if _cuda.function("gemnet_segment_gather_contract_smem")(S, M) > 48 * 1024:
        raise ValueError(f"segment_gather_contract kernel: S={S}, M={M} exceed 48 KB of shared memory")
    da = torch.empty((n, S), dtype=torch.float32, device=dev)
    db = torch.empty((n, M), dtype=torch.float32, device=dev)
    _cuda.launch("gemnet_segment_gather_contract_f32", (n, S, M, n_seg), dev,
                 cot.data_ptr(), a.data_ptr(), b.data_ptr(), plan.items.data_ptr(),
                 plan.items.shape[0], da.data_ptr(), db.data_ptr(), n_seg, S, M)
    return da, db


def outer_sum(a, b, seg_ids, plan):
    """K1 without autograd: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    _check_float32(a=a, b=b)
    if a.device.type == "cuda":
        return _outer_sum_cuda(a, b, plan)
    if a.device.type == "cpu":
        return _outer_sum_plain(a, b, seg_ids, plan.n_segments)
    raise ValueError(f"no segment_outer_sum for device {a.device}")


def gather_contract(cot, a, b, seg_ids, plan):
    """K2 without autograd: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    _check_float32(cot=cot, a=a, b=b)
    if a.device.type == "cuda":
        return _gather_contract_cuda(cot, a, b, plan)
    if a.device.type == "cpu":
        return _gather_contract_plain(cot, a, b, seg_ids)
    raise ValueError(f"no segment_gather_contract for device {a.device}")


class SegmentOuterSum(torch.autograd.Function):
    """K1; its backward is K2 (segment_outer.py:649-661)."""

    @staticmethod
    def forward(ctx, a, b, seg_ids, plan):
        ctx.save_for_backward(a, b, seg_ids)
        ctx.plan = plan
        return outer_sum(a, b, seg_ids, plan)

    @staticmethod
    def backward(ctx, cot):
        a, b, seg_ids = ctx.saved_tensors
        da, db = SegmentGatherContract.apply(cot.contiguous(), a, b, seg_ids, ctx.plan)
        return da, db, None, None


class SegmentGatherContract(torch.autograd.Function):
    """K2; its backward is K1 twice and K2 once (segment_outer.py:677-696)."""

    @staticmethod
    def forward(ctx, cot, a, b, seg_ids, plan):
        ctx.save_for_backward(cot, a, b, seg_ids)
        ctx.plan = plan
        return gather_contract(cot, a, b, seg_ids, plan)

    @staticmethod
    def backward(ctx, ua, ub):
        cot, a, b, seg_ids = ctx.saved_tensors
        plan = ctx.plan
        ua, ub = ua.contiguous(), ub.contiguous()
        dcot = (SegmentOuterSum.apply(ua, b, seg_ids, plan)
                + SegmentOuterSum.apply(a, ub, seg_ids, plan))
        da, db = SegmentGatherContract.apply(cot, ua, ub, seg_ids, plan)
        return dcot, da, db, None, None


def segment_outer_sum(a, b, seg_ids, plan):
    """out[s, e, m] = sum_{t: seg_ids[t]==e} a[t,s]*b[t,m]; seg_ids sorted,
    plan their SegmentPlan. Returns (S, nSegments, M) fp32."""
    return SegmentOuterSum.apply(a, b, seg_ids, plan)


def segment_gather_contract(cot, a, b, seg_ids, plan):
    """(da, db): da[t,s]=sum_m cot[s,seg,m]*b[t,m]; db[t,m]=sum_s cot[s,seg,m]*a[t,s]."""
    return SegmentGatherContract.apply(cot, a, b, seg_ids, plan)
