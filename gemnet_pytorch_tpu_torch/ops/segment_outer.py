"""Bilinear neighbour reduction (kernel K1) and its VJP (kernel K2).

Port of `gemnet_pytorch_tpu/ops/pallas/segment_outer.py`. For rows grouped
by sorted segment ids (triplets/quadruplets sorted by their reduce edge):

    segment_outer_sum:        out[s, e, m] = sum_{t: seg(t)=e} a[t, s] * b[t, m]
    segment_gather_contract:  da[t, s] = sum_m cot[s, seg(t), m] * b[t, m]
                              db[t, m] = sum_s cot[s, seg(t), m] * a[t, s]

The output layout is the JAX package's (S, nSegments, M). On a CUDA tensor
each op launches its hand-written kernel (`csrc/segment_outer.cu`); on a CPU
tensor it runs the plain PyTorch version below, a line-for-line counterpart
of `_outer_sum_xla` / `_gather_contract_xla`.

Dtypes follow the JAX package (`_stream_dtype`, `_out_dtype`): the streams
are bf16 when every row input is bf16 (compute_dtype="bfloat16"), and fp32
otherwise, a bf16 operand of a mixed pair being cast up explicitly. Sums are
fp32 always; K1's output is bf16 for bf16 streams, K2's da/db carry the
dtypes of a/b, and the bf16 K2 kernel reads the cotangent as bf16 (the
Pallas kernel's cast). fp32 and bf16 are the only dtypes taken: any other
raises.

`plan` is the `data.batch.SegmentPlan` of the sorted ids (work items of the
kernels); the plain versions use `seg_ids`. The two ops are
`torch.autograd.Function`s whose backwards call each other, so they
differentiate to any order (grad-of-grad for force training), as the JAX
custom VJPs do; each returns its gradients in the dtypes of its inputs.
"""

from __future__ import annotations

import torch

from . import _cuda


def _stream_dtype(*tensors) -> torch.dtype:
    """bf16 iff every row input is bf16, else fp32 (segment_outer.py:152-157);
    raises on a dtype that is neither."""
    for t in tensors:
        if t.dtype not in _cuda.DTYPE_SUFFIX:
            raise TypeError(f"{t.dtype} input: only float32 and bfloat16 are supported")
    if all(t.dtype == torch.bfloat16 for t in tensors):
        return torch.bfloat16
    return torch.float32


def _outer_sum_plain(a, b, seg_ids, n_segments):
    # fp32 products and sums whatever the input dtype; the output in the
    # streams' dtype, as _outer_sum_xla (segment_outer.py:264-273)
    outer = (a.float()[:, :, None] * b.float()[:, None, :]).reshape(a.shape[0], -1)
    out = outer.new_zeros((n_segments, outer.shape[1])).index_add(0, seg_ids.long(), outer)
    out = out.reshape(n_segments, a.shape[1], b.shape[1]).permute(1, 0, 2).contiguous()
    return out.to(_stream_dtype(a, b))


def _gather_contract_plain(cot, a, b, seg_ids):
    cot_rows = cot[:, seg_ids.long(), :]  # (S, N, M)
    da = torch.einsum("stm,tm->ts", cot_rows, b.to(cot.dtype))
    db = torch.einsum("stm,ts->tm", cot_rows, a.to(cot.dtype))
    return da.to(a.dtype), db.to(b.dtype)


def _outer_sum_cuda(a, b, plan):
    dev, dt = a.device, a.dtype
    _cuda.check_tensor(a, "a", dt, dev)
    _cuda.check_tensor(b, "b", dt, dev)
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
    out = torch.empty((S, n_seg, M), dtype=dt, device=dev)
    partial = torch.empty((plan.n_partials, S, M), dtype=torch.float32, device=dev)
    _cuda.launch(f"gemnet_segment_outer_sum_{_cuda.DTYPE_SUFFIX[dt]}", (n, S, M, n_seg), dev,
                 a.data_ptr(), b.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                 plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                 partial.data_ptr(), out.data_ptr(), n_seg, S, M)
    return out


def _gather_contract_cuda(cot, a, b, plan):
    dev, dt = a.device, a.dtype
    for name, t in (("cot", cot), ("a", a), ("b", b)):
        _cuda.check_tensor(t, name, dt, dev)
    _cuda.check_plan(plan, dev)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    if b.shape[0] != n or tuple(cot.shape) != (S, n_seg, M):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, cot {tuple(cot.shape)}")
    if _cuda.function("gemnet_segment_gather_contract_smem")(S, M) > 48 * 1024:
        raise ValueError(f"segment_gather_contract kernel: S={S}, M={M} exceed 48 KB of shared memory")
    da = torch.empty((n, S), dtype=dt, device=dev)
    db = torch.empty((n, M), dtype=dt, device=dev)
    _cuda.launch(f"gemnet_segment_gather_contract_{_cuda.DTYPE_SUFFIX[dt]}", (n, S, M, n_seg),
                 dev, cot.data_ptr(), a.data_ptr(), b.data_ptr(), plan.items.data_ptr(),
                 plan.items.shape[0], da.data_ptr(), db.data_ptr(), n_seg, S, M)
    return da, db


def outer_sum(a, b, seg_ids, plan):
    """K1 without autograd: the kernel on a CUDA tensor, the plain version
    on a CPU tensor. Returns (S, nSegments, M) in the streams' dtype."""
    sdt = _stream_dtype(a, b)
    if a.device.type == "cuda":
        # mixed dtypes: the fp32 streams are staged explicitly, as the JAX
        # wrapper's astype does
        return _outer_sum_cuda(a.to(sdt), b.to(sdt), plan)
    if a.device.type == "cpu":
        return _outer_sum_plain(a, b, seg_ids, plan.n_segments)
    raise ValueError(f"no segment_outer_sum for device {a.device}")


def gather_contract(cot, a, b, seg_ids, plan):
    """K2 without autograd: the kernel on a CUDA tensor, the plain version
    on a CPU tensor. Returns (da, db) in the dtypes of (a, b)."""
    sdt = _stream_dtype(a, b)  # a and b alone pick the streams
    _stream_dtype(cot)  # raises on a cotangent neither fp32 nor bf16
    if a.device.type == "cuda":
        # bf16 streams read the cotangent as bf16 (segment_outer.py:586-590);
        # fp32 streams stage every operand as fp32
        da, db = _gather_contract_cuda(cot.to(sdt), a.to(sdt), b.to(sdt), plan)
        return da.to(a.dtype), db.to(b.dtype)
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
        # cotangents in the primal dtypes (segment_outer.py:627-628)
        return dcot.to(cot.dtype), da.to(a.dtype), db.to(b.dtype), None, None


def segment_outer_sum(a, b, seg_ids, plan):
    """out[s, e, m] = sum_{t: seg_ids[t]==e} a[t,s]*b[t,m]; seg_ids sorted,
    plan their SegmentPlan. Returns (S, nSegments, M), bf16 for bf16 a and b,
    fp32 otherwise."""
    return SegmentOuterSum.apply(a, b, seg_ids, plan)


def segment_gather_contract(cot, a, b, seg_ids, plan):
    """(da, db): da[t,s]=sum_m cot[s,seg,m]*b[t,m]; db[t,m]=sum_s cot[s,seg,m]*a[t,s]."""
    return SegmentGatherContract.apply(cot, a, b, seg_ids, plan)
