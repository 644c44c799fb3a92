"""Bilinear neighbour reduction (kernel K1) and its VJP (kernel K2).

Port of `gemnet_pytorch_tpu/ops/pallas/segment_outer.py`. For rows grouped
by sorted segment ids (triplets/quadruplets sorted by their reduce edge):

    segment_outer_sum:        out[s, e, m] = sum_{t: seg(t)=e} a[t, s] * b[t, m]
    segment_gather_contract:  da[t, s] = sum_m cot[s, seg(t), m] * b[t, m]
                              db[t, m] = sum_s cot[s, seg(t), m] * a[t, s]

The output layout is the JAX package's (S, nSegments, M). On a CUDA tensor
each op launches its hand-written kernel (`csrc/segment_outer.cu`); on a CPU
tensor it runs the plain PyTorch version below, a line-for-line counterpart
of `_outer_sum_xla` / `_gather_contract_xla`. `implementation` (the JAX
package's `bilinear_implementation`) holds that choice to one side: "xla"
the plain versions, raising on a CUDA tensor, "pallas" the kernels, raising
on a CPU tensor (`_cuda.use_kernel`); it rides on `ctx` into every backward. The K1 kernels read the
plan's work items and merge a split segment's partial tiles through its
merge tree (`tree_nodes`, `tree_parent`, `tree_arrivals`), K1's general
kernel at narrow widths through `merge_ptr` / `merge_seg`; the K2 kernel
reads each row's segment id from `seg_ids` (its warp kernel, at S <= 16)
or the plan's work items (its quad-shape kernels); K4 as K1 and K2 (at
the triplet shape its forward is K1's warp kernel with split3 products and
its backward a warp per work item too).

Dtypes follow the JAX package (`_stream_dtype`, `_out_dtype`): the streams
are bf16 when every row input is bf16 (compute_dtype="bfloat16"), and fp32
otherwise, a bf16 operand of a mixed pair being cast up explicitly. Sums are
fp32 always; K1's output is bf16 for bf16 streams, K2's da/db carry the
dtypes of a/b, and the bf16 K2 kernel reads the cotangent as bf16 (the
Pallas kernel's cast). fp32 and bf16 are the only dtypes taken: any other
raises.

`precision` is "exact" or "split3". "split3" is the JAX package's manual
3-pass fp32 mode (segment_outer.py:160-202, ModelConfig.matmul_precision=
"high"): every fp32 value is split into a bf16 hi half (its fp32 bits with
the low 16 masked off, exact in bf16) and a bf16 lo half (x - hi rounded to
nearest even), and each contraction runs as hi*hi + hi*lo + lo*hi with fp32
products and fp32 sums, about 16 mantissa bits. On a CUDA tensor it launches
the kernels `gemnet_segment_*_split3` (tensor cores, or FFMAs on the CUDA
cores at the triplet shape, each bf16 product exact in fp32); on a CPU
tensor it runs the plain split3 versions below. As in `_use_split3`, it applies to fp32
streams only: bf16 streams ignore it.

`plan` is the `data.batch.SegmentPlan` of the sorted ids (work items of the
kernels, and the merge tree through which the forward adds a long
segment's partial tiles); the plain versions use `seg_ids`. The two ops are
`torch.autograd.Function`s whose backwards call each other, so they
differentiate to any order (grad-of-grad for force training), as the JAX
custom VJPs do; each returns its gradients in the dtypes of its inputs. The
precision rides on `ctx` into every backward, so the -dE/dR backward and the
loss's grad-of-grad run split3 wherever the forward did (JAX's process-wide
flag does the same).
"""

from __future__ import annotations

import torch

from . import _cuda

PRECISIONS = ("exact", "split3")


def _use_split3(precision: str, sdt: torch.dtype) -> bool:
    """split3 runs on fp32 streams only (segment_outer.py:182-183)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return precision == "split3" and sdt == torch.float32


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


def _split_hi_lo(x):
    """fp32 -> (bf16 hi, bf16 lo), bit for bit as segment_outer.py:186-202:
    hi is x's fp32 bits masked with 0xFFFF0000 (exact in bf16), lo is
    bf16(x - hi) rounded to nearest even. hi is not bf16(x): a rounded hi
    would make lo the wrong residual."""
    xf = x.float()
    hi32 = (xf.view(torch.int32) & -65536).view(torch.float32)
    return hi32.to(torch.bfloat16), (xf - hi32).to(torch.bfloat16)


def _outer_sum_split3_plain(a, b, seg_ids, n_segments):
    """K1 in split3: three products of bf16 halves (exact in fp32), fp32 sums."""
    ah, al = _split_hi_lo(a)
    bh, bl = _split_hi_lo(b)
    return sum(_outer_sum_plain(x.float(), y.float(), seg_ids, n_segments)
               for x, y in ((ah, bh), (ah, bl), (al, bh)))


def _gather_contract_split3_plain(cot, a, b, seg_ids):
    """K2 in split3: da from cot x b and db from cot x a, each as the three
    products hi*hi + hi*lo + lo*hi (segment_outer.py:499-513)."""
    ch, cl = _split_hi_lo(cot)
    ah, al = _split_hi_lo(a)
    bh, bl = _split_hi_lo(b)
    da = db = 0
    # (ch, ah, bh) -> ch.bh and ch.ah; (ch, al, bl) -> ch.bl and ch.al;
    # (cl, ah, bh) -> cl.bh and cl.ah
    for c, x, y in ((ch, ah, bh), (ch, al, bl), (cl, ah, bh)):
        dx, dy = _gather_contract_plain(c.float(), x.float(), y.float(), seg_ids)
        da, db = da + dx, db + dy
    return da.to(a.dtype), db.to(b.dtype)


def _outer_sum_cuda(a, b, plan, split3=False):
    dev, dt = a.device, a.dtype
    _cuda.check_tensor(a, "a", dt, dev)
    _cuda.check_tensor(b, "b", dt, dev)
    _cuda.check_plan(plan, dev)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    if b.shape[0] != n:
        raise ValueError(f"a has {n} rows, b has {b.shape[0]}")
    if split3:
        if _cuda.function("gemnet_segment_outer_sum_split3_smem")(S, M) == 0:
            raise ValueError(f"segment_outer_sum split3 kernel takes no S={S}, M={M}")
        name = "gemnet_segment_outer_sum_split3"
    else:
        # every shape the kernels for the model's shapes take, the general
        # kernel takes too: its limits are the entry's
        if _cuda.function("gemnet_segment_outer_sum_threads")(S, M) == 0:
            raise ValueError(f"segment_outer_sum kernel takes no S={S}, M={M}")
        if _cuda.function("gemnet_segment_outer_sum_smem")(S, M) > 48 * 1024:
            raise ValueError(f"segment_outer_sum kernel: S={S}, M={M} exceed 48 KB of shared "
                             "memory")
        name = f"gemnet_segment_outer_sum_{_cuda.DTYPE_SUFFIX[dt]}"
    out = torch.empty((S, n_seg, M), dtype=dt, device=dev)
    # fp32 partial tiles of the items and of the merge tree's inner nodes
    # (the general kernels use the items' first n_partials)
    partial = torch.empty((plan.n_tree_slots, S, M), dtype=torch.float32, device=dev)
    _cuda.launch(name, (n, S, M, n_seg), dev,
                 a.data_ptr(), b.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                 plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                 plan.tree_nodes.data_ptr(), plan.tree_parent.data_ptr(),
                 plan.tree_arrivals.data_ptr(), partial.data_ptr(), out.data_ptr(), n, n_seg, S, M)
    return out


def _gather_contract_cuda(cot, a, b, seg_ids, plan, split3=False):
    dev, dt = a.device, a.dtype
    for name, t in (("cot", cot), ("a", a), ("b", b)):
        _cuda.check_tensor(t, name, dt, dev)
    _cuda.check_plan(plan, dev)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    if b.shape[0] != n or tuple(cot.shape) != (S, n_seg, M):
        raise ValueError(f"shapes a {tuple(a.shape)}, b {tuple(b.shape)}, cot {tuple(cot.shape)}")
    da = torch.empty((n, S), dtype=dt, device=dev)
    db = torch.empty((n, M), dtype=dt, device=dev)
    if split3:
        if _cuda.function("gemnet_segment_gather_contract_split3_smem")(S, M) == 0:
            raise ValueError(f"segment_gather_contract split3 kernel takes no S={S}, M={M}")
        _cuda.launch("gemnet_segment_gather_contract_split3", (n, S, M, n_seg), dev,
                     cot.data_ptr(), a.data_ptr(), b.data_ptr(), plan.items.data_ptr(),
                     plan.items.shape[0], da.data_ptr(), db.data_ptr(), n, n_seg, S, M)
        return da, db
    if _cuda.function("gemnet_segment_gather_contract_smem")(S, M) > 227 * 1024:
        raise ValueError(f"segment_gather_contract kernel: S={S}, M={M} exceed the 227 KB of "
                         "shared memory a block may take")
    # the warp kernel (S <= 16) reads each row's segment id: the sorted ids,
    # int64 as the batch holds them
    seg = seg_ids.to(torch.int64)
    _cuda.check_tensor(seg, "seg_ids", torch.int64, dev)
    if seg.shape != (n,):
        raise ValueError(f"seg_ids {tuple(seg.shape)} for {n} rows")
    _cuda.launch(f"gemnet_segment_gather_contract_{_cuda.DTYPE_SUFFIX[dt]}", (n, S, M, n_seg),
                 dev, cot.data_ptr(), a.data_ptr(), b.data_ptr(), seg.data_ptr(),
                 plan.items.data_ptr(), plan.items.shape[0], da.data_ptr(), db.data_ptr(), n,
                 n_seg, S, M)
    return da, db


def _note(op, a, b, plan, split3, sdt):
    """Note a call of kernel `op` ("outer_sum" or "gather_contract") in the
    open kernel censuses, under the C entry it launches on a CUDA tensor."""
    mode = "split3" if split3 else _cuda.DTYPE_SUFFIX[sdt]
    kernel = "K4" if split3 else {"outer_sum": "K1", "gather_contract": "K2"}[op]
    _cuda.note_kernel(kernel, "forward" if op == "outer_sum" else "backward", mode,
                      f"gemnet_segment_{op}_{mode}",
                      (a.shape[0], a.shape[1], b.shape[1], plan.n_segments))


def outer_sum(a, b, seg_ids, plan, precision="exact", implementation="auto"):
    """K1 without autograd: the kernel or the plain version, as
    `_cuda.use_kernel(implementation, device)` says (by default the kernel
    on a CUDA tensor, the plain version on a CPU tensor). Returns
    (S, nSegments, M) in the streams' dtype."""
    sdt = _stream_dtype(a, b)
    split3 = _use_split3(precision, sdt)
    if _cuda.use_kernel(implementation, a.device):
        _note("outer_sum", a, b, plan, split3, sdt)
        # mixed dtypes: the fp32 streams are staged explicitly, as the JAX
        # wrapper's astype does
        return _outer_sum_cuda(a.to(sdt), b.to(sdt), plan, split3)
    if implementation == "auto":  # a CPU tensor: the census counts the card's launch
        _note("outer_sum", a, b, plan, split3, sdt)
    if split3:
        return _outer_sum_split3_plain(a, b, seg_ids, plan.n_segments)
    return _outer_sum_plain(a, b, seg_ids, plan.n_segments)


def gather_contract(cot, a, b, seg_ids, plan, precision="exact", implementation="auto"):
    """K2 without autograd: the kernel or the plain version, as `outer_sum`
    chooses. Returns (da, db) in the dtypes of (a, b)."""
    sdt = _stream_dtype(a, b)  # a and b alone pick the streams
    _stream_dtype(cot)  # raises on a cotangent neither fp32 nor bf16
    split3 = _use_split3(precision, sdt)
    if _cuda.use_kernel(implementation, a.device):
        _note("gather_contract", a, b, plan, split3, sdt)
        # bf16 streams read the cotangent as bf16 (segment_outer.py:586-590);
        # fp32 streams stage every operand as fp32
        da, db = _gather_contract_cuda(cot.to(sdt), a.to(sdt), b.to(sdt), seg_ids, plan, split3)
        return da.to(a.dtype), db.to(b.dtype)
    if implementation == "auto":
        _note("gather_contract", a, b, plan, split3, sdt)
    if split3:
        return _gather_contract_split3_plain(cot, a, b, seg_ids)
    return _gather_contract_plain(cot, a, b, seg_ids)


class SegmentOuterSum(torch.autograd.Function):
    """K1; its backward is K2 (segment_outer.py:649-661)."""

    @staticmethod
    def forward(ctx, a, b, seg_ids, plan, precision, implementation):
        ctx.save_for_backward(a, b, seg_ids)
        ctx.modes = plan, precision, implementation
        return outer_sum(a, b, seg_ids, plan, precision, implementation)

    @staticmethod
    def backward(ctx, cot):
        a, b, seg_ids = ctx.saved_tensors
        da, db = SegmentGatherContract.apply(cot.contiguous(), a, b, seg_ids, *ctx.modes)
        return da, db, None, None, None, None


class SegmentGatherContract(torch.autograd.Function):
    """K2; its backward is K1 twice and K2 once (segment_outer.py:677-696)."""

    @staticmethod
    def forward(ctx, cot, a, b, seg_ids, plan, precision, implementation):
        ctx.save_for_backward(cot, a, b, seg_ids)
        ctx.modes = plan, precision, implementation
        return gather_contract(cot, a, b, seg_ids, plan, precision, implementation)

    @staticmethod
    def backward(ctx, ua, ub):
        cot, a, b, seg_ids = ctx.saved_tensors
        modes = ctx.modes
        ua, ub = ua.contiguous(), ub.contiguous()
        dcot = (SegmentOuterSum.apply(ua, b, seg_ids, *modes)
                + SegmentOuterSum.apply(a, ub, seg_ids, *modes))
        da, db = SegmentGatherContract.apply(cot, ua, ub, seg_ids, *modes)
        # cotangents in the primal dtypes (segment_outer.py:627-628)
        return dcot.to(cot.dtype), da.to(a.dtype), db.to(b.dtype), None, None, None, None


def segment_outer_sum(a, b, seg_ids, plan, precision="exact", implementation="auto"):
    """out[s, e, m] = sum_{t: seg_ids[t]==e} a[t,s]*b[t,m]; seg_ids sorted,
    plan their SegmentPlan, precision "exact" or "split3", implementation
    "auto", "pallas" or "xla" (`_cuda.use_kernel`). Returns (S, nSegments,
    M), bf16 for bf16 a and b, fp32 otherwise."""
    return SegmentOuterSum.apply(a, b, seg_ids, plan, precision, implementation)


def segment_gather_contract(cot, a, b, seg_ids, plan, precision="exact", implementation="auto"):
    """(da, db): da[t,s]=sum_m cot[s,seg,m]*b[t,m]; db[t,m]=sum_s cot[s,seg,m]*a[t,s]."""
    return SegmentGatherContract.apply(cot, a, b, seg_ids, plan, precision, implementation)
