"""Collectives with exact transposes: the counterparts of `jax.lax.psum`
and `jax.lax.all_to_all` inside the JAX package's `shard_map`s.

JAX differentiates a sharded program itself: `check_vma=True` tracks which
values vary over the mesh axis and transposes every collective. Here each
rank's autograd sees only its own graph, so every collective that carries a
gradient is a `torch.autograd.Function` whose backward is the collective's
transpose, built from the same Functions, so that `create_graph=True`
differentiates it again (the train step differentiates twice: its force
loss backpropagates through -dE/dR):

- `psum` (all-reduce, sum): its transpose is `psum`. Over the ranks'
  unrolled program, an all-reduced value y = sum_s x_s feeds every rank,
  so x_s's cotangent is the sum of every rank's cotangent of y;
- `all_to_all` (block j of rank r goes to rank j, block r): the reverse
  exchange is the same all-to-all, so it is its own transpose;
- `shift` (rank s sends to s+1 and receives from s-1, rank 0 receives
  zeros: `jax.lax.ppermute(x, axis, [(i, i + 1)])`): y_{s+1} = x_s, so x_s's
  cotangent is y_{s+1}'s, and the last rank's x feeds nothing (zero). That
  is the shift in the other direction (rank s sends to s-1, the last rank
  receives zeros): its transpose is the reverse shift, whose transpose is
  the shift again.

A replicated scalar that every rank differentiates (the halo loss, the
energy sum of -dE/dR) is seeded with 1/P on each of the P ranks: the ranks'
backwards then compute the gradient of the one objective sum_r (1/P) L_r =
L, whose tied copies (replicated inputs, parameters) add up to the
single-device gradient (`parallel/halo.py`).

`all_reduce_` is the plain in-place sum for values nothing differentiates
(gradients, mask counts), `broadcast_` copies one rank's tensor to all,
and `all_gather` stacks every rank's tensor.
Every collective issued on a group is counted in `CALLS`, by kind and
backend, and its tensor's bytes in `BYTES` (a captured step's are issued
at its capture); inside `recorded()` each is also appended to a list, in
the order issued, with its shape, so ranks can compare their sequences.

The ranks must issue their collectives in one order. The forward's order
is the program's; a backward's is the autograd engine's, which runs ready
nodes by sequence number: the same on every rank, as every rank builds the
same graph from the same history.

On a gloo group a CUDA tensor is staged through pinned host memory, by
design: gloo is the host backend of the one-card runs, its collectives run
on CPU tensors. gloo takes no bf16: it is summed in fp32 and exchanged as
raw bytes. An NCCL group takes the tensors where they are, and its
collectives are kernels a CUDA graph captures. `group=None` is a group of
one: every collective is the identity. A shift is point to point: one
`batch_isend_irecv` a call, every send and receive of the call in it, so
no pair of ranks waits on the other's order; over one rank it issues
nothing.
"""

from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

from . import mesh

# collectives issued, by (kind, backend), and the bytes of the tensors
# they were issued on
CALLS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()


# the collectives issued inside `recorded()`, in order: (kind, backend, shapes)
_RECORD: list | None = None


def _count(kind: str, group, *ts: torch.Tensor) -> None:
    key = (kind, mesh.backend(group))
    CALLS[key] += 1
    BYTES[key] += sum(t.numel() * t.element_size() for t in ts)
    if _RECORD is not None:
        _RECORD.append((*key, tuple(tuple(t.shape) for t in ts)))


@contextlib.contextmanager
def recorded():
    """Yield a list that collects every collective issued in the block, in
    order, as (kind, backend, shapes of its tensors)."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        if outer is not None:
            outer.extend(_RECORD)
        _RECORD = outer


def _gloo(group) -> bool:
    return mesh.backend(group) == "gloo"


def _host_copy(t: torch.Tensor, dtype=None) -> torch.Tensor:
    """`t` on the host in `dtype` (a pinned copy of a CUDA tensor)."""
    host = torch.empty(t.shape, dtype=dtype or t.dtype, pin_memory=t.is_cuda)
    host.copy_(t)
    return host


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the group in place (no gradient); returns `t`."""
    if group is None:
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce_ needs a contiguous tensor")
    _count("all_reduce", group, t)
    if _gloo(group) and (t.is_cuda or t.dtype == torch.bfloat16):
        host = _host_copy(t, torch.float32 if t.dtype == torch.bfloat16 else None)
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Overwrite `t` with that of the group's rank `src` in place (no
    gradient); returns `t`."""
    if group is None:
        return t
    if not t.is_contiguous():
        raise ValueError("broadcast_ needs a contiguous tensor")
    _count("broadcast", group, t)
    src = dist.get_global_rank(group, src)  # torch.distributed names the source globally
    if _gloo(group) and (t.is_cuda or t.dtype == torch.bfloat16):
        host = _host_copy(t, torch.float32 if t.dtype == torch.bfloat16 else None)
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(P, ...) blocks: block j of this rank goes to rank j, which holds it
    as block `rank` of its output."""
    x = x.contiguous()
    if group is None:
        return x.clone()
    if x.shape[0] != mesh.world_size(group):
        raise ValueError(f"all_to_all of {x.shape[0]} blocks over {mesh.world_size(group)} "
                         "ranks")
    _count("all_to_all", group, x)
    if not _gloo(group):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out
    # gloo moves 4- and 8-byte words; a bf16 block goes as its bytes
    raw = x.dtype not in (torch.float32, torch.float64, torch.int32, torch.int64)
    src = x.view(torch.uint8) if raw else x
    host = _host_copy(src) if x.is_cuda else src
    out = torch.empty_like(host)
    dist.all_to_all_single(out, host, group=group)
    out = out.to(x.device)
    return out.view(x.dtype) if raw else out


def _shift(xs, group, reverse: bool) -> tuple:
    """Each of `xs` from rank s to rank s+1 (s-1 when `reverse`), zeros on
    the rank with no sender; one `batch_isend_irecv` for the whole tuple."""
    xs = [x.contiguous() for x in xs]
    n = mesh.world_size(group)
    _count("shift", group, *xs)
    me = mesh.rank(group)
    step = -1 if reverse else 1
    dst, src = me + step, me - step
    gloo = _gloo(group)
    outs = [torch.zeros_like(x) for x in xs]
    ops, received = [], []
    for x, out in zip(xs, outs):
        buf = out
        if gloo:  # host tensors of 4- or 8-byte words; a bf16 tensor as its bytes
            raw = x.dtype not in (torch.float32, torch.float64, torch.int32, torch.int64)
            x = x.view(torch.uint8) if raw else x
            x = _host_copy(x) if x.is_cuda else x
            if raw or out.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=out.is_cuda)
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, x, group=group, group_peer=dst))
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, buf, group=group, group_peer=src))
            received.append((out, buf))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for out, buf in received:
        if buf is not out:
            out.copy_(buf.view(out.dtype))
    return tuple(outs)


class Shift(torch.autograd.Function):
    """The neighbour shift of a tuple of tensors (rank s to s+1, or s to s-1
    with `reverse`); backward: the shift in the other direction of the
    cotangents."""

    @staticmethod
    def forward(ctx, group, reverse, *xs):
        ctx.group, ctx.reverse = group, reverse
        return _shift(xs, group, reverse)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *Shift.apply(ctx.group, not ctx.reverse, *gs))


class Psum(torch.autograd.Function):
    """All-reduce (sum); backward: Psum of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return Psum.apply(g, ctx.group), None


class AllToAll(torch.autograd.Function):
    """All-to-all over the leading (P, ...) block axis; backward: the same
    all-to-all of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return AllToAll.apply(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the group (`jax.lax.psum`)."""
    return x if group is None else Psum.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all over x's leading axis of P blocks
    (`jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0)`)."""
    return x if group is None else AllToAll.apply(x, group)


def shift(xs, group) -> tuple:
    """Differentiable neighbour shift of the tuple `xs`: rank s's tensors go
    to rank s+1, rank 0 receives zeros, the last rank's go nowhere
    (`jax.lax.ppermute(x, axis, [(i, i + 1) for i in range(P - 1)])`). With
    `group=None`, or over one rank, the identity: no collective."""
    if group is None or mesh.world_size(group) == 1:
        return tuple(xs)
    return Shift.apply(group, False, *xs)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(P, *x.shape): every rank's `x`, in rank order (no gradient)."""
    if group is None:
        return x[None]
    x = x.contiguous()
    _count("all_gather", group, x)
    staged = _gloo(group) and x.is_cuda
    src = _host_copy(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(mesh.world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out
