"""Process groups: the counterpart of the JAX package's device mesh
(`gemnet_pytorch_tpu/parallel/mesh.py`).

JAX builds one `Mesh` over every device a process sees and names its axis
("dp", "ep"). PyTorch runs one process per device: `initialize_distributed`
joins this process to its peers and returns the process group, and the
group is what the JAX package's axis name is everywhere in `parallel/`:
`rank(group)` is this process's index on the axis (the shard it owns, JAX's
`jax.lax.axis_index`) and `world_size(group)` the axis' size.

The backend follows the device: NCCL for "cuda", gloo for "cpu". gloo on
"cuda" only when the caller names it: a machine with one card cannot run
two NCCL ranks on it, so its multi-rank runs put the model's compute on the
card and send the collectives through the host (`collectives.py` stages
them). A group that fails to start raises; no backend is chosen because
another failed.

`make_hybrid_mesh` cuts a group into the rows and columns of a 2-D mesh,
JAX's ("dp", "ep") mesh of `parallel/hybrid.py` and ("dp", "pp") mesh of
`parallel/pp.py`: each rank holds the sub-group of its row (the ep or pp
axis) and of its column (the dp axis).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# every group's collective timeout: a rank that raises leaves its peers
# waiting in a collective, and they raise after this long
TIMEOUT = datetime.timedelta(seconds=300)
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def default_backend(device) -> str:
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    return BACKENDS[device.type]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None, *, device="cuda",
                           timeout: datetime.timedelta = TIMEOUT):
    """Join the default process group and return it.

    With `coordinator` ("host:port" of process 0, or a store's URL such as
    "file:///dir/store" for processes of one machine), `num_processes` and
    `process_id` (train.py's multi-host flags) the group meets there;
    without them it reads torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). `backend` defaults to the device's
    (`default_backend`); "gloo" with a CUDA device is for several ranks
    sharing one card. `timeout` bounds every collective of the group. On a
    CUDA device the process takes card LOCAL_RANK (0 without torchrun) and,
    on NCCL, one all-reduce runs at once, so the communicator starts
    outside any CUDA graph capture."""
    device = torch.device(device)
    backend = backend or default_backend(device)
    if dist.is_initialized():
        raise RuntimeError("the default process group is already initialized")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", device.index or 0)))
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    group = dist.group.WORLD
    if backend == "nccl":
        warm = torch.ones(1, device=local_device(device))
        dist.all_reduce(warm, group=group)
        torch.cuda.synchronize()
    return group


class HybridMesh(NamedTuple):
    """A 2-D mesh of process groups (`make_hybrid_mesh`), from one rank's
    side: the groups it belongs to and its place in the (n_dp, n_ep) grid."""

    world: object  # all n_dp * n_ep ranks (the parent group)
    dp: object     # this rank's column: the n_dp ranks of its ep index
    ep: object     # this rank's row: the n_ep ranks of its dp index
    dp_index: int
    ep_index: int
    n_dp: int
    n_ep: int

    # the row axis under its pipeline name: on a dp x pp mesh each row is a
    # pipeline of n_pp stages (`parallel/pp.py`)
    @property
    def pp(self):
        return self.ep

    @property
    def pp_index(self) -> int:
        return self.ep_index

    @property
    def n_pp(self) -> int:
        return self.n_ep


def make_hybrid_mesh(n_dp: int, n_ep: int, group=None, *,
                     timeout: datetime.timedelta = TIMEOUT) -> HybridMesh:
    """The dp and ep sub-groups of `group` (default: the world group), whose
    rank r = dp_index * n_ep + ep_index sits at (dp_index, ep_index): JAX's
    `devices.reshape(n_dp, n_ep)` (`gemnet_pytorch_tpu/parallel/hybrid.py:
    34-40`). Every rank creates every sub-group, in one order (as
    `torch.distributed.new_group` requires), with `group`'s backend and
    `timeout`. On NCCL each of the rank's two groups runs one all-reduce
    here, so its communicator starts outside any CUDA graph capture. A 1x1
    mesh at world size 1 is a mesh like any other."""
    parent = dist.group.WORLD if group is None else group
    if world_size(parent) != n_dp * n_ep:
        raise ValueError(f"a {n_dp}x{n_ep} mesh needs {n_dp * n_ep} ranks, the group has "
                         f"{world_size(parent)}")
    ranks = dist.get_process_group_ranks(parent)  # global ranks, in group-rank order
    kind = backend(parent)
    me = rank(parent)
    dp_index, ep_index = divmod(me, n_ep)
    mine = {}
    for e in range(n_ep):  # the columns: one ep index, every dp index
        members = [ranks[d * n_ep + e] for d in range(n_dp)]
        g = dist.new_group(members, timeout=timeout, backend=kind)
        if e == ep_index:
            mine["dp"] = g
    for d in range(n_dp):  # the rows: one dp index, every ep index
        members = [ranks[d * n_ep + e] for e in range(n_ep)]
        g = dist.new_group(members, timeout=timeout, backend=kind)
        if d == dp_index:
            mine["ep"] = g
    if kind == "nccl":
        for name in ("dp", "ep"):
            warm = torch.ones(1, device=local_device("cuda"))
            dist.all_reduce(warm, group=mine[name])
        torch.cuda.synchronize()
    return HybridMesh(parent, mine["dp"], mine["ep"], dp_index, ep_index, n_dp, n_ep)


def agree_max(value, group):
    """The field-wise max of every rank's `value`, a dataclass of ints, in
    one all-reduce: the static sizes ranks must share (halo pads, pad dims)
    where each rank sized its own batches."""
    names = [f.name for f in dataclasses.fields(value)]
    device = local_device("cuda") if backend(group) == "nccl" else torch.device("cpu")
    t = torch.tensor([getattr(value, n) for n in names], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return dataclasses.replace(value, **dict(zip(names, t.tolist())))


def local_device(device) -> torch.device:
    """`device` with the card this process took (cuda:LOCAL_RANK)."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def rank(group) -> int:
    """This process's index on the group's axis (the shard it owns)."""
    return dist.get_rank(group)


def world_size(group) -> int:
    return dist.get_world_size(group)


def backend(group) -> str:
    return str(dist.get_backend(group)).lower()


def capturable(group) -> bool:
    """Whether a step whose collectives run on `group` can be captured
    into a CUDA graph: NCCL's collectives are kernels on the card's
    streams; gloo's run on the host, which a graph cannot replay."""
    return group is None or backend(group) == "nccl"


def is_main(group) -> bool:
    """Rank 0, or no group: the process that logs and writes checkpoints."""
    return group is None or rank(group) == 0
