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
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

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
