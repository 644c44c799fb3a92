"""Data parallelism and the edge partitions over `torch.distributed`
process groups (port of `gemnet_pytorch_tpu/parallel/`: `mesh.py`, `dp.py`,
`ep.py`, `halo.py`, `hybrid.py`; the collectives JAX's `shard_map`
transposes itself are in `collectives.py`). The pp and tp modes are not
ported yet."""
from .mesh import (  # noqa: F401
    HybridMesh,
    initialize_distributed,
    make_hybrid_mesh,
    rank,
    world_size,
)
from .dp import (  # noqa: F401
    make_dp_eval_step,
    make_dp_predict_fn,
    make_dp_train_step,
    shard_batch_to_mesh,
    stack_shards,
)
from .ep import (  # noqa: F401
    ep_model,
    local_ep_batch,
    make_ep_apply,
    make_ep_loss_and_grad,
    make_ep_train_step,
    make_model_ep,
    partition_batch,
    shard_ep_batch,
)
from .halo import (  # noqa: F401
    HaloPads,
    build_halo_partition,
    estimate_halo_pads,
    halo_model,
    local_halo_batch,
    make_halo_apply,
    make_halo_eval_step,
    make_halo_loss_and_grad,
    make_halo_train_step,
    shard_halo_batch,
)
from .hybrid import (  # noqa: F401
    build_dp_halo_batch,
    build_hybrid_batch,
    local_dp_halo_batch,
    local_hybrid_batch,
    make_dp_halo_eval_step,
    make_dp_halo_loss_and_grad,
    make_dp_halo_train_step,
    make_hybrid_loss_and_grad,
    shard_dp_halo_batch,
    shard_hybrid_batch,
)
