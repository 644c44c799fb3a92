"""Data parallelism and the halo edge partition over `torch.distributed`
process groups (port of `gemnet_pytorch_tpu/parallel/`: `mesh.py`, `dp.py`,
`halo.py`; the collectives JAX's `shard_map` transposes itself are in
`collectives.py`). The hybrid, ep, pp and tp modes are not ported yet."""
from .mesh import initialize_distributed, rank, world_size  # noqa: F401
from .dp import (  # noqa: F401
    make_dp_eval_step,
    make_dp_predict_fn,
    make_dp_train_step,
    shard_batch_to_mesh,
    stack_shards,
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
