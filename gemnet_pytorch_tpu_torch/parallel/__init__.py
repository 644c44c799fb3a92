"""Data parallelism, the edge partitions and the pipeline over
`torch.distributed` process groups (port of `gemnet_pytorch_tpu/parallel/`:
`mesh.py`, `dp.py`, `ep.py`, `halo.py`, `hybrid.py`, `pp.py`; the
collectives JAX's `shard_map` transposes itself are in `collectives.py`).
The tp mode is not ported yet."""
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

# the pipeline's names, imported at first use: `pp.py` builds on the model
# (`PipelineStage` is a GemNet), whose module imports this package
PP_NAMES = ("PipelineStage", "PPTrainer", "make_pp_apply", "make_pp_energy_and_forces",
            "make_pp_loss_and_grad", "merge_pp_state_dict", "split_pp_state_dict",
            "stack_microbatches")


def __getattr__(name):
    if name in PP_NAMES:
        from . import pp

        return getattr(pp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
