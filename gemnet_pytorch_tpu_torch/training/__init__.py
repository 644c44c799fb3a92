"""Training: the flat-buffer optimizer, schedules, metrics, the Trainer and
checkpoints (port of `gemnet_pytorch_tpu/training/`, flat mode, no MVE/AGC)."""
from .metrics import BestMetrics, JsonlWriter, MeanMetric, Metrics, make_writer  # noqa: F401
from .schedules import PlateauState, linear_warmup_exponential_decay  # noqa: F401
from .trainer import Trainer, TrainState  # noqa: F401
from .checkpoint import (  # noqa: F401
    restore_checkpoint, restore_params, save_checkpoint, save_params,
)
