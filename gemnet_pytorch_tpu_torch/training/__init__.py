"""Training: the flat-buffer and per-tensor optimizers, schedules, metrics,
the Trainer (MVE, AGC), checkpoints and scaling-factor fitting (port of
`gemnet_pytorch_tpu/training/`)."""
from .metrics import BestMetrics, JsonlWriter, MeanMetric, Metrics, make_writer  # noqa: F401
from .schedules import PlateauState, linear_warmup_exponential_decay  # noqa: F401
from .trainer import Trainer, TrainState  # noqa: F401
from .checkpoint import (  # noqa: F401
    read_checkpoint, restore_checkpoint, restore_params, save_checkpoint, save_params,
)
from .fit_scaling import fit_scaling_factors  # noqa: F401
