"""Training: the flat-buffer optimizer, schedules, metrics and the Trainer
(port of `gemnet_pytorch_tpu/training/`, flat mode, no MVE/AGC)."""
from .metrics import BestMetrics, JsonlWriter, MeanMetric, Metrics, make_writer  # noqa: F401
from .schedules import PlateauState, linear_warmup_exponential_decay  # noqa: F401
from .trainer import Trainer, TrainState  # noqa: F401
