"""Learning-rate schedules and plateau decay (port of
`gemnet_pytorch_tpu/training/schedules.py`).

- `linear_warmup_exponential_decay`: the reference's LambdaLR schedule
  (gemnet/training/schedules.py:1-46): min(1/w + step/w, 1) · rate^(step/decay)
  with optional staircase, evaluated in fp32 on the step's device, so the
  optimizer reads it from its on-device step count without a host sync.
- `PlateauState`: host-side reduce-on-plateau state machine equivalent to the
  reference's custom ReduceLROnPlateau (trainer.py:523-717), which mutates the
  schedule's base LR; here it yields a multiplicative `lr_scale` fed into the
  train step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch


def linear_warmup_exponential_decay(
    warmup_steps: int, decay_steps: float, decay_rate: float, staircase: bool = False
):
    if decay_rate > 1:
        raise ValueError(f"decay_rate {decay_rate} > 1")
    if warmup_steps == 0:
        warmup_steps = 1

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warmup = torch.clamp(1.0 / warmup_steps + step / warmup_steps, max=1.0)
        exponent = step / decay_steps
        if staircase:
            exponent = torch.floor(exponent)
        return warmup * decay_rate**exponent

    return schedule


@dataclass
class PlateauState:
    """Reduce lr_scale by `factor` after `patience` bad evaluations, with
    cooldown (reference trainer.py:575-717; mode='min', threshold_mode='rel')."""

    factor: float = 0.5
    patience: int = 10
    cooldown: int = 0
    threshold: float = 1e-4
    mode: str = "min"
    threshold_mode: str = "rel"
    lr_scale: float = 1.0
    best: float = field(default=float("inf"))
    num_bad_steps: int = 0
    cooldown_counter: int = 0
    last_step: int = 0
    reduce_counter: int = 0

    def __post_init__(self):
        if self.factor >= 1.0:
            raise ValueError(f"factor {self.factor} must be < 1")
        if self.mode == "max" and self.best == float("inf"):
            self.best = -float("inf")

    def is_better(self, a: float, best: float) -> bool:
        if self.mode == "min" and self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        if self.mode == "min":
            return a < best - self.threshold
        if self.threshold_mode == "rel":
            return a > best * (1.0 + self.threshold)
        return a > best + self.threshold

    def step(self, metric: float) -> float:
        """Record one evaluation; returns the current lr_scale."""
        current = float(metric)
        self.last_step += 1
        if self.is_better(current, self.best):
            self.best = current
            self.num_bad_steps = 0
        else:
            self.num_bad_steps += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_steps = 0
        if self.num_bad_steps > self.patience:
            self.lr_scale *= self.factor
            self.reduce_counter += 1
            self.cooldown_counter = self.cooldown
            self.num_bad_steps = 0
        return self.lr_scale

    def state_dict(self) -> dict:
        return {
            k: getattr(self, k)
            for k in (
                "factor", "patience", "cooldown", "threshold", "mode",
                "threshold_mode", "lr_scale", "best", "num_bad_steps",
                "cooldown_counter", "last_step", "reduce_counter",
            )
        }

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)
