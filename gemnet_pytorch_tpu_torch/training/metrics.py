"""Metrics: sample-weighted running means, best-metric persistence (port of
`gemnet_pytorch_tpu/training/metrics.py`; reference gemnet/training/metrics.py).

TensorBoard stays optional: `make_writer` takes its SummaryWriter where it
imports, and the dependency-free JSONL writer otherwise.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np


class MeanMetric:
    """Sample-weighted running mean (reference metrics.py:66-79)."""

    def __init__(self):
        self.reset_states()

    def update_state(self, values, sample_weight):
        self.values += sample_weight * float(values)
        self.sample_weights += sample_weight

    def result(self) -> float:
        return self.values / self.sample_weights

    def reset_states(self):
        self.values = 0.0
        self.sample_weights = 0.0


class Metrics:
    """Per-tag dict of MeanMetrics (reference metrics.py:82-159)."""

    def __init__(self, tag: str, keys: list[str], writer=None):
        if "loss" not in keys:
            raise ValueError(f"metric keys {keys} lack 'loss'")
        self.tag = tag
        self.keys = keys
        self.writer = writer
        self.mean_metrics = {k: MeanMetric() for k in keys}

    def update_state(self, nsamples: int, **updates):
        unknown = set(updates) - set(self.keys)
        if unknown:
            raise KeyError(f"unknown metrics {unknown}")
        for key, val in updates.items():
            self.mean_metrics[key].update_state(np.asarray(val).mean(), nsamples)

    def write(self, writer, step: int):
        for key, val in self.result().items():
            writer.add_scalar(key, val, step)

    def reset_states(self):
        for m in self.mean_metrics.values():
            m.reset_states()

    def result(self, append_tag: bool = True) -> dict[str, float]:
        return {
            (f"{k}_{self.tag}" if append_tag else k): self.mean_metrics[k].result()
            for k in self.keys
        }

    @property
    def loss(self) -> float:
        return self.mean_metrics["loss"].result()


class BestMetrics:
    """Best-validation persistence to best_metrics.npz (reference metrics.py:6-63)."""

    def __init__(self, path: str, metrics: Metrics, assert_exist: bool = True):
        self.path = os.path.join(path, "best_metrics.npz")
        self.metrics = metrics
        self.assert_exist = assert_exist
        self.state: dict[str, float] = {}

    def initialize(self):
        self.state = {f"{k}_{self.metrics.tag}": np.inf for k in self.metrics.keys}
        self.state["step"] = 0
        np.savez(self.path, **self.state)

    def restore(self):
        if not os.path.isfile(self.path):
            msg = f"best metrics file missing: {self.path}"
            if self.assert_exist:
                raise FileNotFoundError(msg)
            logging.warning(msg + "; initializing fresh")
            self.initialize()
        else:
            with np.load(self.path) as data:
                self.state = {k: v.item() for k, v in data.items()}

    def items(self):
        return self.state.items()

    def update(self, step: int, metrics: Metrics):
        self.state["step"] = step
        self.state.update(metrics.result())
        np.savez(self.path, **self.state)

    def write(self, writer, step: int):
        for key, val in self.state.items():
            if key != "step":
                writer.add_scalar(key + "_best", val, step)

    @property
    def loss(self) -> float:
        return self.state[f"loss_{self.metrics.tag}"]

    @property
    def step(self) -> int:
        return int(self.state["step"])


def make_writer(log_dir: str, prefer_tensorboard: bool = True):
    """TensorBoard SummaryWriter when it imports (reference train_seml.py:191),
    else the dependency-free JSONL writer."""
    if prefer_tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the tensorboard package is not installed
            pass
        else:
            return SummaryWriter(log_dir)
    return JsonlWriter(os.path.join(log_dir, "metrics.jsonl"))


class JsonlWriter:
    """Minimal scalar writer: one JSON line per scalar (stands in for the
    reference's TensorBoard SummaryWriter; train_seml.py:191)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def add_scalar(self, key: str, value: float, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": int(step), key: float(value)}) + "\n")

    def close(self):
        pass
