"""Model and training configuration: the same `ModelConfig` and
`TrainConfig` fields and YAML loader as the JAX package's
`gemnet_pytorch_tpu/config.py`, kept as this package's own copy.

The defaults equal `config.yaml` (GemNet-Q at the released widths and the
reference's training hyperparameters). Knobs that only the JAX package serves
(edge partitioning) stay as fields so one YAML file configures both
packages; `models.gemnet.GemNet` raises on the ones this package does not run
yet. JAX's `bilinear_implementation` is not one of them: here the tensor's
device picks the kernels or their plain versions, and `from_dict` drops the
key from a YAML file that sets it.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the GemNet model (reference gemnet.py:82-113)."""

    num_spherical: int = 7
    num_radial: int = 6
    num_blocks: int = 4
    emb_size_atom: int = 128
    emb_size_edge: int = 128
    emb_size_trip: int = 64
    emb_size_quad: int = 32
    emb_size_rbf: int = 16
    emb_size_cbf: int = 16
    emb_size_sbf: int = 32
    emb_size_bil_quad: int = 32
    emb_size_bil_trip: int = 64
    num_before_skip: int = 1
    num_after_skip: int = 1
    num_concat: int = 1
    num_atom: int = 2
    triplets_only: bool = False
    num_targets: int = 1
    direct_forces: bool = False
    cutoff: float = 5.0
    int_cutoff: float = 10.0
    envelope_exponent: int = 5
    extensive: bool = True
    forces_coupled: bool = False
    output_init: str = "HeOrthogonal"
    activation: str = "swish"
    scale_file: Optional[str] = None
    # execution knobs of the JAX package; see the module docstring
    compute_dtype: str = "float32"
    matmul_precision: str = "default"
    ep_axis: Optional[str] = None
    ep_halo: bool = False
    remat_blocks: bool = False
    # the bases, by OCP's names (ocpmodels/models/gemnet/layers/
    # radial_basis.py, spherical_basis.py): rbf "gaussian" with cbf
    # "spherical_harmonics" is OCP's GemNet-T, its direct-force head
    # included, the defaults "bessel" and "bessel" TUM's; no other pair
    # runs. The envelope is the polynomial one of `envelope_exponent`
    rbf: str = "bessel"
    cbf: str = "bessel"
    # the edges a target atom keeps, nearest first (OCP's max_neighbors;
    # periodic systems only)
    max_neighbors: Optional[int] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """The fields of `d` that name one; OCP's basis dicts ({"name": ...})
        as the name, and its envelope ({"name": "polynomial", "exponent":
        p}) as `envelope_exponent`."""
        names = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        for key in ("rbf", "cbf", "envelope"):
            if isinstance(d.get(key), dict):
                spec = dict(d.pop(key))
                name = spec.pop("name")
                if key == "envelope":
                    if name != "polynomial":
                        raise ValueError(f"envelope {name!r}: the port has 'polynomial'")
                    d["envelope_exponent"] = spec.pop("exponent", d.get("envelope_exponent", 5))
                else:
                    d[key] = name
                if spec:
                    raise ValueError(f"{key}: unsupported parameters {sorted(spec)}")
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (reference trainer.py:48-101, train_seml.py:43-98)."""

    learning_rate: float = 1e-3
    decay_steps: float = 4_500_000
    decay_rate: float = 0.01
    warmup_steps: int = 3750
    weight_decay: float = 2e-6
    staircase: bool = False
    grad_clip_max: float = 10.0
    decay_patience: int = 5
    decay_factor: float = 0.5
    decay_cooldown: int = 5
    ema_decay: float = 0.999
    rho_force: float = 0.999
    loss: str = "rmse"  # "mae" | "rmse" (force loss; energy always MAE)
    # OCP's loss (ocpmodels/trainers/forces_trainer.py): energy_coefficient ·
    # MAE(E) + force_coefficient · the force loss, in place of rho_force's
    # weights where both are set; OCP's `loss_force` "l2mae" is `loss` "rmse"
    energy_coefficient: Optional[float] = None
    force_coefficient: Optional[float] = None
    mve: bool = False
    agc: bool = False
    # AGC's reference-parity selection (training/tree_opt.py) and the
    # optimizer's layout: the flat buffer, or per tensor (always with AGC)
    agc_compat_reference: bool = False
    flat_optimizer: bool = True
    batch_size: int = 32
    num_steps: int = 1_500_000
    evaluation_interval: int = 7500
    save_interval: int = 7500
    patience: int = 5
    tfseed: int = 1234
    data_seed: int = 42
    logdir: str = "logs"
    dataset: Optional[str] = None
    val_dataset: Optional[str] = None
    num_train: int = 0
    num_val: int = 0
    comment: str = "GemNet"
    restart: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        """The fields of `d` that name one; OCP's `loss_energy` (MAE only)
        and `loss_force` ("l2mae" or "mae") as `loss`."""
        names = {f.name for f in dataclasses.fields(cls)}
        d = dict(d)
        if d.get("loss_energy", "mae") != "mae":
            raise ValueError(f"loss_energy {d['loss_energy']!r}: only 'mae'")
        if "loss_force" in d:
            d["loss"] = {"l2mae": "rmse", "mae": "mae"}[d["loss_force"]]
        return cls(**{k: v for k, v in d.items() if k in names})


def _literal_eval_strings(config: dict) -> dict:
    """Mirror the reference's ast.literal_eval pass for 'None'-ish strings
    (reference fit_scaling.py:170-179)."""
    out = dict(config)
    for key, val in out.items():
        if isinstance(val, str):
            try:
                out[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                pass
    return out


def load_yaml_config(path: str) -> dict[str, Any]:
    """Load a reference-format flat YAML config into a plain dict.

    PyYAML is imported here, not at module top: the serving and training
    paths build `ModelConfig()` and `TrainConfig()` from their defaults and
    must import on machines without it.
    """
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    return _literal_eval_strings(config)
