"""Model configuration: the same `ModelConfig` fields and YAML loader as the
JAX package's `gemnet_pytorch_tpu/config.py`, kept as this package's own copy.

The defaults equal the model section of `config.yaml` (GemNet-Q at the
released widths). Knobs that only the JAX package serves (bf16 compute, the
split3 precision mode, edge partitioning, remat) stay as fields so one YAML
file configures both packages; `models.gemnet.GemNet` raises on the ones this
package does not run yet.
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
    bilinear_implementation: str = "auto"
    compute_dtype: str = "float32"
    matmul_precision: str = "default"
    ep_axis: Optional[str] = None
    ep_halo: bool = False
    remat_blocks: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
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

    PyYAML is imported here, not at module top: the serving path builds
    `ModelConfig()` from its defaults and must import on machines without it.
    """
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    return _literal_eval_strings(config)
