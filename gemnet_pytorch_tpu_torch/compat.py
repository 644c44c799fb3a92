"""Weight interchange with the JAX package and the reference.

This package's parameter names ARE the reference state-dict schema (less
the reference's `.linear.` and `seq_energy` aliases), so a reference
checkpoint loads with `load_state_dict` once `strip_reference_aliases` has
dropped those. `state_dict_from_jax` carries the JAX package's flax
variables over: its own copy of the map between flax paths and reference
names (`gemnet_pytorch_tpu/compat/torch_import.py`, `torch_export.py`),
with flax Dense kernels (in, out) transposed to torch (out, in) and the 3-D
efficient weights kept as they are. `export_reference_state_dict` goes the
other way, from a model of this package to the reference's full key set
(port of `torch_export.py:118-172`).
"""

from __future__ import annotations

import re
from typing import Iterator, Tuple

import numpy as np
import torch

from .config import ModelConfig

# (reference module path of a scaling factor, global name)
_SCALES = (
    ("int_blocks.{b}.trip_interaction.scale_rbf", "TripInteraction_{i}_had_rbf"),
    ("int_blocks.{b}.trip_interaction.scale_cbf_sum", "TripInteraction_{i}_sum_cbf"),
    ("int_blocks.{b}.atom_update.scale_sum", "AtomUpdate_{i}_sum"),
)
_SCALES_QUAD = (
    ("int_blocks.{b}.quad_interaction.scale_rbf", "QuadInteraction_{i}_had_rbf"),
    ("int_blocks.{b}.quad_interaction.scale_cbf", "QuadInteraction_{i}_had_cbf"),
    ("int_blocks.{b}.quad_interaction.scale_sbf_sum", "QuadInteraction_{i}_sum_sbf"),
)


def canonical_weights(cfg: ModelConfig) -> Iterator[Tuple[str, bool]]:
    """Yield (reference parameter name, is a Dense kernel) for every weight
    of the model `cfg` describes (torch_export.py:41-101, without aliases)."""
    yield "rbf_basis.frequencies", False
    if not cfg.triplets_only:
        yield "mlp_rbf4.weight", True
        yield "mlp_cbf4.weight", True
        yield "mlp_sbf4.weight", False
    yield "mlp_rbf3.weight", True
    yield "mlp_cbf3.weight", False
    yield "mlp_rbf_h.weight", True
    yield "mlp_rbf_out.weight", True
    yield "atom_emb.embeddings.weight", False
    yield "edge_emb.dense.weight", True

    def residual_stack(prefix: str, n: int):
        for j in range(n):
            for k in (0, 1):
                yield f"{prefix}.{j}.dense_mlp.{k}.weight", True

    def atom_mlp(prefix: str):
        yield f"{prefix}.0.weight", True
        for j in range(1, cfg.num_atom + 1):
            for k in (0, 1):
                yield f"{prefix}.{j}.dense_mlp.{k}.weight", True

    for b in range(cfg.num_blocks):
        p = f"int_blocks.{b}"
        yield f"{p}.dense_ca.weight", True
        if not cfg.triplets_only:
            q = f"{p}.quad_interaction"
            for layer in ("dense_db", "mlp_rbf", "mlp_cbf", "down_projection",
                          "up_projection_ca", "up_projection_ac"):
                yield f"{q}.{layer}.weight", True
            yield f"{q}.mlp_sbf.weight", False
        t = f"{p}.trip_interaction"
        for layer in ("dense_ba", "mlp_rbf", "down_projection",
                      "up_projection_ca", "up_projection_ac"):
            yield f"{t}.{layer}.weight", True
        yield f"{t}.mlp_cbf.weight", False  # the triplet bilinear is the 3-D weight
        yield from residual_stack(f"{p}.layers_before_skip", cfg.num_before_skip)
        yield from residual_stack(f"{p}.layers_after_skip", cfg.num_after_skip)
        yield f"{p}.atom_update.dense_rbf.weight", True
        yield from atom_mlp(f"{p}.atom_update.layers")
        yield f"{p}.concat_layer.dense.weight", True
        yield from residual_stack(f"{p}.residual_m", cfg.num_concat)

    for b in range(cfg.num_blocks + 1):
        p = f"out_blocks.{b}"
        yield f"{p}.dense_rbf.weight", True
        yield from atom_mlp(f"{p}.layers")
        yield f"{p}.out_energy.weight", True
        if cfg.direct_forces:
            yield from atom_mlp(f"{p}.seq_forces")
            yield f"{p}.out_forces.weight", True


def flax_path(name: str) -> tuple[str, ...]:
    """Flax parameter path of a reference parameter name
    (torch_import.py:44-138, for the names `canonical_weights` yields)."""
    if name == "rbf_basis.frequencies":
        return ("frequencies",)
    if name == "atom_emb.embeddings.weight":
        return ("atom_emb", "embeddings")
    dense = ("Dense_0", "kernel")
    if name == "edge_emb.dense.weight":
        return ("edge_emb", "dense") + dense
    m = re.fullmatch(r"mlp_(rbf4|cbf4|rbf3|rbf_h|rbf_out)\.weight", name)
    if m:
        return (f"mlp_{m.group(1)}",) + dense
    m = re.fullmatch(r"mlp_(sbf4|cbf3)\.weight", name)
    if m:
        return (f"mlp_{m.group(1)}", "weight")

    def atom_mlp(base, stack, first, rest):
        if rest == f"{stack}.0.weight":
            return base + (first,) + dense
        mm = re.fullmatch(rf"{stack}\.(\d+)\.dense_mlp\.(\d+)\.weight", rest)
        if mm:
            pre = "force_res" if stack == "seq_forces" else "res"
            return base + (f"{pre}_{int(mm.group(1)) - 1}", f"dense_{mm.group(2)}") + dense
        return None

    m = re.fullmatch(r"int_blocks\.(\d+)\.(.*)", name)
    if m:
        base, rest = (f"int_blocks_{m.group(1)}",), m.group(2)
        if rest == "dense_ca.weight":
            return base + ("dense_ca",) + dense
        mm = re.fullmatch(r"(quad|trip)_interaction\.(\w+)\.weight", rest)
        if mm:
            kind, layer = mm.groups()
            sub = base + (f"{kind}_interaction", layer)
            if layer == "mlp_sbf" or (kind == "trip" and layer == "mlp_cbf"):
                return sub + ("weight",)  # 3-D bilinear weight
            return sub + dense
        mm = re.fullmatch(
            r"(layers_before_skip|layers_after_skip|residual_m)\.(\d+)\.dense_mlp\.(\d+)\.weight",
            rest)
        if mm:
            stack = {"layers_before_skip": "res_bef_skip", "layers_after_skip": "res_aft_skip",
                     "residual_m": "res_m"}[mm.group(1)]
            return base + (f"{stack}_{mm.group(2)}", f"dense_{mm.group(3)}") + dense
        if rest == "atom_update.dense_rbf.weight":
            return base + ("atom_update", "dense_rbf") + dense
        if rest.startswith("atom_update.layers."):
            path = atom_mlp(base + ("atom_update",), "layers", "dense_0", rest[len("atom_update."):])
            if path:
                return path
        if rest == "concat_layer.dense.weight":
            return base + ("concat_layer", "dense") + dense
    m = re.fullmatch(r"out_blocks\.(\d+)\.(.*)", name)
    if m:
        base, rest = (f"out_blocks_{m.group(1)}",), m.group(2)
        if rest in ("dense_rbf.weight", "out_energy.weight", "out_forces.weight"):
            return base + (rest.split(".")[0],) + dense
        path = (atom_mlp(base, "layers", "dense_0", rest)
                or atom_mlp(base, "seq_forces", "force_dense_0", rest))
        if path:
            return path
    raise KeyError(f"unmapped reference parameter: {name}")


def scale_state_names(cfg: ModelConfig) -> Iterator[Tuple[str, str]]:
    """Yield (state-dict key, global name) of every scaling factor."""
    for b in range(cfg.num_blocks):
        for key, name in _SCALES + (() if cfg.triplets_only else _SCALES_QUAD):
            yield f"{key.format(b=b)}.scale_factor", name.format(i=b + 1)
    for b in range(cfg.num_blocks + 1):
        yield f"out_blocks.{b}.scale_sum.scale_factor", f"OutBlock_{b}_sum"
        if cfg.direct_forces:
            yield f"out_blocks.{b}.scale_rbf.scale_factor", f"OutBlock_{b}_had"


def _flat_scales(tree, out: dict) -> dict:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat_scales(v, out)
        else:
            out[k] = float(np.asarray(v))
    return out


def state_dict_from_jax(variables_np: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX-package variables as nested dicts of numpy arrays (`params` and
    `scale_factors`) -> a state dict that this package's `GemNet(cfg)` loads
    with `load_state_dict(strict=True)`."""
    params = variables_np["params"]
    out: dict[str, torch.Tensor] = {}
    for name, is_dense in canonical_weights(cfg):
        node = params
        for p in flax_path(name):
            node = node[p]
        value = np.asarray(node, dtype=np.float32)
        out[name] = torch.from_numpy(np.array(value.T if is_dense else value, order="C"))
    scales = _flat_scales(variables_np.get("scale_factors", {}), {})
    for key, global_name in scale_state_names(cfg):
        out[key] = torch.tensor(scales[global_name], dtype=torch.float32)
    return out


def _reference_aliases(name: str, is_dense: bool) -> list[str]:
    """Every key the reference state_dict registers for `name`: a Dense
    weight also as `X.linear.weight` (base_layers.py:26-27), and the output
    blocks' `layers` also as `seq_energy` (atom_update_block.py:131)
    (torch_export.py:126-135)."""
    keys = [name]
    if is_dense:
        stem, leaf = name.rsplit(".", 1)
        keys.append(f"{stem}.linear.{leaf}")
    keys += [k.replace(".layers.", ".seq_energy.") for k in keys
             if k.startswith("out_blocks.") and ".layers." in k]
    return keys


def export_reference_state_dict(model: torch.nn.Module,
                                cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's weights as bound (bind the EMA weights first for an EMA
    export, `Trainer.weights`) and its scale factors -> the reference
    state_dict with its full, aliased key set, loadable by the reference
    model with strict=True. CPU tensors, copies."""
    sd = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for name, is_dense in canonical_weights(cfg):
        value = sd[name].detach().to("cpu", copy=True)
        for key in _reference_aliases(name, is_dense):
            out[key] = value
    for key, _ in scale_state_names(cfg):
        out[key] = sd[key].detach().to("cpu", torch.float32, copy=True)
    return out


def save_reference_checkpoint(path: str, model: torch.nn.Module, cfg: ModelConfig) -> None:
    """torch.save the exported state dict as a reference-loadable .pth
    (reference save_weights, gemnet.py:786-787)."""
    torch.save(export_reference_state_dict(model, cfg), path)


def strip_reference_aliases(state_dict: dict) -> dict:
    """A reference state_dict less its `.linear.` and `seq_energy` aliases:
    what this package's GemNet loads with strict=True."""
    return {k: v for k, v in state_dict.items()
            if ".linear." not in k and ".seq_energy." not in k}
