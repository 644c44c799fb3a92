"""Import TF2 GemNet checkpoints into this package (port of
`gemnet_pytorch_tpu/compat/tf_import.py`; reference `load_tfmodel`,
gemnet.py:617-778).

`tf_variable_names` maps the TF checkpoint's variable names to this
package's state-dict keys (the reference schema), `apply_tf_variables`
fills a state dict from a tensor-fetching callable, and
`load_tf_checkpoint` reads a TF2 checkpoint with TensorFlow, which is
imported only there. TF Dense kernels are (in, out) and this package's
Dense weights (out, in), so those are transposed (the reference does the
same, gemnet.py:628-630); the 3-D bilinear weights, the embeddings and the
frequencies keep their layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .compat import canonical_weights
from .config import ModelConfig

SUFFIX = "/.ATTRIBUTES/VARIABLE_VALUE"


def tf_variable_names(cfg: ModelConfig) -> dict[str, str]:
    """TF checkpoint variable name -> state-dict key, for every weight and
    scaling factor of the model `cfg` describes (gemnet.py:633-778)."""
    out = {
        "rbf_basis/frequencies": "rbf_basis.frequencies",
        "atom_emb/embeddings": "atom_emb.embeddings.weight",
        "edge_emb/dense/kernel": "edge_emb.dense.weight",
    }
    shared = ["mlp_cbf3", "mlp_rbf3", "mlp_rbf_h", "mlp_rbf_out"]
    if not cfg.triplets_only:
        shared += ["mlp_rbf4", "mlp_cbf4", "mlp_sbf4"]
    for layer in shared:
        out[f"{layer}/kernel"] = f"{layer}.weight"

    def mlp(tf: str, key: str, n: int, first: bool):
        # a stack of residual layers (first: after a Dense at index 0)
        if first:
            out[f"{tf}/0/kernel"] = f"{key}.0.weight"
        for j in range(1 if first else 0, n + (1 if first else 0)):
            for k in range(2):
                out[f"{tf}/{j}/dense_mlp/layer_with_weights-{k}/kernel"] = (
                    f"{key}.{j}.dense_mlp.{k}.weight")

    for i in range(cfg.num_blocks):
        tf, key = f"int_blocks/{i}", f"int_blocks.{i}"
        if not cfg.triplets_only:
            for layer in ["dense_db", "mlp_rbf", "mlp_cbf", "down_projection",
                          "up_projection_ca", "up_projection_ac", "mlp_sbf"]:
                out[f"{tf}/quad_interaction/{layer}/kernel"] = (
                    f"{key}.quad_interaction.{layer}.weight")
            for scale in ("rbf", "cbf", "sbf_sum"):
                out[f"{tf}/quad_interaction/scale_{scale}/scale_factor"] = (
                    f"{key}.quad_interaction.scale_{scale}.scale_factor")
        for layer in ["dense_ba", "mlp_rbf", "down_projection", "up_projection_ac",
                      "up_projection_ca", "mlp_cbf"]:
            out[f"{tf}/trip_interaction/{layer}/kernel"] = f"{key}.trip_interaction.{layer}.weight"
        for scale in ("rbf", "cbf_sum"):
            out[f"{tf}/trip_interaction/scale_{scale}/scale_factor"] = (
                f"{key}.trip_interaction.scale_{scale}.scale_factor")
        out[f"{tf}/atom_update/dense_rbf/kernel"] = f"{key}.atom_update.dense_rbf.weight"
        out[f"{tf}/atom_update/scale_sum/scale_factor"] = f"{key}.atom_update.scale_sum.scale_factor"
        mlp(f"{tf}/atom_update/layers", f"{key}.atom_update.layers", cfg.num_atom, True)
        out[f"{tf}/concat_layer/dense/kernel"] = f"{key}.concat_layer.dense.weight"
        out[f"{tf}/dense_ca/kernel"] = f"{key}.dense_ca.weight"
        for stack, count in [("layers_before_skip", cfg.num_before_skip),
                             ("layers_after_skip", cfg.num_after_skip),
                             ("residual_m", cfg.num_concat)]:
            mlp(f"{tf}/{stack}", f"{key}.{stack}", count, False)

    for i in range(cfg.num_blocks + 1):
        tf, key = f"out_blocks/{i}", f"out_blocks.{i}"
        out[f"{tf}/dense_rbf/kernel"] = f"{key}.dense_rbf.weight"
        mlp(f"{tf}/layers", f"{key}.layers", cfg.num_atom, True)
        out[f"{tf}/out_energy/kernel"] = f"{key}.out_energy.weight"
        out[f"{tf}/scale_sum/scale_factor"] = f"{key}.scale_sum.scale_factor"
        if cfg.direct_forces:
            # the reference's load_tfmodel also copies out_forces/bias
            # (gemnet.py:764), but its out_forces has no bias
            # (atom_update_block.py:137-141): the TF bias is skipped
            out[f"{tf}/out_forces/kernel"] = f"{key}.out_forces.weight"
            out[f"{tf}/scale_rbf/scale_factor"] = f"{key}.scale_rbf.scale_factor"
            mlp(f"{tf}/seq_forces", f"{key}.seq_forces", cfg.num_atom, True)
    return out


def apply_tf_variables(get_tensor, cfg: ModelConfig,
                       state_dict: dict[str, torch.Tensor] | None = None
                       ) -> dict[str, torch.Tensor]:
    """A state dict for `GemNet(cfg).load_state_dict(strict=True)` from
    `get_tensor(tf_name)` (a numpy array, for the names of
    `tf_variable_names`, without the checkpoint's SUFFIX). `state_dict`,
    where given, supplies every key the checkpoint does not (the TF map
    covers every weight and factor, so none is needed) and each tensor's
    expected shape; the result is a new dict of fp32 CPU tensors."""
    dense = dict(canonical_weights(cfg))
    out = dict(state_dict or {})
    for tf_name, key in tf_variable_names(cfg).items():
        value = np.asarray(get_tensor(tf_name), np.float32)
        if dense.get(key, False):
            value = value.T
        tensor = torch.from_numpy(np.array(value, order="C"))
        if key in out and tuple(out[key].shape) != tuple(tensor.shape):
            raise ValueError(f"{tf_name}: shape {tuple(tensor.shape)}, the model's {key} has "
                             f"{tuple(out[key].shape)}")
        out[key] = tensor
    return out


def load_tf_checkpoint(path: str, cfg: ModelConfig,
                       state_dict: dict[str, torch.Tensor] | None = None
                       ) -> dict[str, torch.Tensor]:
    """Read a TF2 checkpoint into a state dict (reference `load_tfmodel`)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("tensorflow is not installed here; load a .pth with "
                          "pretrained.load_pretrained instead") from e
    reader = tf.train.load_checkpoint(path)
    return apply_tf_variables(lambda name: reader.get_tensor(name + SUFFIX), cfg, state_dict)
