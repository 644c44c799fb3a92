"""The port's TF checkpoint importer against the JAX package's
(tests/test_compat.py:66,156): its name map resolves onto the same weights
and factors, `apply_tf_variables` on synthetic TF-named tensors, and a
checkpoint written with TensorFlow's SaveV2, each equal tensor for tensor
to `state_dict_from_jax` of JAX's import, and loadable with strict=True."""

import numpy as np
import pytest
import torch

from test_torch_remat import WIDTHS


def _setup(triplets_only, direct_forces, seed):
    """JAX variables of a small model, the JAX and port configs, and random
    TF-named tensors of the right shapes (factors in [0.5, 2))."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.compat import tf_variable_names as jax_names
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from test_torch_remat import _batch

    kw = dict(WIDTHS, triplets_only=triplets_only, direct_forces=direct_forces)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    batch = {k: jnp.asarray(v) for k, v in _batch(triplets_only).items()}
    variables = jax.eval_shape(make_model(jcfg).init, jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(seed)
    fake = {}
    for tf_name, (coll, target, _) in jax_names(jcfg).items():
        if coll == "scales":
            fake[tf_name] = np.float32(rng.uniform(0.5, 2.0))
        else:
            node = variables["params"]
            for part in target:
                node = node[part]
            fake[tf_name] = rng.normal(scale=0.05, size=node.shape).astype(np.float32)
    return jcfg, cfg, variables, fake


def _jax_import_as_port(jcfg, cfg, variables, get_tensor, importer=None):
    """JAX's import (`apply_tf_variables`, or `importer(get_tensor, cfg,
    template)`) into a template of `variables`' shapes, carried into a port
    state dict."""
    import jax

    from gemnet_pytorch_tpu.compat import apply_tf_variables as jax_apply
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax

    template = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), variables)
    loaded = (importer or jax_apply)(get_tensor, jcfg, template)
    return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, loaded), cfg)


def _assert_same(port, ref):
    assert sorted(port) == sorted(ref)
    for key, value in ref.items():
        torch.testing.assert_close(port[key], value, rtol=0, atol=0, msg=key)


@pytest.mark.parametrize("triplets_only,direct_forces", [(False, False), (True, True)],
                         ids=["Q", "dT"])
def test_tf_names_and_apply_match_jax(triplets_only, direct_forces):
    from gemnet_pytorch_tpu.compat import tf_variable_names as jax_names
    from gemnet_pytorch_tpu_torch.compat import flax_path, scale_state_names
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.tf_import import apply_tf_variables, tf_variable_names

    jcfg, cfg, variables, fake = _setup(triplets_only, direct_forces, seed=5)
    names = tf_variable_names(cfg)
    assert names.keys() == jax_names(jcfg).keys()
    scale_keys = dict(scale_state_names(cfg))
    for tf_name, (coll, target, _) in jax_names(jcfg).items():
        key = names[tf_name]
        assert (scale_keys[key] if coll == "scales" else flax_path(key)) == target, tf_name

    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    sd = apply_tf_variables(lambda n: fake[n], cfg, model.state_dict())
    _assert_same(sd, _jax_import_as_port(jcfg, cfg, variables, lambda n: fake[n]))
    model.load_state_dict(sd, strict=True)
    # without a template the map alone gives every key of the model
    _assert_same(apply_tf_variables(lambda n: fake[n], cfg), sd)

    bad = dict(fake)
    key = next(k for k in names if k.endswith("dense_ca/kernel"))
    bad[key] = bad[key][:-1]
    with pytest.raises(ValueError, match="dense_ca"):
        apply_tf_variables(lambda n: bad[n], cfg, model.state_dict())


def test_tf_checkpoint_matches_jax(tmp_path):
    """A TensorBundle checkpoint written as tests/test_compat.py:156 writes
    it (tf.raw_ops.SaveV2, the '/.ATTRIBUTES/VARIABLE_VALUE' keys) reads
    back through `load_tf_checkpoint` as JAX's reader reads it."""
    tf = pytest.importorskip("tensorflow")

    from gemnet_pytorch_tpu.compat import load_tf_checkpoint as jax_load
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.tf_import import SUFFIX, load_tf_checkpoint

    jcfg, cfg, variables, fake = _setup(False, True, seed=11)
    prefix = str(tmp_path / "tf_ckpt" / "ckpt")
    names = sorted(fake)
    tf.raw_ops.SaveV2(prefix=tf.constant(prefix),
                      tensor_names=tf.constant([n + SUFFIX for n in names]),
                      shape_and_slices=tf.constant([""] * len(names)),
                      tensors=[tf.constant(fake[n]) for n in names])

    sd = load_tf_checkpoint(prefix, cfg)
    _assert_same(sd, _jax_import_as_port(
        jcfg, cfg, variables, None, lambda _, c, template: jax_load(prefix, c, template)))
    GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu").load_state_dict(
        sd, strict=True)
