"""K train steps per call on the CPU: `Trainer.train_on_batches` over 3
batches equals 3 `train_on_batch` calls bit for bit (the counterpart of
tests/test_flat_opt.py::test_multi_step_matches_single_steps), and the
port's K-step trajectory from JAX-carried weights follows JAX's
`Trainer.train_on_batches`."""

import numpy as np
import pytest
import torch

from test_torch_train import TINY, TRAIN, VARIANTS, _flat, _provider, _rel_l2

torch.set_num_threads(2)


def _batches(npz, triplets_only, jax_side, n):
    it = _provider(npz, triplets_only, jax_side).get_dataset("train", prefetch_workers=0)
    return [next(it) for _ in range(n)]


def _trainer(variant, seed=0):
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = GemNet(ModelConfig(**VARIANTS[variant], **TINY),
                   generator=torch.Generator().manual_seed(seed), device="cpu")
    return Trainer(model, TrainConfig(**TRAIN))


def _tensors(state):
    st = state.opt_state
    return dict(step=state.step, params=state.params, ema=state.ema_params,
                metric_acc=state.metric_acc, count=st.count, mu=st.mu, nu=st.nu,
                nu_max=st.nu_max)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_on_batches_equals_single_steps(synthetic_npz, variant):
    """3 steps in one call against 3 single calls, from the same weights:
    every state buffer, the metric accumulators and the last loss bit for
    bit; the parameters stay views of the state's buffer."""
    batches = _batches(synthetic_npz, VARIANTS[variant]["triplets_only"], False, 3)
    single, multi = _trainer(variant), _trainer(variant)
    s1, s2 = single.init_state(), multi.init_state()
    for b in batches:
        s1, loss1 = single.train_on_batch(s1, b, 0.5)
    s2, loss2 = multi.train_on_batches(s2, batches, 0.5)
    assert torch.equal(loss1, loss2)
    for key, value in _tensors(s1).items():
        assert torch.equal(value, _tensors(s2)[key]), key
    assert int(s2.step) == 3
    off = 0
    for p in multi.model.parameters():
        assert p.data_ptr() == s2.params.data_ptr() + off * 4
        off += p.numel()
    # the packed rows of the provider's transform take the same path
    third = _trainer(variant)
    packed = [third.packer.pack(b) for b in batches]
    s3, loss3 = third.train_on_batches(third.init_state(), packed, 0.5)
    assert torch.equal(loss3, loss2) and torch.equal(s3.params, s2.params)


def test_k_step_trajectory_matches_jax(synthetic_npz):
    """2 calls of 3 steps each from JAX-carried weights, on the port and on
    the JAX Trainer (flat mode): each call's last loss within rtol 1e-5,
    the parameter update within a relative L2 error of 3e-6 (1.3e-6 here),
    the accumulated metrics within rtol 1e-5. The EMA's move within 3e-5
    (1.2e-5 here): after 6 steps it is ~1e-4 on weights of order 1, whose
    fp32 rounding at each EMA update is ~6e-8, so the move itself carries
    that much rounding in either implementation."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training import Trainer
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig as PortConfig

    variant = VARIANTS["Q"]
    batches = _batches(synthetic_npz, False, True, 6)
    mcfg = ModelConfig(**variant, **TINY)
    model = make_model(mcfg)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(model.init)(
        jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batches[0].items()})))
    jtrainer = Trainer(model, TrainConfig(**TRAIN))
    jstate = jtrainer.init_state(variables)

    trainer = _trainer("Q")
    trainer.model.load_state_dict(state_dict_from_jax(variables, PortConfig(**variant, **TINY)),
                                  strict=True)
    state = trainer.init_state()
    p0 = state.params.clone().numpy()
    for call in range(2):
        chunk = [dict(b) for b in batches[3 * call:3 * call + 3]]
        jstate, jloss = jtrainer.train_on_batches(jstate, chunk, 1.0)
        state, loss = trainer.train_on_batches(state, chunk, 1.0)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    def port_order(flat):
        tree = jax.tree_util.tree_map(np.asarray, jtrainer.unravel(flat))
        return _flat(trainer, state_dict_from_jax(
            {"params": tree, "scale_factors": variables["scale_factors"]},
            PortConfig(**variant, **TINY)))

    assert int(state.step) == int(jstate.step) == 6
    assert _rel_l2(state.params.numpy() - p0, port_order(jstate.params) - p0) < 3e-6
    assert _rel_l2(state.ema_params.numpy() - p0, port_order(jstate.ema_params) - p0) < 3e-5
    np.testing.assert_allclose(state.metric_acc.numpy(), np.asarray(jstate.metric_acc),
                               rtol=1e-5)
