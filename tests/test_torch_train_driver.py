"""The port's training driver on the CPU: checkpoints restored in place bit
for bit (the model still training on the state's buffer), `train.run` with
eval and checkpoints every 2 steps and its resume, the plateau lr timing and
early stopping on a scripted validation-loss sequence, the command line, and
the reference export against the JAX package's `export_reference_state_dict`
key for key and value for value."""

import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_train import TINY

torch.set_num_threads(2)

# a short run: lr at full strength from step 0, 24 molecules of 4-12 atoms
RUN = dict(TINY, batch_size=8, evaluation_interval=2, save_interval=2, warmup_steps=1,
           data_seed=0)
RUN_MOLECULES = 24


def _trainer(seed=0, **cfg):
    from gemnet_pytorch_tpu_torch.config import ModelConfig, TrainConfig
    from gemnet_pytorch_tpu_torch.models import GemNet
    from gemnet_pytorch_tpu_torch.training import Trainer

    model = GemNet(ModelConfig(**TINY, **cfg), generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    return Trainer(model, TrainConfig(warmup_steps=1, ema_decay=0.9))


def _views_of(trainer, flat):
    """Every parameter of the trainer's model is a view of `flat`."""
    off = 0
    for p in trainer.model.parameters():
        if p.data_ptr() != flat.data_ptr() + off * flat.element_size():
            return False
        off += p.numel()
    return off == flat.numel()


def test_checkpoint_round_trip_in_place(synthetic_npz, tmp_path):
    """Two steps, save; a fresh trainer (other weights) restores: params,
    EMA, every optimizer buffer, step and metric accumulators bit for bit,
    in its own buffers, which its model's parameters still view; the
    plateau sidecar; and the model-only checkpoint through state_dict."""
    from gemnet_pytorch_tpu_torch.training import (
        PlateauState, restore_checkpoint, restore_params, save_checkpoint, save_params)
    from gemnet_pytorch_tpu_torch.training.checkpoint import state_tensors

    from test_torch_train import _provider

    batch = next(_provider(synthetic_npz, False, False).get_dataset("train", prefetch_workers=0))
    trainer = _trainer(0)
    state = trainer.init_state()
    for _ in range(2):
        state, _ = trainer.train_on_batch(state, batch, 1.0)
    plateau = PlateauState(patience=1)
    for loss in (1.0, 2.0, 3.0):
        plateau.step(loss)
    save_checkpoint(str(tmp_path / "logs" / "checkpoint"), state, plateau)

    other = _trainer(1)
    restored = other.init_state()
    buffers = {k: v.data_ptr() for k, v in state_tensors(restored).items()}
    plateau2 = PlateauState(patience=1)
    restored, plateau2 = restore_checkpoint(str(tmp_path / "logs" / "checkpoint"), restored,
                                            plateau2)
    for key, value in state_tensors(state).items():
        assert torch.equal(state_tensors(restored)[key], value), key
    assert {k: v.data_ptr() for k, v in state_tensors(restored).items()} == buffers
    assert _views_of(other, restored.params)
    assert plateau2.state_dict() == plateau.state_dict() and plateau2.reduce_counter == 1
    E = trainer.predict(state, batch)[0]
    assert torch.equal(other.predict(restored, batch)[0], E)
    assert torch.equal(other.predict(restored, batch, use_ema=True)[0],
                       trainer.predict(state, batch, use_ema=True)[0])
    # a checkpoint of another model raises instead of half-restoring
    with pytest.raises((KeyError, ValueError)):
        restore_checkpoint(str(tmp_path / "logs" / "checkpoint"),
                           _trainer(0, triplets_only=True).init_state())

    with trainer.weights(state, use_ema=True):
        save_params(str(tmp_path / "best" / "model"), trainer.model)
        ema_sd = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    fresh = _trainer(2)
    fresh_state = fresh.init_state()
    restore_params(str(tmp_path / "best" / "model"), fresh.model)
    assert all(torch.equal(fresh.model.state_dict()[k], v) for k, v in ema_sd.items())
    assert _views_of(fresh, fresh_state.params)
    assert torch.equal(fresh_state.params, state.ema_params)


def test_run_and_resume(tmp_path, caplog):
    """train.run on the CPU: 4 steps with eval and checkpoints every 2, the
    files of the repository's train.py, finite best metrics; then a run of
    6 steps with `restart` resumes at step 4 and trains 2 more steps; the
    step-4 checkpoint restores into a fresh state bit for bit, in the
    buffers its model views."""
    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.training import PlateauState, restore_checkpoint
    from gemnet_pytorch_tpu_torch.training.checkpoint import state_tensors

    run_dir = str(tmp_path / "run")
    config = dict(RUN, num_steps=4, restart=run_dir)
    best = train.run(config, device="cpu", synthetic_molecules=RUN_MOLECULES)
    assert sorted(best) == sorted(f"{k}_{s}_best" for k in
                                  ("loss", "energy_mae", "force_mae", "force_rmse")
                                  for s in ("val",)) + ["step_best"]
    assert all(np.isfinite(v) for v in best.values()) and best["step_best"] in (2, 4)
    for rel in ("logs/checkpoint", "logs/checkpoint.plateau.npz", "best/model",
                "best/best_metrics.npz", "synthetic_train.npz"):
        assert os.path.exists(os.path.join(run_dir, rel)), rel
    assert not [n for n in os.listdir(os.path.join(run_dir, "logs")) if ".tmp" in n]
    ckpt = os.path.join(run_dir, "logs", "checkpoint")
    saved = torch.load(ckpt, weights_only=True)
    assert int(saved["step"]) == 4 and int(saved["opt_state.count"]) == 4
    step4 = str(tmp_path / "checkpoint-4")
    for suffix in ("", ".plateau.npz"):
        shutil.copyfile(ckpt + suffix, step4 + suffix)

    with caplog.at_level(logging.INFO):
        train.run(dict(config, num_steps=6), device="cpu", synthetic_molecules=RUN_MOLECULES)
    restores = [r.args for r in caplog.records if r.msg == "restored checkpoint at step %d"]
    assert restores == [(4,)]
    resumed = torch.load(ckpt, weights_only=True)
    assert int(resumed["step"]) == 6 and int(resumed["opt_state.count"]) == 6
    assert not torch.equal(resumed["params"], saved["params"])

    fresh = _trainer(1)
    state, plateau = restore_checkpoint(step4, fresh.init_state(), PlateauState())
    tensors = state_tensors(state)
    assert all(torch.equal(tensors[k], v) for k, v in saved.items())
    assert _views_of(fresh, state.params) and plateau.lr_scale == 1.0


def test_plateau_timing_and_early_stopping(tmp_path, monkeypatch):
    """Scripted validation losses (evaluation every step, decay_patience 1,
    patience 3): the reduce decided at the eval of step 4 reaches the
    optimizer at step 6, not 5 (train.py:388-393, torch's ReduceLROnPlateau
    timing), and the run stops early at step 6 (best at step 2 +
    patience * evaluation_interval), saving its final checkpoint."""
    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.training import Trainer

    losses = iter([1.0, 0.9, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0, 1.01, 1.02])
    lrs = []

    def train_on_batch(self, state, batch, lr_scale, metrics=None):
        lrs.append(lr_scale)
        state.metric_acc += 1.0  # one sample of metric 1.0 per key
        return state, torch.zeros(())

    def test_on_batch(self, state, batch, metrics, use_ema=False):
        loss = next(losses)
        metrics.update_state(1, **{k: loss for k in self.tracked_metrics})
        return loss

    monkeypatch.setattr(Trainer, "train_on_batch", train_on_batch)
    monkeypatch.setattr(Trainer, "test_on_batch", test_on_batch)
    config = dict(RUN, num_steps=30, evaluation_interval=1, save_interval=100, patience=3,
                  decay_patience=1, decay_factor=0.5, decay_cooldown=0,
                  restart=str(tmp_path / "run"))
    best = train.run(config, device="cpu", synthetic_molecules=RUN_MOLECULES)
    assert lrs == [1.0, 1.0, 1.0, 1.0, 1.0, 0.5]
    assert best["step_best"] == 2 and best["loss_val_best"] == 0.9
    with np.load(str(tmp_path / "run" / "logs" / "checkpoint.plateau.npz")) as d:
        # the evals of steps 4 and 6 each reduced
        assert float(d["lr_scale"]) == 0.25 and int(d["reduce_counter"]) == 2


@pytest.mark.parametrize("argv,env", [
    (["--dp", "2", "--ep", "2"], {}), (["--halo", "2", "--tp", "2"], {}),
    (["--dp-halo", "2", "2", "--pp", "2"], {}), (["--pp", "2"], {}), (["--tp", "2"], {}),
    (["--coordinator", "localhost:1234", "--pp-micro", "4"], {}),
    ([], {"GEMNET_SWEEP_OVERRIDES": "{}"}),
], ids=["dp", "halo", "dp-halo", "pp", "tp", "coordinator", "sweep"])
def test_main_refuses_unported(monkeypatch, argv, env):
    """What the driver refuses, before any process group starts: the mode a
    later slice ports (--tp), also beside the ported --halo, which the
    message does not name; two modes at once (--dp with --ep, --dp-halo
    with --pp: "pick one"); --pp-micro without --pp (beside --coordinator);
    and the sweep variable. --pp alone is ported: it parses and reaches
    `train.run` with its process group (a stand-in here;
    tests/test_torch_pp.py runs it on gloo ranks)."""
    import torch.distributed as dist

    from gemnet_pytorch_tpu_torch import train

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if "--ep" in argv or "--dp-halo" in argv:
        with pytest.raises(ValueError,
                           match="pick one of --dp / --ep / --halo / --dp-halo / --pp"):
            train.main(argv + ["--device", "cpu"])
        return
    if "--pp-micro" in argv:
        with pytest.raises(ValueError, match="--pp-micro .* --pp N"):
            train.main(argv + ["--device", "cpu"])
        return
    if argv == ["--pp", "2"]:
        group, reached = object(), {}
        monkeypatch.setattr(train.mesh, "initialize_distributed", lambda *a, **k: group)
        monkeypatch.setattr(train, "run", lambda config, **kw: reached.update(kw) or {})
        monkeypatch.setattr(dist, "barrier", lambda *a, **k: None)
        monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: None)
        train.main(argv + ["--device", "cpu"])
        assert reached["group"] is group and reached["pp"] == 2
        return
    with pytest.raises(NotImplementedError) as err:
        train.main(argv + ["--device", "cpu"])
    refused = [a for a in argv if a.startswith("--") and a[2:].replace("-", "_")
               in train.UNPORTED_FLAGS]
    for flag in refused:
        assert flag in str(err.value)
    for flag in ("--dp ", "--halo ", "--dp-halo", "--coordinator"):
        assert flag not in str(err.value).split(":")[0]


def test_steps_per_call_chunks_and_matches_single_steps(tmp_path, monkeypatch):
    """`--steps-per-call 4` on the CPU, 9 steps with eval every 3 and
    checkpoints every 4: the chunks the loop runs are the repository
    train.py's (up to K, none across a multiple of 10, 4 or 3), K > 1
    chunks go through train_on_batches, and the final checkpoint equals
    that of `--steps-per-call 1` bit for bit."""
    from gemnet_pytorch_tpu_torch import train
    from gemnet_pytorch_tpu_torch.training import Trainer

    chunks = []
    one, many = Trainer.train_on_batch, Trainer.train_on_batches

    def train_on_batch(self, state, batch, lr_scale, metrics=None):
        chunks.append(1)
        return one(self, state, batch, lr_scale, metrics)

    def train_on_batches(self, state, batches, lr_scale):
        chunks.append(len(batches))
        return many(self, state, batches, lr_scale)

    monkeypatch.setattr(Trainer, "train_on_batch", train_on_batch)
    monkeypatch.setattr(Trainer, "train_on_batches", train_on_batches)
    import yaml

    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(RUN, num_steps=9, evaluation_interval=3,
                                            save_interval=4)))
    saved = {}
    for k in (1, 4):
        chunks.clear()
        run_dir = tmp_path / f"k{k}"
        train.main(["--config", str(cfg_path), "--device", "cpu", "--steps-per-call", str(k),
                    "--synthetic-molecules", str(RUN_MOLECULES), "--restart", str(run_dir)])
        saved[k] = torch.load(str(run_dir / "logs" / "checkpoint"), weights_only=True)
        if k == 1:
            assert chunks == [1] * 9
    # the rule of train.py:394-405, stepped by hand from step 0
    expected, step = [], 0
    while step < 9:
        n = min(4, 9 - step, *(i - step % i for i in (10, 4, 3)))
        expected.append(n)
        step += n
    assert chunks == expected == [3, 1, 2, 2, 1]
    assert saved[1].keys() == saved[4].keys()
    for key, value in saved[1].items():
        assert torch.equal(value, saved[4][key]), key


def test_main_on_cpu_and_cuda_refusal(tmp_path, monkeypatch):
    """The command line with a YAML config on the CPU; CUDA, the default,
    raises where there is none."""
    import yaml

    from gemnet_pytorch_tpu_torch import train

    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(dict(RUN, logdir=str(tmp_path / "logs"),
                                            comment="cli")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--config", str(cfg_path), "--num-steps", "2"])
    best = train.main(["--config", str(cfg_path), "--num-steps", "2", "--device", "cpu",
                       "--synthetic-molecules", str(RUN_MOLECULES),
                       "--export-torch", str(tmp_path / "ex.pth")])
    assert best["step_best"] == 2
    (run_dir,) = os.listdir(tmp_path / "logs")
    assert run_dir.endswith("_synthetic_cli")
    assert os.path.exists(tmp_path / "ex.pth")


@pytest.mark.parametrize("variant", ["Q", "dT"])
def test_export_matches_jax(synthetic_npz, tmp_path, variant):
    """export_reference_state_dict of a port model with carried weights and
    non-unit scales equals the JAX package's export of the same variables,
    key for key (the reference's aliases included) and value for value; the
    saved .pth, aliases dropped, loads back strictly."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.compat.torch_export import export_reference_state_dict as jax_export
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import (
        export_reference_state_dict, save_reference_checkpoint, state_dict_from_jax,
        strip_reference_aliases)
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    from test_torch_model import SMALL, VARIANTS, _padded_batch

    kw = dict(**VARIANTS[variant], **SMALL)
    batch, _ = _padded_batch(synthetic_npz, kw["triplets_only"])
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(make_model(JaxConfig(**kw)).init)(
        jax.random.PRNGKey(2), {k: jnp.asarray(v) for k, v in batch.items()}))
    rng = np.random.default_rng(4)
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])
    ref = jax_export(variables, JaxConfig(**kw))

    cfg = ModelConfig(**kw)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    port = export_reference_state_dict(model, cfg)
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    save_reference_checkpoint(str(tmp_path / "ex.pth"), model, cfg)
    back = GemNet(dataclasses.replace(cfg), generator=torch.Generator().manual_seed(1),
                  device="cpu")
    back.load_state_dict(strip_reference_aliases(torch.load(str(tmp_path / "ex.pth"),
                                                            weights_only=True)), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
