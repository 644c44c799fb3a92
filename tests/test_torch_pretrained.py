"""The port's pretrained loader against the JAX package's on directories the
tests write (model_kwargs.json from a ModelConfig, a scaling_factors.json
with non-unit factors, a .pth from JAX's `save_reference_checkpoint`):
energies and forces of GemNet-Q and -T within rtol 1e-5, the scale file's
search order, and the examples and the ASE module run on the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# tests/test_remat.py's widths
WIDTHS = dict(num_spherical=3, num_radial=3, num_blocks=2, emb_size_atom=16,
              emb_size_edge=16, emb_size_trip=8, emb_size_quad=4, emb_size_rbf=4,
              emb_size_cbf=4, emb_size_sbf=4, emb_size_bil_quad=4, emb_size_bil_trip=8)
VARIANTS = {"Q": dict(triplets_only=False), "T": dict(triplets_only=True)}


def _write_directory(root, variant: str, scales_beside: bool = True):
    """root/GemNet-<variant> with model_kwargs.json, and scaling_factors.json
    with factors in [0.5, 2) beside it (or in root)."""
    from gemnet_pytorch_tpu.config import ModelConfig
    from gemnet_pytorch_tpu.models.scaling import scale_names_in_creation_order

    cfg = ModelConfig(**WIDTHS, **VARIANTS[variant])
    directory = os.path.join(root, f"GemNet-{variant}")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model_kwargs.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)
    rng = np.random.default_rng(len(variant))
    scales = {name: float(rng.uniform(0.5, 2.0)) for name in scale_names_in_creation_order(cfg)}
    with open(os.path.join(directory if scales_beside else root, "scaling_factors.json"),
              "w") as f:
        json.dump(dict(comment="test factors", **scales), f)
    return cfg, directory, scales


def _molecule_batch(cfg):
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.examples.predict import R, Z

    return Molecule(R, Z, cfg.cutoff, cfg.int_cutoff, triplets_only=cfg.triplets_only).get()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_load_pretrained_matches_jax(tmp_path, variant):
    """JAX's `load_pretrained` of the directory (weights from seed 1, the
    JSON's factors) is written to a .pth by JAX's exporter; the port's
    `load_pretrained` of the directory and that .pth gives E/F within
    rtol 1e-5 (of the largest |E|, |F|) of the JAX model's."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.compat import save_reference_checkpoint
    from gemnet_pytorch_tpu.models import energy_and_forces as jax_ef
    from gemnet_pytorch_tpu.pretrained import load_pretrained as jax_load
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.pretrained import load_pretrained

    cfg, directory, _ = _write_directory(str(tmp_path), variant)
    batch = _molecule_batch(cfg)
    jmodel, variables = jax_load(directory, batch, seed=1)
    weights = str(tmp_path / "model.pth")
    save_reference_checkpoint(weights, variables, cfg)

    # eager, op for op: a jitted forward fuses and reorders fp32 sums, and
    # moves F by ~2e-5 of its largest |F| on this molecule
    E_ref, F_ref, _ = jax_ef(jmodel, variables, {k: jnp.asarray(v) for k, v in batch.items()})
    model = load_pretrained(directory, weights_path=weights, device="cpu")
    E, F = energy_and_forces(model, to_torch(batch, "cpu"))
    for port, ref in ((E, E_ref), (F, F_ref)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())

    # the reference's training checkpoints wrap the weights in "model"
    wrapped = str(tmp_path / "wrapped.pth")
    torch.save({"model": torch.load(weights)}, wrapped)
    again = load_pretrained(directory, weights_path=wrapped, device="cpu")
    for key, value in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], value, rtol=0, atol=0)


@pytest.mark.parametrize("scales_beside", [True, False], ids=["beside", "parent"])
def test_scale_file_search(tmp_path, scales_beside):
    """Without weights: the factors are the JSON's, found beside the kwargs
    or in the parent directory (JAX `pretrained.py:53-62`, whose search
    `find_scale_file` copies); an explicit file wins."""
    from gemnet_pytorch_tpu_torch.models.scaling import scaling_factors
    from gemnet_pytorch_tpu_torch.pretrained import find_scale_file, load_pretrained

    cfg, directory, scales = _write_directory(str(tmp_path), "T", scales_beside)
    expected = os.path.join(directory if scales_beside else str(tmp_path), "scaling_factors.json")
    assert find_scale_file(directory) == expected
    model = load_pretrained(directory, device="cpu")
    got = {name: float(m.scale_factor) for name, m in scaling_factors(model).items()}
    assert got == pytest.approx(scales, rel=1e-7)

    other = str(tmp_path / "other.json")
    with open(other, "w") as f:
        json.dump({name: 3.0 for name in scales}, f)
    model = load_pretrained(directory, scale_file=other, device="cpu")
    assert {float(m.scale_factor) for m in scaling_factors(model).values()} == {3.0}


def test_load_pretrained_refusals(tmp_path):
    from gemnet_pytorch_tpu_torch.pretrained import load_pretrained

    _, directory, _ = _write_directory(str(tmp_path), "T")
    with pytest.raises(FileNotFoundError):
        load_pretrained(directory, weights_path=str(tmp_path / "missing.pth"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pretrained(directory)


def test_predict_example_runs(tmp_path, capsys):
    from gemnet_pytorch_tpu_torch.examples import predict
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator
    from gemnet_pytorch_tpu_torch.pretrained import load_pretrained

    cfg, directory, _ = _write_directory(str(tmp_path), "Q")
    energy, forces = predict.main([directory, "--device", "cpu"])
    assert forces.shape == (len(predict.Z), 3) and np.isfinite(forces).all()
    assert "Energy [eV]:" in capsys.readouterr().out
    from gemnet_pytorch_tpu_torch.data import Molecule

    calc = GemNetCalculator(Molecule(predict.R, predict.Z, cfg.cutoff, cfg.int_cutoff),
                            load_pretrained(directory, device="cpu"), device="cpu")
    e, f = calc.calculate()
    assert e == energy
    np.testing.assert_array_equal(f, forces)


def test_md_example_runs(tmp_path):
    from gemnet_pytorch_tpu_torch.examples import md_simulation

    path = str(tmp_path / "traj.npz")
    traj = md_simulation.main(["--traj", path, "--steps", "11", "--device", "cpu"])
    assert len(traj) == 2  # steps 0 and 10
    with np.load(path) as data:
        assert data["R"].shape == (2, 10, 3) and np.isfinite(data["E"]).all()


def test_ase_module_reexports():
    from gemnet_pytorch_tpu_torch import ase_calculator, md
    from gemnet_pytorch_tpu_torch.data import containers

    assert ase_calculator.Molecule is containers.Molecule
    assert ase_calculator.GemNetCalculator is md.GemNetCalculator
    assert ase_calculator.MDSimulator is md.MDSimulator
    assert ase_calculator.make_ase_calculator is md.make_ase_calculator
    try:
        import ase  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="ase"):
            ase_calculator.make_ase_calculator(None, None, device="cpu")
