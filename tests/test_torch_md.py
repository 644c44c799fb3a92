"""The port's MD (`gemnet_pytorch_tpu_torch.md`) on the CPU: the
counterparts of tests/test_md.py's six tests (calculator shapes across graph
rebuilds, F = -dE/dR, Verlet energy conservation, Langevin, the unknown
integrator, the ASE adapter through an API stub), Maxwell-Boltzmann
velocities bit-equal to the JAX package's for one seed, and 10 Verlet steps
from JAX-carried weights against the JAX package's MDSimulator."""

import copy
import sys
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# tests/test_md.py's model: a 1-block GemNet-T with -dE/dR forces
WIDTHS = dict(
    num_spherical=3, num_radial=3, num_blocks=1, emb_size_atom=16,
    emb_size_edge=16, emb_size_trip=8, emb_size_quad=4, emb_size_rbf=4,
    emb_size_cbf=4, emb_size_sbf=4, emb_size_bil_quad=4, emb_size_bil_trip=8,
    triplets_only=True, direct_forces=False,
)


@pytest.fixture(scope="module")
def md_setup():
    """tests/test_md.py's molecule and JAX model, and the port's model with
    the JAX weights carried over."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.data import Molecule as JaxMolecule
    from gemnet_pytorch_tpu.data.synthetic import random_molecule
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    rng = np.random.default_rng(0)
    Z, R = random_molecule(rng, 8)
    jax_mol = JaxMolecule(R, Z, cutoff=5.0, int_cutoff=10.0, triplets_only=True)
    jax_model = make_model(JaxConfig(**WIDTHS))
    batch = {k: jnp.asarray(v) for k, v in jax_mol.get().items()}
    variables = jax_model.init(jax.random.PRNGKey(0), batch)
    cfg = ModelConfig(**WIDTHS)
    model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    model.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, dict(variables)), cfg),
        strict=True)
    return dict(Z=Z, R=R, model=model, jax_model=jax_model, variables=variables)


def _molecule(setup):
    from gemnet_pytorch_tpu_torch.data import Molecule

    return Molecule(setup["R"], setup["Z"], cutoff=5.0, int_cutoff=10.0, triplets_only=True)


def _calculator(setup):
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator

    return GemNetCalculator(_molecule(setup), copy.deepcopy(setup["model"]), device="cpu")


def test_calculator_stable_shapes(md_setup):
    calc = _calculator(md_setup)
    E0, F0 = calc.calculate()
    assert np.isfinite(E0) and np.isfinite(F0).all()
    assert F0.shape == (8, 3)
    # rigid translation: energy invariant (sanity of the geometry stack)
    E_t, _ = calc.calculate(md_setup["R"] + 0.37)
    np.testing.assert_allclose(E_t, E0, rtol=1e-5, atol=1e-5)
    # non-rigid move: the same padded shapes, a new prediction
    key0 = calc._shape_key
    bump = np.zeros_like(md_setup["R"])
    bump[0, 0] = 0.05
    E1, _ = calc.calculate(md_setup["R"] + bump)
    assert calc._shape_key == key0, "a small move should not change the padded dims"
    assert E1 != E0


def test_forces_are_negative_gradient(md_setup):
    """Central-difference check of F = -dE/dR on the model surface."""
    calc = _calculator(md_setup)
    R = np.array(md_setup["R"], np.float64)
    E0, F0 = calc.calculate(R)
    eps = 1e-3
    for (i, d) in [(0, 0), (3, 1), (5, 2)]:
        Rp = R.copy()
        Rp[i, d] += eps
        Rm = R.copy()
        Rm[i, d] -= eps
        Ep, _ = calc.calculate(Rp)
        Em, _ = calc.calculate(Rm)
        fd = -(Ep - Em) / (2 * eps)
        np.testing.assert_allclose(fd, F0[i, d], rtol=5e-2, atol=5e-3)


def test_verlet_energy_conservation(md_setup):
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    sim = MDSimulator(_molecule(md_setup), copy.deepcopy(md_setup["model"]), dynamics="verlet",
                      max_steps=20, time=0.2, temperature=50, interval=1, traj_path=None,
                      seed=1, device="cpu")
    traj = sim.run()
    assert len(traj) == 20
    etot = [traj.frames_E[i] + 0.5 * float((sim.masses * traj.frames_v[i] ** 2).sum())
            for i in range(len(traj))]
    drift = abs(etot[-1] - etot[0])
    scale = max(1e-3, abs(np.std(traj.frames_E)))
    assert drift < 5 * scale, f"energy drift {drift} vs scale {scale}: {etot[:3]}...{etot[-3:]}"


def test_langevin_runs(md_setup, tmp_path):
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    path = str(tmp_path / "traj.npz")
    sim = MDSimulator(_molecule(md_setup), copy.deepcopy(md_setup["model"]),
                      dynamics="langevin", max_steps=10, time=0.2, temperature=300, interval=5,
                      traj_path=path, seed=2, device="cpu")
    traj = sim.run()
    assert len(traj) == 2
    assert all(np.isfinite(e) for e in traj.frames_E)
    with np.load(path) as saved:
        assert saved["R"].shape == (2, 8, 3) and saved["E"].shape == (2,)


def test_unknown_integrator_raises(md_setup):
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    with pytest.raises(ValueError):
        MDSimulator(_molecule(md_setup), md_setup["model"], dynamics="nope", device="cpu")


def test_ase_adapter_with_api_stub(md_setup, monkeypatch):
    """make_ase_calculator through a minimal stub of the ase Calculator API
    (ase is not installed): the same E/F as GemNetCalculator directly; and
    without the stub, the ImportError that names the way around it."""
    from gemnet_pytorch_tpu_torch.md import make_ase_calculator

    monkeypatch.setitem(sys.modules, "ase", None)
    with pytest.raises(ImportError, match="ase is not installed"):
        make_ase_calculator(_molecule(md_setup), md_setup["model"], device="cpu")

    calc_mod = types.ModuleType("ase.calculators.calculator")

    class Calculator:
        def __init__(self, **kwargs):
            self.results = {}
            self.atoms = None
            self.parameters = dict(kwargs)

        def calculate(self, atoms=None, properties=("energy",), system_changes=None):
            if atoms is not None:
                self.atoms = atoms

    calc_mod.Calculator = Calculator
    calc_mod.all_changes = ["positions", "numbers", "cell", "pbc", "initial_charges",
                            "initial_magmoms"]
    ase_mod = types.ModuleType("ase")
    ase_calcs = types.ModuleType("ase.calculators")
    ase_mod.calculators = ase_calcs
    ase_calcs.calculator = calc_mod
    for name, mod in (("ase", ase_mod), ("ase.calculators", ase_calcs),
                      ("ase.calculators.calculator", calc_mod)):
        monkeypatch.setitem(sys.modules, name, mod)

    ase_calc = make_ase_calculator(_molecule(md_setup), copy.deepcopy(md_setup["model"]),
                                   device="cpu")

    class FakeAtoms:
        positions = np.asarray(md_setup["R"], float)

    ase_calc.calculate(FakeAtoms())
    E_direct, F_direct = _calculator(md_setup).calculate(md_setup["R"])
    np.testing.assert_allclose(ase_calc.results["energy"], E_direct, rtol=1e-6)
    np.testing.assert_allclose(ase_calc.results["forces"], F_direct, rtol=1e-6)
    assert ase_calc.results["forces"].shape == (8, 3)


def test_maxwell_boltzmann_velocities_bit_equal_to_jax(md_setup):
    from gemnet_pytorch_tpu.md import maxwell_boltzmann_velocities as jax_mb
    from gemnet_pytorch_tpu_torch.md import ATOMIC_MASSES, maxwell_boltzmann_velocities

    Z = md_setup["Z"]
    v = maxwell_boltzmann_velocities(Z, 300.0, np.random.default_rng(7))
    np.testing.assert_array_equal(v, jax_mb(Z, 300.0, np.random.default_rng(7)))
    # no center-of-mass motion
    np.testing.assert_allclose((ATOMIC_MASSES[Z][:, None] * v).sum(0), 0.0, atol=1e-12)


def test_verlet_matches_jax(md_setup):
    """10 Velocity Verlet steps from the same molecule, velocities and
    weights: positions within rtol 1e-5 of the JAX MDSimulator's at every
    frame (fp32 forces agree to ~1e-6 of their size; a 0.5 fs step moves
    an atom ~1e-3 A, so the positions agree far inside the tolerance),
    energies within rtol 1e-5."""
    from gemnet_pytorch_tpu.data import Molecule as JaxMolecule
    from gemnet_pytorch_tpu.md import MDSimulator as JaxSimulator
    from gemnet_pytorch_tpu_torch.md import MDSimulator

    kw = dict(dynamics="verlet", max_steps=10, time=0.5, temperature=300, interval=1,
              traj_path=None, seed=3)
    jsim = JaxSimulator(JaxMolecule(md_setup["R"], md_setup["Z"], cutoff=5.0, int_cutoff=10.0,
                                    triplets_only=True),
                        md_setup["jax_model"], md_setup["variables"], **kw)
    sim = MDSimulator(_molecule(md_setup), copy.deepcopy(md_setup["model"]), device="cpu", **kw)
    np.testing.assert_array_equal(sim.v, jsim.v)
    traj, jtraj = sim.run(), jsim.run()
    assert len(traj) == len(jtraj) == 10
    np.testing.assert_allclose(np.stack(traj.frames_R), np.stack(jtraj.frames_R), rtol=1e-5)
    np.testing.assert_allclose(traj.frames_E, jtraj.frames_E, rtol=1e-5)
