"""The port's serving calculator against the JAX package's GemNetCalculator
on the same molecule and weights (GemNet-Q, -dE/dR), and its forces against
finite differences of its own energies."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CFG = dict(num_spherical=3, num_radial=3, num_blocks=1, emb_size_atom=16,
           emb_size_edge=16, emb_size_trip=8, emb_size_quad=4, emb_size_rbf=4,
           emb_size_cbf=4, emb_size_sbf=4, emb_size_bil_quad=4, emb_size_bil_trip=8)


@pytest.fixture(scope="module")
def calculators():
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.data import Molecule as JaxMolecule
    from gemnet_pytorch_tpu.md import GemNetCalculator as JaxCalculator
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.data.synthetic import random_molecule
    from gemnet_pytorch_tpu_torch.md import GemNetCalculator
    from gemnet_pytorch_tpu_torch.models import GemNet

    Z, R = random_molecule(np.random.default_rng(0), 7)
    jmol = JaxMolecule(R, Z, cutoff=5.0, int_cutoff=10.0)
    model = make_model(JaxConfig(**CFG))
    batch = {k: jnp.asarray(v) for k, v in jmol.get().items()}
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), batch))
    rng = np.random.default_rng(2)
    variables["scale_factors"] = jax.tree_util.tree_map(
        lambda _: np.float32(rng.uniform(0.5, 2.0)), variables["scale_factors"])

    cfg = ModelConfig(**CFG)
    port_model = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    port_model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    port = GemNetCalculator(Molecule(R, Z, cutoff=5.0, int_cutoff=10.0), port_model, device="cpu")
    return dict(port=port, jax=JaxCalculator(jmol, model, variables), R=R, Z=Z)


def test_calculator_matches_jax(calculators):
    """Energies within 2e-4 and forces within 5e-4 (tests/test_model_parity.py's
    -dE/dR tolerances) over a few geometries; shapes and the frozen model."""
    port, ref, R = calculators["port"], calculators["jax"], calculators["R"]
    rng = np.random.default_rng(5)
    for step in range(3):
        Rs = R + rng.normal(scale=0.05, size=R.shape).astype(np.float32)
        e, f = port.calculate(Rs)
        e_ref, f_ref = ref.calculate(Rs)
        assert isinstance(e, float) and f.shape == (len(R), 3) and f.dtype == np.float32
        np.testing.assert_allclose(e, e_ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(f, f_ref, rtol=5e-4, atol=5e-4)
    assert not any(p.requires_grad for p in port.model.parameters())


def test_calculator_forces_are_negative_gradient(calculators):
    """Central differences of the port's energies (float64 positions)."""
    port = calculators["port"]
    R = np.array(calculators["R"], np.float64)
    _, F0 = port.calculate(R)
    eps = 1e-3
    for i, d in [(0, 0), (3, 1), (5, 2)]:
        Rp, Rm = R.copy(), R.copy()
        Rp[i, d] += eps
        Rm[i, d] -= eps
        fd = -(port.calculate(Rp)[0] - port.calculate(Rm)[0]) / (2 * eps)
        np.testing.assert_allclose(fd, F0[i, d], rtol=5e-2, atol=5e-3)


def test_calculator_atom_energies(calculators):
    """add_atom_energies adds the QM7-X reference energy of every atom."""
    from gemnet_pytorch_tpu_torch.data import Molecule
    from gemnet_pytorch_tpu_torch.md import ATOM_ENERGIES, GemNetCalculator

    model, R = calculators["port"].model, calculators["R"]
    Z = np.array([6, 6, 7, 8, 1, 1, 1])  # elements with a reference energy
    calc = [GemNetCalculator(Molecule(R, Z, cutoff=5.0, int_cutoff=10.0), model, device="cpu",
                             add_atom_energies=add) for add in (False, True)]
    e_plain, e_atoms = (c.calculate()[0] for c in calc)
    np.testing.assert_allclose(e_atoms, e_plain + sum(ATOM_ENERGIES[int(z)] for z in Z),
                               rtol=1e-12)
