"""The port's scaling-factor fitting against the JAX package on the CPU: the
statistics every factor gathers on one batch against JAX's sown
`scale_stats`, `fit_scaling_factors` against JAX's on the same two batches,
and the entry point `python -m gemnet_pytorch_tpu_torch.fit_scaling` (its
json, its overwrite modes) against JAX's fit of the same weights on the same
batches. Outside a fitting context the factors gather nothing."""

import itertools
import json

import numpy as np
import pytest
import torch

from test_torch_mve import ALL_VARIANTS, _jax_variables, _port_sd
from test_torch_train import TINY, _provider

torch.set_num_threads(2)


def _jax_and_port(synthetic_npz, variant, n_batches=2):
    """A JAX model with variables (non-unit scales), the port's model with
    them carried, and the first `n_batches` batches."""
    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu_torch.config import ModelConfig
    from gemnet_pytorch_tpu_torch.models import GemNet

    it = _provider(synthetic_npz, variant["triplets_only"], True).get_dataset(
        "train", prefetch_workers=0)
    batches = [next(it) for _ in range(n_batches)]
    model = make_model(JaxConfig(**variant, **TINY))
    variables = _jax_variables(model, batches[0])
    cfg = ModelConfig(**variant, **TINY)
    port = GemNet(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    port.load_state_dict(_port_sd(variables["params"], variables, cfg), strict=True)
    return model, variables, port, batches


@pytest.mark.parametrize("name", ["dQ", "T"])
def test_stats_match_jax(synthetic_npz, name):
    """Every factor's [var_in·n, var_out·n, n] on one batch (through
    energy_and_forces, -dE/dR for T) against JAX's sown scale_stats, rtol
    1e-5; dQ reaches all 8 call sites (the quadruplet and direct-force
    factors among them)."""
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.models import energy_and_forces as jax_ef
    from gemnet_pytorch_tpu.models.layers import STATS_COLLECTION
    from gemnet_pytorch_tpu.training.fit_scaling import _find_stat
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.models.scaling import (
        collect_stats, scale_names_in_creation_order, scaling_factors)

    model, variables, port, (batch,) = _jax_and_port(synthetic_npz, ALL_VARIANTS[name], 1)
    # model.init's own scale_stats left out: sown again, they would add up
    clean = {k: variables[k] for k in ("params", "scale_factors")}
    _, _, aux = jax_ef(model, clean, {k: jnp.asarray(v) for k, v in batch.items()},
                       mutable=(STATS_COLLECTION,))
    names = scale_names_in_creation_order(port.cfg)
    with collect_stats(port) as stats:
        energy_and_forces(port, to_torch(batch, "cpu"))
    assert sorted(stats) == sorted(names)
    for n in names:
        assert len(stats[n]) == 1, n
        ref = np.asarray(_find_stat(aux[STATS_COLLECTION], n))
        np.testing.assert_allclose(stats[n][0].numpy(), ref, rtol=1e-5, err_msg=n)
        assert ref[0] > 0 and ref[2] >= 1
    # off again after the block, and never on outside it
    assert all(f.stats is None for f in scaling_factors(port).values())
    energy_and_forces(port, to_torch(batch, "cpu"))
    assert all(len(v) == 1 for v in stats.values())


def test_collect_stats_selects_factors(synthetic_npz):
    from gemnet_pytorch_tpu_torch.data import to_torch
    from gemnet_pytorch_tpu_torch.models import energy_and_forces
    from gemnet_pytorch_tpu_torch.models.scaling import collect_stats

    _, _, port, (batch,) = _jax_and_port(synthetic_npz, ALL_VARIANTS["dT"], 1)
    with collect_stats(port, ["AtomUpdate_1_sum"]) as stats:
        energy_and_forces(port, to_torch(batch, "cpu"))
        energy_and_forces(port, to_torch(batch, "cpu"))
    assert list(stats) == ["AtomUpdate_1_sum"] and len(stats["AtomUpdate_1_sum"]) == 2
    with pytest.raises(KeyError, match="QuadInteraction_1_had_rbf"):
        with collect_stats(port, ["QuadInteraction_1_had_rbf"]):
            pass


@pytest.mark.parametrize("name", ["dQ", "T"])
def test_fit_scaling_factors_match_jax(synthetic_npz, tmp_path, name):
    """All factors fitted one at a time from non-unit starting values on the
    same two batches (cycled): the port's against JAX's within rtol 1e-4,
    the json's keys and comment as JAX writes them; then `skip_fitted`
    leaves fitted factors alone and fits the one set back to 1.0."""
    from gemnet_pytorch_tpu.models.scaling import scales_to_dict
    from gemnet_pytorch_tpu.training.fit_scaling import fit_scaling_factors as jax_fit
    from gemnet_pytorch_tpu_torch.models.scaling import scaling_factors
    from gemnet_pytorch_tpu_torch.training import fit_scaling_factors

    model, variables, port, batches = _jax_and_port(synthetic_npz, ALL_VARIANTS[name])
    jax_file, port_file = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    ref = scales_to_dict(jax_fit(model, variables, itertools.cycle(batches), n_batches=2,
                                 scale_file=jax_file, comment="tiny")["scale_factors"])
    fitted = fit_scaling_factors(port, itertools.cycle(batches), n_batches=2,
                                 scale_file=port_file, comment="tiny")
    assert sorted(fitted) == sorted(ref)
    for n, v in ref.items():
        np.testing.assert_allclose(fitted[n], v, rtol=1e-4, err_msg=n)
        assert float(scaling_factors(port)[n].scale_factor) == np.float32(fitted[n])
    with open(jax_file) as f, open(port_file) as g:
        jdata, pdata = json.load(f), json.load(g)
    assert list(pdata) == list(jdata) and pdata["comment"] == "tiny"
    for n in ref:
        np.testing.assert_allclose(pdata[n], jdata[n], rtol=1e-4)

    # skip_fitted: only the factor back at 1.0 is fitted again
    again = next(iter(fitted))
    scaling_factors(port)[again].scale_factor.fill_(1.0)
    refit = fit_scaling_factors(port, itertools.cycle(batches), n_batches=2,
                                scale_file=port_file, skip_fitted=True, overwrite_file=False)
    assert list(refit) == [again]
    with open(port_file) as f:
        assert json.load(f)["comment"] == "tiny"


def _write_config(tmp_path, **over):
    import yaml

    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(dict(TINY, data_seed=0, tfseed=5, comment="tiny", **over)))
    return str(path)


def test_entry_point_matches_jax(tmp_path, monkeypatch):
    """`python -m gemnet_pytorch_tpu_torch.fit_scaling` (main) on a tiny
    YAML config: direct forces forced, a synthetic dataset beside the scale
    file, the json with every factor of GemNet-dQ and the config's comment;
    with the JAX weights for the same seed carried into its model, its
    factors equal JAX's fit on the same batches within rtol 1e-4. Then
    --overwrite-mode 2 keeps the fitted file as it is (every factor fitted),
    and any other mode leaves it alone."""
    import jax
    import jax.numpy as jnp

    from gemnet_pytorch_tpu.config import ModelConfig as JaxConfig
    from gemnet_pytorch_tpu.data import DataContainer, DataProvider
    from gemnet_pytorch_tpu.models import make_model
    from gemnet_pytorch_tpu.training.fit_scaling import fit_scaling_factors as jax_fit
    from gemnet_pytorch_tpu_torch import fit_scaling as entry
    from gemnet_pytorch_tpu_torch.compat import state_dict_from_jax
    from gemnet_pytorch_tpu_torch.data import make_dataset
    from gemnet_pytorch_tpu_torch.models import GemNet

    dataset = make_dataset(str(tmp_path / "val.npz"), n_molecules=16, min_atoms=4, max_atoms=8,
                           seed=0)
    jcfg = JaxConfig(**TINY, direct_forces=True)
    jax_model = make_model(jcfg)

    def provider():
        c = DataContainer(dataset, cutoff=5.0, int_cutoff=10.0)
        return DataProvider(c, 0, 8, 4, seed=0, shuffle=True, random_split=True)

    sample = {k: jnp.asarray(v) for k, v in
              next(provider().get_dataset("val", prefetch_workers=0)).items()}
    variables = jax.tree_util.tree_map(np.asarray, dict(jax_model.init(jax.random.PRNGKey(5),
                                                                       sample)))

    def carried(cfg, *, generator, device):
        assert cfg.direct_forces
        model = GemNet(cfg, generator=generator, device=device)
        model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
        return model

    monkeypatch.setattr(entry, "GemNet", carried)
    scale_file = str(tmp_path / "scaling_factors.json")
    args = ["--config", _write_config(tmp_path), "--n-batches", "2", "--scale-file", scale_file,
            "--dataset", dataset, "--batch-size", "4", "--device", "cpu"]
    fitted = entry.main(args)
    jax_file = str(tmp_path / "jax.json")
    jax_fit(jax_model, variables, provider().get_dataset("val", prefetch_workers=0), n_batches=2,
            scale_file=jax_file, comment="tiny")
    with open(scale_file) as f, open(jax_file) as g:
        got, ref = json.load(f), json.load(g)
    n_blocks = TINY["num_blocks"]
    assert list(got) == list(ref) and got["comment"] == "tiny"
    assert len(fitted) == len(got) - 1 == 6 * n_blocks + 2 * (n_blocks + 1)
    for n in fitted:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-4, err_msg=n)

    assert entry.main(args + ["--overwrite-mode", "2"]) == {}
    with open(scale_file) as f:
        assert json.load(f) == got
    assert entry.main(args + ["--overwrite-mode", "3"]) is None


def test_entry_point_synthetic_dataset(tmp_path):
    """Without a dataset, `run` makes a synthetic one beside the scale file
    and fits every factor to a finite, positive value."""
    from gemnet_pytorch_tpu_torch import fit_scaling as entry

    scale_file = str(tmp_path / "out" / "scaling_factors.json")
    (tmp_path / "out").mkdir()
    fitted = entry.run(dict(TINY, triplets_only=True, data_seed=0), device="cpu", n_batches=1,
                       scale_file=scale_file, batch_size=4)
    assert (tmp_path / "out" / "fit_scaling_synthetic.npz").exists()
    assert len(fitted) == 3 * TINY["num_blocks"] + 2 * (TINY["num_blocks"] + 1)
    assert all(np.isfinite(v) and v > 0 for v in fitted.values())
