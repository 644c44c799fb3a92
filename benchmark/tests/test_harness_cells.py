"""Every cell of BENCHMARK.json runs end to end on the CPU at small widths,
through the program's plain versions, and its result line holds what the
contract asks for."""

import json

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

CELLS = [w["name"] for w in run.manifest()["workloads"]]
SEED = 2**31 + 17  # a seed beyond 32 signed bits


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_cpu(workload, trace):
    torch.set_num_threads(2)
    m = run.manifest()
    r = run.run(workload, SEED, 0.5, bool(trace), device="cpu",
                overrides=tiny.overrides(workload))
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(json.load(open(
        f"{run.HERE}/limits/{workload}.json"))["limits"])
    if trace:
        names = {p["name"] for p in m["per_layer"]
                 if workload in p.get("workloads", [workload])}
        # the CPU has no device trace: the host spans alone are read
        assert set(r["metrics"]) <= names
        assert r["device"]["window_s"] > 0
    else:
        names = {e["name"] for e in m["end_to_end"] if workload in e.get("workloads", [workload])}
        assert set(r["metrics"]) == names
        assert all(v["value"] > 0 for k, v in r["metrics"].items() if k != "peak_mib")
    json.dumps(r)


def test_same_seed_same_inputs():
    from benchmark import workload
    from benchmark.loops import train
    mix = {**run.load_json("traffic", "coll32.json"), **tiny.traffic("train")}
    a, b = workload.pool(mix), workload.pool(mix)
    assert all((a[k] == b[k]).all() for k in a)
    s1, s2 = train.selections(24, 4, train.provider_seed(SEED)), train.selections(
        24, 4, train.provider_seed(SEED))
    assert all((next(s1) == next(s2)).all() for _ in range(10))


def test_selections_are_the_providers():
    """The batches the check rebuilds are the ones the program's provider
    draws."""
    import os
    import tempfile

    import numpy as np

    from benchmark import workload
    from benchmark.loops import train
    from gemnet_pytorch_tpu_torch.data import DataContainer, DataProvider
    mix = {**run.load_json("traffic", "coll32.json"), **tiny.traffic("train")}
    pool = workload.pool(mix)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "pool.npz")
        np.savez(path, **pool)
        provider = DataProvider(DataContainer(path, 5.0, 10.0), 24, 0, 4,
                                seed=train.provider_seed(SEED), shuffle=True, random_split=True)
        it = provider.get_dataset("train", prefetch_workers=0)
        sels = train.selections(24, 4, train.provider_seed(SEED))
        for _ in range(9):  # past an epoch
            batch, ids = next(it), next(sels)
            n = int(pool["N"][ids].sum())
            atoms = np.concatenate([np.arange(a, b) for a, b in zip(
                np.cumsum(pool["N"])[ids] - pool["N"][ids], np.cumsum(pool["N"])[ids])])
            assert (batch["Z"][:n] == pool["Z"][atoms]).all()
            assert np.allclose(batch["R"][:n], pool["R"][atoms])
