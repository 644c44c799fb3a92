"""The check's control fails on the chip: the reference in TF32, put in the
program's place, reads above at least one of the cell's limits (the
readings the limits were set from are in PERF.md; `control.py` takes them
at a cell's full size on more seeds)."""

import pytest
import torch

from benchmark import check, control, run

CELLS = [w["name"] for w in run.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_tf32_control_fails(workload, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 products exist only on the card")
    control.main(["--workload", workload, "--seeds", "2147483647"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    tf32 = json.loads(out)["tf32"]
    lim = check.limits(workload)
    assert any(tf32[k] > lim[k] for k in lim), (tf32, lim)
