"""Readings of the check's control for the periodic training cells (loop
"train_pbc", `check_pbc.py`), on the chip at a cell's own size, for the
limits in `limits/<cell>.json`: what `control.py` reads for the other
training cells.

    python3 benchmark/control_pbc.py --workload dt-oc20-train --seeds 11 12 13 --controls 3

For each seed, one JSON line: "program", the program's checked first steps
against the fp32 reference, as a run checks them; on the first
`--controls` seeds "tf32", the reference with TF32 products against the
reference in fp32 on the same batches (the nearest precision below the
configuration's), and "half_batch", the fault of half of each batch left
out, planted in the reference. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: the checkout's root, not benchmark/
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import check, check_pbc, loops, run  # noqa: E402


def control(cfg, mix, seed, device, controls):
    rec = loops.find("train_pbc").run(cfg, mix, seed, 0.0, False, device, time.time())
    c = rec.check
    batches = check_pbc.batches_of(c["pool"], c["batches"])
    fp32 = check_pbc.reference_train(cfg, c["sd"], batches, device)
    out = {"program": check.train_gaps(c["program"], fp32)}
    if controls:
        tf32 = check_pbc.reference_train(cfg, c["sd"], batches, device, tf32=True)
        out["tf32"] = check.train_gaps(tf32, fp32)
        half = []
        for N, Z, R, E, F, cell, tags in batches:
            k = len(N) // 2
            n = int(N[:k].sum())
            half.append((N[:k], Z[:n], R[:n], E[:k], F[:n], cell[:k], tags[:n]))
        out["half_batch"] = check.train_gaps(
            check_pbc.reference_train(cfg, c["sd"], half, device), fp32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=None,
                   help="read the controls on the first this many seeds (default: all)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    _, _, cfg, mix = run.cell(args.workload)
    device = torch.device(args.device)
    n_controls = len(args.seeds) if args.controls is None else args.controls
    for i, seed in enumerate(args.seeds):
        out = control(cfg, mix, seed, device, i < n_controls)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
