"""Readings of the check's control, on the chip at a cell's own size, for
the limits in `limits/<cell>.json`.

    python3 benchmark/control.py --workload q-coll-train --seeds 11 12 13 --controls 3

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's (fp32 with TF32 off): with
TF32 products. For each seed it prints, as one JSON line, the numbers the
check compares for:
- "program": the program as configured against the fp32 reference, as a
  run checks it (training: its set-up's checked steps, no window; MD: a
  short window);
- "tf32" (the first `--controls` seeds): the reference in TF32 against the
  reference in fp32, on the inputs of a run of that seed (training: the
  batches of its first steps; MD: the positions of the program's short
  window);
- "half_batch" (training, with "tf32"): the fault of half of each batch
  left out, planted in the reference, against the reference;
- "bf16": with `--bf16`, the program in its own lower precision
  (compute_dtype bfloat16) against the fp32 reference, as a run checks it.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: the checkout's root, not benchmark/
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import check, loops, run  # noqa: E402


def train_control(cfg, mix, seed, device, controls, bf16):
    train = loops.find("train")
    rec = train.run(cfg, mix, seed, 0.0, False, device, time.time())
    c = rec.check
    batches = check.batches_of(c["pool"], c["batches"])
    fp32 = check.reference_train(cfg, c["sd"], batches, device)
    out = {"program": check.train_gaps(c["program"], fp32)}
    if controls:
        tf32 = check.reference_train(cfg, c["sd"], batches, device, tf32=True)
        out["tf32"] = check.train_gaps(tf32, fp32)
        # the fault of half the batch left out, planted in the reference: the
        # loss's mean over the first half of each batch's molecules
        half = []
        for N, Z, R, E, F in batches:
            k = len(N) // 2
            n = int(N[:k].sum())
            half.append((N[:k], Z[:n], R[:n], E[:k], F[:n]))
        out["half_batch"] = check.train_gaps(check.reference_train(cfg, c["sd"], half, device),
                                             fp32)
    if bf16:
        rec = train.run({**cfg, "compute_dtype": "bfloat16"}, mix, seed, 0.0, False, device,
                        time.time())
        out["bf16"] = check.train_gaps(rec.check["program"], fp32)
    return out


def md_control(cfg, mix, seed, device, controls, bf16, seconds):
    md = loops.find("md")
    rec = md.run(cfg, mix, seed, seconds, False, device, time.time())
    window = rec.check["window"]
    steps = check.md_sample(len(window), seed)
    pos = [window[i][0] for i in steps]
    Z, sd = rec.check["Z"], rec.check["sd"]
    fp32 = check.reference_md(cfg, sd, Z, pos, device)
    out = {"program": check.md_gaps(len(Z), [window[i][1:] for i in steps], fp32)}
    if controls:
        out["tf32"] = check.md_gaps(
            len(Z), check.reference_md(cfg, sd, Z, pos, device, tf32=True), fp32)
    if bf16:
        rec = md.run({**cfg, "compute_dtype": "bfloat16"}, mix, seed, seconds, False, device,
                     time.time())
        window = rec.check["window"]
        steps = check.md_sample(len(window), seed)
        ref = check.reference_md(cfg, rec.check["sd"], Z, [window[i][0] for i in steps],
                                 device)
        out["bf16"] = check.md_gaps(len(Z), [window[i][1:] for i in steps], ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=None,
                   help="read the controls on the first this many seeds (default: all)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seconds", type=float, default=3.0, help="MD: the short window")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    _, _, cfg, mix = run.cell(args.workload)
    device = torch.device(args.device)
    n_controls = len(args.seeds) if args.controls is None else args.controls
    for i, seed in enumerate(args.seeds):
        controls = i < n_controls
        if mix["loop"] == "train":
            out = train_control(cfg, mix, seed, device, controls, args.bf16)
        else:
            out = md_control(cfg, mix, seed, device, controls, args.bf16, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
