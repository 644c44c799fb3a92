"""Old against new: the kernels of an earlier copy of `segment_outer.cu`
(K1, K2 on fp32 and bf16 streams, and K4, their split3 mode) beside the
current ones, on the card, at the bench-small shapes.

    git archive 7edf67b gemnet_pytorch_tpu_torch/csrc | tar -x -C <dir>
    python -m gemnet_pytorch_tpu_torch.scripts.kernel_ab <dir>/gemnet_pytorch_tpu_torch/csrc

Run from the repository root (it takes its cases from `chip_smoke.py`). The
earlier `segment_outer.cu` is built with the same nvcc flags into
`_build/ab/` and bound with the C interface its entries had at 7edf67b:
K1 merging through merge_ptr / merge_seg (a second, one-block kernel),
without the merge tree and the row count; K2 and K4 as today. Per case (K1
and K2, forward and backward, at the triplet and the quadruplet shape, per
stream type), it checks both versions against the plain version
(chip_smoke's KERNEL_RTOL), K4 also against the exact fp32 one
(chip_smoke's SPLIT3_EXACT_RTOL) and the K4 forward at the quadruplet
shape, whose kernel shares its code with the bf16 K1, old against new bit
for bit; then times them by CUDA-graph replay (`_cuda.graph_ms`, device time per launch,
the forward's merge included) in turns: old, new, new, old; beside the
bound. At the triplet shape the earlier kernels run on the plan they had
(OLD_TRIPLET_ITEM_ROWS rows per work item), the current ones on today's.
Prints one line per case and a JSON list. Runs on the card only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..config import ModelConfig
from ..data import segment_plan, to_torch
from ..ops import _cuda
from ..ops import segment_outer as so

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_TRIPLET_ITEM_ROWS = 128
OLD_K1_ARGS = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _P]
OLD_ARGS = {"gemnet_segment_outer_sum_split3": _cuda._K4_FWD_ARGS,
            "gemnet_segment_gather_contract_split3": _cuda._K4_BWD_ARGS,
            **{f"gemnet_segment_outer_sum_{sfx}": OLD_K1_ARGS for sfx in ("f32", "bf16")},
            **{f"gemnet_segment_gather_contract_{sfx}": _cuda._K2_ARGS for sfx in ("f32", "bf16")}}


def build_old(csrc: Path) -> ctypes.CDLL:
    """The earlier segment_outer.cu's library, with its K1/K2/K4 entries bound."""
    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libsegment_outer-old.so"
    cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib_path), str(csrc / "segment_outer.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the earlier segment_outer.cu:\n{proc.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    for name, args in OLD_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, _I
    return lib


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"earlier {what} failed to launch: CUDA error {code}")


def old_plan(case):
    """The plan the earlier kernels had for a case's rows."""
    plan = case["plan"]
    if case["tag"] != "triplet":
        return plan
    return segment_plan(case["ids"].cpu().numpy(), plan.n_segments, OLD_TRIPLET_ITEM_ROWS,
                        case["ids"].device)


def old_call(lib, case):
    """The earlier kernel of a K1/K2 case, as a call returning a tuple."""
    a, b, plan = case["a"], case["b"], old_plan(case)
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    label = f"{case['kernel']} {case['tag']} {case['dtype']}"
    # the calls below hold `plan`, so its tensors outlive these pointers
    items = (plan.items.data_ptr(), plan.items.shape[0])
    merge = (plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel())
    if case["kernel"] == "K1":
        fn = getattr(lib, f"gemnet_segment_outer_sum_{case['dtype']}")
        # K1 merged through merge_ptr / merge_seg alone; K4's forward through
        # the tree, as today's K1 and K4
        split3 = case["dtype"] == "split3"
        tree = ((plan.tree_nodes.data_ptr(), plan.tree_parent.data_ptr(),
                 plan.tree_arrivals.data_ptr()) if split3 else ())

        def fwd():
            slots = plan.n_tree_slots if split3 else plan.n_partials
            out = torch.empty((S, n_seg, M), dtype=a.dtype, device=a.device)
            partial = torch.empty((slots, S, M), dtype=torch.float32, device=a.device)
            _check(fn(a.data_ptr(), b.data_ptr(), *items, *merge, *tree, partial.data_ptr(),
                      out.data_ptr(), *((n,) if split3 else ()), n_seg, S, M,
                      torch.cuda.current_stream().cuda_stream), label)
            return (out,)
        return fwd
    fn = getattr(lib, f"gemnet_segment_gather_contract_{case['dtype']}")
    cot = case["cot"]
    # K2 takes the rows' segment ids; K4's backward does not
    seg = case["ids"].to(torch.int64)
    rows = () if case["dtype"] == "split3" else (seg.data_ptr(),)

    def bwd():
        da = torch.empty_like(a)
        db = torch.empty_like(b)
        _check(fn(cot.data_ptr(), a.data_ptr(), b.data_ptr(), *rows, plan.items.data_ptr(),
                  plan.items.shape[0], da.data_ptr(), db.data_ptr(), n, n_seg, S, M,
                  torch.cuda.current_stream().cuda_stream), label)
        return da, db
    return bwd


def exact_call(case):
    """The exact fp32 plain K1/K2 of a split3 case."""
    a, b, ids = case["a"], case["b"], case["ids"]
    if case["kernel"] == "K1":
        return lambda: (so._outer_sum_plain(a, b, ids, case["plan"].n_segments),)
    return lambda: so._gather_contract_plain(case["cot"], a, b, ids)


def main(csrc: str, device="cuda") -> list[dict]:
    import chip_smoke

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("kernel_ab times kernels on a CUDA device")
    _cuda.set_matmul_precision()
    _cuda.build()
    lib = build_old(Path(csrc))
    power = chip_smoke.card_line()
    cfg = ModelConfig()
    batch_np, _ = chip_smoke.padded_batch(cfg, chip_smoke.bench_molecules(seed=0))
    cases = [c for c in chip_smoke.kernel_cases(cfg, to_torch(batch_np, device), device)
             if c["kernel"] in ("K1", "K2")]
    rows = []
    for case in cases:
        new, plain, _ = chip_smoke.case_functions(case)
        old = old_call(lib, case)
        split3 = case["dtype"] == "split3"
        refs = plain()
        exact = exact_call(case)() if split3 else None
        errs, outputs = {}, {}
        for name, fn in (("old", old), ("new", new)):
            outs = outputs[name] = fn()
            err, scale = chip_smoke.max_err(case, outs, refs)
            errs[name] = err
            chip_smoke.check(err <= chip_smoke.KERNEL_RTOL[case["dtype"]] * max(scale, 1.0),
                             f"{chip_smoke.case_label(case)}: the {name} kernel disagrees "
                             "with its plain version")
            if not split3:
                continue
            rel = [e / max(x, 1e-30) for e, x in (chip_smoke.max_err(case, (o,), (r,))
                                                  for o, r in zip(outs, exact))]
            chip_smoke.check(0 < min(rel) and max(rel) <= chip_smoke.SPLIT3_EXACT_RTOL,
                             f"{chip_smoke.case_label(case)}: the {name} kernel is "
                             f"{rel} of max |exact| from exact fp32")
        if split3 and case["kernel"] == "K1" and case["tag"] != "triplet":
            equal = all(torch.equal(o, x) for o, x in zip(outputs["old"], outputs["new"]))
            print(f"{chip_smoke.case_label(case)}: old and new bit-equal: {equal}", flush=True)
            chip_smoke.check(equal, f"{chip_smoke.case_label(case)}: the new K4 forward is not "
                             "bit-equal to the old")
        times = [_cuda.graph_ms(fn)[0] for fn in (old, new, new, old)]
        nbytes, flops = chip_smoke.case_cost(case)
        row = dict(kernel=case["kernel"], tag=case["tag"], dtype=case["dtype"],
                   old_ms=times[0], new_ms=times[1], new_ms_2=times[2], old_ms_2=times[3],
                   bound_ms=max(nbytes / chip_smoke.PEAK_BYTES_PER_S,
                                flops / chip_smoke.PEAK_FLOPS[case["dtype"]]) * 1e3,
                   old_err=errs["old"], new_err=errs["new"], card=power)
        print(f"{chip_smoke.case_label(case)}: old {times[0]:.4f} / {times[3]:.4f} ms, new "
              f"{times[1]:.4f} / {times[2]:.4f} ms, bound {row['bound_ms']:.4f} ms; max abs "
              f"err vs plain old {errs['old']:.3e}, new {errs['new']:.3e} [{power}]", flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    from chip_smoke import SmokeFailure

    try:
        print(json.dumps(main(sys.argv[1])))
    except (RuntimeError, SmokeFailure) as exc:
        print(f"kernel_ab: {exc}", file=sys.stderr)
        sys.exit(1)
