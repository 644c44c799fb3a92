"""Old against new: the kernels of an earlier copy of `csrc/` (K1, K2 on
fp32 and bf16 streams, K4, their split3 mode, and the row gather P2) beside
the current ones, on the card, at the bench-small shapes and the gather
probe's.

    git archive cd71ed3 gemnet_pytorch_tpu_torch/csrc | tar -x -C <dir>
    python -m gemnet_pytorch_tpu_torch.scripts.kernel_ab <dir>/gemnet_pytorch_tpu_torch/csrc

Run from the repository root (it takes its cases from `chip_smoke.py`). The
earlier `segment_outer.cu` and `row_gather.cu` are built with the same nvcc
flags into `_build/ab/` and bound with today's C interface, which their
entries have had since df4c395 (an older commit's sources do not fit). Per
case (K1 and K2, forward and backward, at the triplet and the quadruplet
shape, per stream type; P2 at the probe's shape), it checks both versions
against the plain version (chip_smoke's KERNEL_RTOL; P2 bit for bit), K4
also against the exact fp32 one (chip_smoke's SPLIT3_EXACT_RTOL), and old
against new bit for bit wherever the output must not change: every case
but those in CHANGED (K4 at the triplet shape, whose forward from cd71ed3
on and backward after cd71ed3 sum in another order than df4c395's; their
lines still print whether old and new are bit-equal); then times them by
CUDA-graph replay (`_cuda.graph_ms`, device time per launch, the forward's
merge included) in turns: old, new, new, old; beside the bound. Both run on
the same plans. Prints one line per case and a JSON list. Runs on the card
only.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from .. import bench
from ..config import ModelConfig
from ..data import to_torch
from ..ops import _cuda
from ..ops import segment_outer as so
from ..perf import roofline

# the (kernel, tag, dtype) cases whose output changed (another order of
# summation) since df4c395, the oldest sources the C interface fits
CHANGED = {("K1", "triplet", "split3"), ("K2", "triplet", "split3")}
# earlier source -> the C entries bound from it
OLD_ENTRIES = {
    "segment_outer.cu": [f"gemnet_segment_{op}_{sfx}"
                         for op in ("outer_sum", "gather_contract")
                         for sfx in ("f32", "bf16", "split3")],
    "row_gather.cu": ["gemnet_row_gather_fm"],
}


def build_old(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The earlier sources' libraries (one nvcc each, started together),
    with their OLD_ENTRIES bound."""
    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in OLD_ENTRIES:
        lib_path = out_dir / f"lib{Path(source).stem}-old.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib_path), str(csrc / source)]
        jobs[source] = (lib_path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for source, (lib_path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {source}:\n{log}")
        lib = libs[source] = ctypes.CDLL(str(lib_path))
        for name in OLD_ENTRIES[source]:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _cuda._FUNCTIONS[name][1], ctypes.c_int
    return libs


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"earlier {what} failed to launch: CUDA error {code}")


def old_call(libs, case):
    """The earlier kernel of a K1/K2/P2 case, as a call returning a tuple."""
    import chip_smoke

    label = chip_smoke.case_label(case)
    if case["kernel"] == "P2":
        fn = libs["row_gather.cu"].gemnet_row_gather_fm
        tableT, idx = case["table"], case["idx"]
        M, N = tableT.shape

        def gather():
            out = torch.empty((M, idx.shape[0]), dtype=tableT.dtype, device=tableT.device)
            _check(fn(tableT.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M, idx.shape[0],
                      _stream()), label)
            return (out,)
        return gather
    lib = libs["segment_outer.cu"]
    a, b, plan = case["a"], case["b"], case["plan"]
    n, S = a.shape
    M = b.shape[1]
    n_seg = plan.n_segments
    # the calls below hold `plan`, so its tensors outlive these pointers
    items = (plan.items.data_ptr(), plan.items.shape[0])
    if case["kernel"] == "K1":
        fn = getattr(lib, f"gemnet_segment_outer_sum_{case['dtype']}")

        def fwd():
            out = torch.empty((S, n_seg, M), dtype=a.dtype, device=a.device)
            partial = torch.empty((plan.n_tree_slots, S, M), dtype=torch.float32,
                                  device=a.device)
            _check(fn(a.data_ptr(), b.data_ptr(), *items, plan.merge_ptr.data_ptr(),
                      plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                      plan.tree_nodes.data_ptr(), plan.tree_parent.data_ptr(),
                      plan.tree_arrivals.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                      n_seg, S, M, _stream()), label)
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
        _check(fn(cot.data_ptr(), a.data_ptr(), b.data_ptr(), *rows, *items, da.data_ptr(),
                  db.data_ptr(), n, n_seg, S, M, _stream()), label)
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
    libs = build_old(Path(csrc))
    power = chip_smoke.card_line()
    cfg = ModelConfig()
    batch_np, _, _ = bench.padded_batch(cfg, bench.molecules("small"))
    cases = [c for c in chip_smoke.kernel_cases(cfg, to_torch(batch_np, device), device)
             if c["kernel"] in ("K1", "K2", "P2")]
    rows = []
    for case in cases:
        label = chip_smoke.case_label(case)
        key = (case["kernel"], case["tag"], case["dtype"])
        new, plain, _ = chip_smoke.case_functions(case)
        old = old_call(libs, case)
        split3 = case["dtype"] == "split3"
        refs = plain()
        exact = exact_call(case)() if split3 else None
        errs, outputs = {}, {}
        for name, fn in (("old", old), ("new", new)):
            outs = outputs[name] = fn()
            err, scale = chip_smoke.max_err(case, outs, refs)
            errs[name] = err
            if case["kernel"] == "P2":
                chip_smoke.check(all(torch.equal(o, r) for o, r in zip(outs, refs)),
                                 f"{label}: the {name} kernel is not bit-equal to table[idx]")
            chip_smoke.check(err <= chip_smoke.KERNEL_RTOL[case["dtype"]] * max(scale, 1.0),
                             f"{label}: the {name} kernel disagrees with its plain version")
            if not split3:
                continue
            rel = [e / max(x, 1e-30) for e, x in (chip_smoke.max_err(case, (o,), (r,))
                                                  for o, r in zip(outs, exact))]
            print(f"{label}: the {name} kernel's max abs err / max |exact| "
                  f"{', '.join(f'{r:.3e}' for r in rel)}", flush=True)
            chip_smoke.check(0 < min(rel) and max(rel) <= chip_smoke.SPLIT3_EXACT_RTOL,
                             f"{label}: the {name} kernel is {rel} of max |exact| from exact "
                             "fp32")
        equal = all(torch.equal(o, x) for o, x in zip(outputs["old"], outputs["new"]))
        if key not in CHANGED:
            chip_smoke.check(equal, f"{label}: the unchanged kernel is not bit-equal to the old")
        times = [_cuda.graph_ms(fn)[0] for fn in (old, new, new, old)]
        nbytes, flops = roofline.kernel_cost(case["kernel"], case["dtype"], case["shape"])
        row = dict(kernel=case["kernel"], tag=case["tag"], dtype=case["dtype"],
                   old_ms=times[0], new_ms=times[1], new_ms_2=times[2], old_ms_2=times[3],
                   bound_ms=max(nbytes / roofline.H100_DATASHEET["hbm"],
                                flops / roofline.peak_flops(case["dtype"])) * 1e3,
                   old_err=errs["old"], new_err=errs["new"], bit_equal=equal, card=power)
        print(f"{label}: old {times[0]:.4f} / {times[3]:.4f} ms, new {times[1]:.4f} / "
              f"{times[2]:.4f} ms, bound {row['bound_ms']:.4f} ms; max abs err vs plain old "
              f"{errs['old']:.3e}, new {errs['new']:.3e}; old and new bit-equal {equal}"
              f"{' (changed)' if key in CHANGED else ''} [{power}]", flush=True)
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
