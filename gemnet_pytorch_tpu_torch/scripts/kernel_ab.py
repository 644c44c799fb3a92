"""Old against new: K2 and K3 from an earlier copy of their sources beside
the current ones, on the card, at the bench-small shapes.

    git archive <commit> gemnet_pytorch_tpu_torch/csrc | tar -x -C <dir>
    python -m gemnet_pytorch_tpu_torch.scripts.kernel_ab <dir>/gemnet_pytorch_tpu_torch/csrc

Run from the repository root (it takes its cases from `chip_smoke.py`). The
earlier `segment_outer.cu` and `expand_gather.cu` are built with the same
nvcc flags into `_build/ab/` and bound with the C interface of the first
design: K2 without the rows' segment ids, K3 with a separate merge kernel
and no arrival counters, on 32-row items. Per case (K2 and K3, fp32 and
bf16 streams), it checks both versions against the plain version
(chip_smoke's KERNEL_RTOL), then times them by CUDA-graph replay
(`_cuda.graph_ms`, device time per launch) in turns: old, new, new, old;
then the library call where there is one; beside the bound. Prints one line
per case and a JSON list. Runs on the card only.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_K2_ARGS = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P]
OLD_K3_ARGS = [_P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P]
OLD_K3_ITEM_ROWS = 32


def build_old(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The earlier sources' libraries, built together (one nvcc each)."""
    out_dir = _cuda.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in ("segment_outer.cu", "expand_gather.cu"):
        lib = out_dir / f"lib{Path(source).stem}-old.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(csrc / source)]
        jobs[source] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for source, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {source}:\n{log}")
        libs[source] = ctypes.CDLL(str(lib))
    for suffix in ("f32", "bf16"):
        fn = getattr(libs["segment_outer.cu"], f"gemnet_segment_gather_contract_{suffix}")
        fn.argtypes, fn.restype = OLD_K2_ARGS, _I
        fn = getattr(libs["expand_gather.cu"], f"gemnet_sorted_segsum_{suffix}")
        fn.argtypes, fn.restype = OLD_K3_ARGS, _I
    return libs


def _check(code: int, what: str) -> None:
    if code:
        raise RuntimeError(f"earlier {what} failed to launch: CUDA error {code}")


def old_call(libs, case):
    """The earlier kernel of a K2 or K3 case, as a call returning a tuple."""
    suffix = _cuda.DTYPE_SUFFIX[torch.bfloat16 if case["dtype"] == "bf16" else torch.float32]
    if case["kernel"] == "K2":
        fn = getattr(libs["segment_outer.cu"], f"gemnet_segment_gather_contract_{suffix}")
        cot, a, b, plan = case["cot"], case["a"], case["b"], case["plan"]
        n, S = a.shape
        M = b.shape[1]

        def k2():
            da = torch.empty_like(a)
            db = torch.empty_like(b)
            _check(fn(cot.data_ptr(), a.data_ptr(), b.data_ptr(), plan.items.data_ptr(),
                      plan.items.shape[0], da.data_ptr(), db.data_ptr(), plan.n_segments, S, M,
                      torch.cuda.current_stream().cuda_stream), "K2")
            return da, db
        return k2
    fn = getattr(libs["expand_gather.cu"], f"gemnet_sorted_segsum_{suffix}")
    x, perm, n_seg = case["x"], case["perm"], case["plan"].n_segments
    plan = segment_plan(case["sorted"].cpu().numpy(), n_seg, OLD_K3_ITEM_ROWS, x.device)
    M = x.shape[1]

    def k3():
        out = torch.empty((n_seg, M), dtype=x.dtype, device=x.device)
        partial = torch.empty((plan.n_partials, M), dtype=torch.float32, device=x.device)
        _check(fn(x.data_ptr(), perm.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                  plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                  partial.data_ptr(), out.data_ptr(), M,
                  torch.cuda.current_stream().cuda_stream), "K3")
        return (out,)
    return k3


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
    batch_np, _ = chip_smoke.padded_batch(cfg, chip_smoke.bench_molecules(seed=0))
    cases = [c for c in chip_smoke.kernel_cases(cfg, to_torch(batch_np, device), device)
             if c["kernel"] in ("K2", "K3") and c["dtype"] in ("f32", "bf16")]
    rows = []
    for case in cases:
        new, plain, library = chip_smoke.case_functions(case)
        old = old_call(libs, case)
        refs = plain()
        tol = chip_smoke.KERNEL_RTOL[case["dtype"]]
        errs = {}
        for name, fn in (("old", old), ("new", new)):
            err, scale = chip_smoke.max_err(case, fn(), refs)
            errs[name] = err
            chip_smoke.check(err <= tol * max(scale, 1.0),
                             f"{chip_smoke.case_label(case)}: the {name} kernel disagrees "
                             "with its plain version")
        times = [_cuda.graph_ms(fn)[0] for fn in (old, new, new, old)]
        nbytes, flops = chip_smoke.case_cost(case)
        row = dict(kernel=case["kernel"], tag=case["tag"], dtype=case["dtype"],
                   old_ms=times[0], new_ms=times[1], new_ms_2=times[2], old_ms_2=times[3],
                   library_ms=_cuda.graph_ms(library)[0] if library else None,
                   bound_ms=max(nbytes / chip_smoke.PEAK_BYTES_PER_S,
                                flops / chip_smoke.PEAK_FLOPS[case["dtype"]]) * 1e3,
                   old_err=errs["old"], new_err=errs["new"], card=power)
        lib = f"{row['library_ms']:.4f}" if row["library_ms"] is not None else "null"
        print(f"{chip_smoke.case_label(case)}: old {times[0]:.4f} / {times[3]:.4f} ms, new "
              f"{times[1]:.4f} / {times[2]:.4f} ms, library {lib} ms, bound "
              f"{row['bound_ms']:.4f} ms; max abs err vs plain old {errs['old']:.3e}, new "
              f"{errs['new']:.3e} [{power}]", flush=True)
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
