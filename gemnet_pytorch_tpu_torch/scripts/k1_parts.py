"""K1 (segment_outer_sum, fp32 and bf16 streams) and K4 at the triplet
shape (the forward, K1's warp kernel with split3 products; the backward,
gather_contract_split3_warp) with parts of their kernels switched off, on
the card, at the bench-small shapes: where a launch's time goes.

    python -m gemnet_pytorch_tpu_torch.scripts.k1_parts

Run from the repository root (it takes its cases from `chip_smoke.py`).
Builds copies of `csrc/segment_outer.cu` into `_build/parts/`, each with
one part switched off or changed by editing the source text (only the
time is read; a part switched off makes the output wrong):
  full      the kernels as they are;
  no_merge  a split segment's partial tiles are not added (no merge tree);
  no_math   no products (the copies, stores and merge stay; the K4
            backward: no row loop, its copies and the a values' split stay);
  copies    triplet only: the rows (K4 backward: and the cotangent tiles)
            are copied and nothing else is done;
  no_cot    the K4 backward only: the cotangent tiles are not copied;
  rows1, rows2  the K4 backward only: da's reduce-scatter takes one or two
            rows at a time, not four (the output stays right);
  two_blocks  the K4 backward only: its launch asks for 4 KB more shared
            memory a block, so two blocks fit an SM, not three.
Times each by CUDA-graph replay (`_cuda.graph_ms`, device time per
launch) at both shapes and stream types, the triplet also with work items
of 16, 32, 64 and 128 rows (the K4 forward's and backward's parts at the
triplet shape too, on its 16-row plan); and K4 at the triplet shape
(split3, forward and backward) with 16- and 128-row items. Prints one line
each. Runs on the card only.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from ..config import ModelConfig
from ..data import segment_plan, to_torch
from ..ops import _cuda
from ..ops import segment_outer as so

# part -> (text in segment_outer.cu, its replacement)
PARTS = {
    "full": [],
    "no_merge": [
        ("      if (it.w >= 0) {\n        warp_merge_up(",
         "      if (false) {\n        warp_merge_up("),
        ("    if (d.slot >= 0) {\n      merge_up<1>(", "    if (false) {\n      merge_up<1>("),
    ],
    "no_math": [
        ("    for (int t = 0; t < nr; ++t) {\n      const float2 bv",
         "    for (int t = 0; t < 0; ++t) {\n      const float2 bv"),
        ("      for (int h = 0; 16 * h < d.nr; ++h) {", "      for (int h = 0; 16 * h < 0; ++h) {"),
        ("    for (int t = warp; t < d.nr; t += kConsumerWarps) {",
         "    for (int t = warp; t < 0; t += kConsumerWarps) {"),
        ("      for (int t0 = 0; t0 < nr; t0 += kContractRows) {",
         "      for (int t0 = 0; t0 < 0; t0 += kContractRows) {"),
    ],
    "copies": [
        ("    if ((cur.c + 1) * kWarpRows >= cur.it.z - cur.it.y) {  // the item's last chunk",
         "    if (false) {  // the item's last chunk"),
        ("    if (nr > 0) {  // warp-uniform", "    if (false) {  // warp-uniform"),
    ],
    "no_cot": [
        ("      if (c.c == 0) {\n        float* ct", "      if (false) {\n        float* ct"),
    ],
    "rows1": [("constexpr int kContractRows = 4;", "constexpr int kContractRows = 1;")],
    "rows2": [("constexpr int kContractRows = 4;", "constexpr int kContractRows = 2;")],
    "two_blocks": [
        ("      const size_t smem = warp_contract_smem(S, M);",
         "      const size_t smem = warp_contract_smem(S, M) + 4096;"),
    ],
}
# the parts timed for K1 and the K4 forward, and for the K4 backward
FORWARD_PARTS = ("full", "no_merge", "no_math", "copies")
BACKWARD_PARTS = ("full", "no_math", "copies", "no_cot", "rows1", "rows2", "two_blocks")
TRIPLET_ITEM_ROWS = (16, 32, 64, 128)


def build_parts() -> dict[str, ctypes.CDLL]:
    """One library per part, all nvcc processes started together."""
    src = (_cuda.CSRC / "segment_outer.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for part, edits in PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"part {part}: {old!r} is not in segment_outer.cu")
            text = text.replace(old, new)
        cu = out_dir / f"{part}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{part}.so"
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs[part] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for part, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on part {part}:\n{log}")
        libs[part] = ctypes.CDLL(str(lib))
        for sfx in ("f32", "bf16", "split3"):
            fn = getattr(libs[part], f"gemnet_segment_outer_sum_{sfx}")
            fn.argtypes, fn.restype = _cuda._K1_ARGS, ctypes.c_int
        fn = libs[part].gemnet_segment_gather_contract_split3
        fn.argtypes, fn.restype = _cuda._K4_BWD_ARGS, ctypes.c_int
    return libs


def k1_call(lib, case, plan):
    """K1 (or, for a split3 case, K4's forward) of `lib` on `plan`."""
    a, b = case["a"], case["b"]
    n, S = a.shape
    M = b.shape[1]
    fn = getattr(lib, f"gemnet_segment_outer_sum_{case['dtype']}")

    def call():
        out = torch.empty((S, plan.n_segments, M), dtype=a.dtype, device=a.device)
        partial = torch.empty((plan.n_tree_slots, S, M), dtype=torch.float32, device=a.device)
        code = fn(a.data_ptr(), b.data_ptr(), plan.items.data_ptr(), plan.items.shape[0],
                  plan.merge_ptr.data_ptr(), plan.merge_seg.data_ptr(), plan.merge_seg.numel(),
                  plan.tree_nodes.data_ptr(), plan.tree_parent.data_ptr(),
                  plan.tree_arrivals.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
                  plan.n_segments, S, M, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"K1 failed to launch: CUDA error {code}")
        return out
    return call


def k4_backward_call(lib, a, b, cot, plan):
    """The K4 backward of `lib` on `plan`."""
    n, S = a.shape
    M = b.shape[1]
    fn = lib.gemnet_segment_gather_contract_split3

    def call():
        da, db = torch.empty_like(a), torch.empty_like(b)
        code = fn(cot.data_ptr(), a.data_ptr(), b.data_ptr(), plan.items.data_ptr(),
                  plan.items.shape[0], da.data_ptr(), db.data_ptr(), n, plan.n_segments, S, M,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the K4 backward failed to launch: CUDA error {code}")
        return da, db
    return call


def main(device="cuda") -> None:
    import chip_smoke

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("k1_parts times kernels on a CUDA device")
    _cuda.set_matmul_precision()
    libs = build_parts()
    power = chip_smoke.card_line()
    cfg = ModelConfig()
    batch_np, _ = chip_smoke.padded_batch(cfg, chip_smoke.bench_molecules(seed=0))
    cases = [c for c in chip_smoke.kernel_cases(cfg, to_torch(batch_np, device), device)
             if c["kernel"] == "K1" and (c["dtype"] != "split3" or c["tag"] == "triplet")]
    for case in cases:
        ids, n_seg = case["ids"], case["plan"].n_segments
        tiled = case["tag"] == "triplet" and case["dtype"] != "split3"
        rows = TRIPLET_ITEM_ROWS if tiled else (None,)
        for part in FORWARD_PARTS:
            lib = libs[part]
            if part == "copies" and case["tag"] != "triplet":
                continue
            for r in rows:
                plan = case["plan"] if r is None else segment_plan(ids.cpu().numpy(), n_seg, r,
                                                                   device)
                ms = _cuda.graph_ms(k1_call(lib, case, plan))
                items = "" if r is None else f", {r}-row items"
                name = "K4 forward" if case["dtype"] == "split3" else "K1"
                print(f"{name} {case['tag']} {case['dtype']} {part}{items}: {ms[0]:.4f} ms "
                      f"({ms[1]:.4f}-{ms[2]:.4f}) [{power}]", flush=True)
    trip = [c for c in cases if c["tag"] == "triplet" and c["dtype"] == "f32"][0]
    a, b, ids, n_seg = trip["a"], trip["b"], trip["ids"], trip["plan"].n_segments
    cot = torch.randn(a.shape[1], n_seg, b.shape[1], device=device)
    for part in BACKWARD_PARTS:
        ms = _cuda.graph_ms(k4_backward_call(libs[part], a, b, cot, trip["plan"]))
        print(f"K4 backward triplet split3 {part}, 16-row items: {ms[0]:.4f} ms "
              f"({ms[1]:.4f}-{ms[2]:.4f}) [{power}]", flush=True)
    for r in (16, 128):
        plan = segment_plan(ids.cpu().numpy(), n_seg, r, device)
        fwd = _cuda.graph_ms(lambda: so.outer_sum(a, b, ids, plan, "split3"))[0]
        bwd = _cuda.graph_ms(lambda: so.gather_contract(cot, a, b, ids, plan, "split3"))[0]
        print(f"K4 triplet, {r}-row items: forward {fwd:.4f} ms, backward {bwd:.4f} ms "
              f"[{power}]", flush=True)


if __name__ == "__main__":
    main()
