"""The direct-force model's FLOPs of the traced steps (flops_direct.py) over their time, % of the fp32 peak: the share of the whole training step's peak."""

from benchmark import flops_direct, roofline


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    total = sum(flops_direct.step_flops(run.cfg, c, "train") for c in run.rec.traced_counts)
    return 100.0 * total / run.trace.window_s / roofline.PEAKS["f32"]
