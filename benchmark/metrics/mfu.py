"""The model's FLOPs of the traced steps (flops.py, for the loop's kind of step) over their time, % of the fp32 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run, run.rec.kind)
