"""Share of their roofline that the bilinear kernels K1, K2 and K4 reach in the traced steps, %."""

from benchmark import readers


def read(run):
    return readers.bilinear_roofline(run)
