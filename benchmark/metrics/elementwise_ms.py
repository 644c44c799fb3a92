"""Device ms a traced step of the elementwise kernels."""

from benchmark import readers


def read(run):
    return readers.group_ms(run, "elementwise")
