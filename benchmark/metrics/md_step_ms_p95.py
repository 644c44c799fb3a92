"""95th percentile of the window's MD step times, ms on the host clock."""

from benchmark import readers


def read(run):
    return readers.p95_ms(run, "md_step")
