"""Share of the traced steps' time with no kernel, memcpy or memset on the device, %."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
