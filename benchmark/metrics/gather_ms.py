"""Device ms a traced step of the gathers and their backwards."""

from benchmark import readers


def read(run):
    return readers.group_ms(run, "gather", "gather_backward")
