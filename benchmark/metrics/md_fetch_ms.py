"""Mean ms of the program's span `md.fetch` (the calculator's host waiting for E and F of the predict) in the traced stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "md.fetch")
