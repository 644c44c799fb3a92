"""Mean ms of the program's span `graph.neighbours` (the periodic search, the neighbour cap and the symmetric selection, inside `graph.build`, in the provider's threads) in the traced stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "graph.neighbours")
