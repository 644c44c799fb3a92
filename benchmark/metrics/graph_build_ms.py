"""Mean ms of the program's span `graph.build` (the native graph builder, in the provider's threads or MD's calculate) in the traced stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "graph.build")
