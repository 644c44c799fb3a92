"""Share of the directed edges within the cutoff that the neighbour cap removed, over the run, from the program's counters `graph.cap_dropped` and `graph.cap_candidates`, %."""

from benchmark import program_spans


def read(run):
    dropped = program_spans.counter("graph.cap_dropped")
    candidates = program_spans.counter("graph.cap_candidates")
    return 100.0 * dropped / candidates if dropped is not None and candidates else None
