"""Real triplet and quadruplet rows over the rows `pad_batch` padded them to, over the run, from the program's counters, %."""

from benchmark import program_spans


def read(run):
    real, padded = program_spans.counter("pad.real_rows"), program_spans.counter("pad.padded_rows")
    return 100.0 * real / padded if real is not None and padded else None
