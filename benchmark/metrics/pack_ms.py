"""Mean ms of the program's span `pack` (`BatchPacker.pack`: a padded batch into one int32 row) in the traced stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "pack")
