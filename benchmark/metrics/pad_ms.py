"""Mean ms of the program's span `pad` (`pad_batch`: padding and sort metadata, its argsorts included) in the traced stretch."""

from benchmark import program_spans


def read(run):
    return program_spans.mean_ms(run, "pad")
