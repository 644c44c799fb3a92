"""Seconds of the program's CUDA graph captures (warm-up calls included) over the run, its counter `capture_s`: a part of setup_s."""

from benchmark import program_spans


def read(run):
    return program_spans.counter("capture_s")
