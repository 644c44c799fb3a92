"""Seconds from the process's start to the first timed step: imports, the kernels (built on a checkout's first run), the data, the weights, the captures and the checked first steps."""


def read(run):
    return run.rec.setup_s
