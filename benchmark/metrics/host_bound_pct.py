"""Share of the traced window in which the device is idle while the thread that launches is inside one of the program's spans, on the device trace's clock, %."""

from benchmark import program_spans


def read(run):
    return program_spans.host_bound_pct(run)
