"""Mean host ms a training step waits in next() of the provider's iterator (graph build, padding and packing not hidden by its prefetch threads)."""


def read(run):
    return run.mean_span_ms("data_wait")
