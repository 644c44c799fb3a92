"""The caching allocator's peak reserved MiB over set-up and window, the CUDA graphs' pools in it."""


def read(run):
    return run.rec.peak_bytes / 2**20
