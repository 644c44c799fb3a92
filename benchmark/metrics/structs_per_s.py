"""Structures trained on in the window over its seconds on the host clock,
as a per-layer reading: in a cell whose rate the host's data pipeline sets,
and so the host's speed, the rate is no end-to-end metric there."""


def read(run):
    return run.rec.units / run.rec.window_s
