"""Structures trained on in the window over its seconds on the host clock (the window ends in a value fetch of the last step's loss)."""


def read(run):
    return run.rec.units / run.rec.window_s
