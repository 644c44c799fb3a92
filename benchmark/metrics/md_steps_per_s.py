"""MD steps completed in the window over its seconds on the host clock (every step fetches E and F)."""


def read(run):
    return run.rec.units / run.rec.window_s
