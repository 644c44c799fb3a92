"""Mean host ms of train_on_batch: the copy into the static buffer and the enqueue of the captured step's replay."""


def read(run):
    return run.mean_span_ms("step_host")
