"""Device ms a traced step in NCCL's kernels (names starting "nccl") on rank 0's trace: the gradient's all-reduce inside the captured data-parallel step, the waits for slower ranks included."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    spent = sum((e - s) / 1e6 for s, e, name in run.trace.device if name.lower().startswith("nccl"))
    return 1e3 * spent / run.rec.traced_steps if spent > 0 else None
