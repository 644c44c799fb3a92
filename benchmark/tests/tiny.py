"""Small widths and traffic at which every cell runs on the CPU in seconds."""

CONFIG = dict(emb_size_atom=16, emb_size_edge=16, emb_size_trip=8, emb_size_quad=8,
              emb_size_rbf=4, emb_size_cbf=4, emb_size_sbf=8, emb_size_bil_trip=8,
              emb_size_bil_quad=8, num_blocks=2)


def traffic(loop: str) -> dict:
    if loop == "train":
        return {"pool": 24, "atoms": [4, 7], "batch": 4}
    return {"atoms": 8, "triplets": [0, 10**9]}


def overrides(workload: str) -> dict:
    from benchmark import run
    _, _, _, mix = run.cell(workload)
    return {"config": CONFIG, "traffic": traffic(mix["loop"])}
