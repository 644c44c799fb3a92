"""The model's floating-point operations in one step, from the
configuration's widths and a batch's real counts alone.

Counted: every product of the model, 2 operations a multiply-add — the
dense layers, the radial down-projections, the two contractions of each
bilinear layer, and the neighbour sums of the bilinear layers (2*n*S*M over
the n real rows) — in three phases:
- the forward;
- the force backward, F = -dE/dR: each product's derivative towards R,
  once per operand that depends on R (every product's input does; the
  weights do not);
- for training, the loss's backward through the forward and the force
  graph to the weights: each product of both, once per operand that depends
  on a weight (the basis rows of the down-projections, the circular basis of
  the quadruplet layer and the spherical rows of the neighbour sums depend
  on R alone).
Nothing is recomputed. So the count reads the same whatever implements the
step; elementwise work, gathers and segment sums are not counted. The dense
part equals what `torch.utils.flop_counter.FlopCounterMode` counts over the
plain reference (`reference/model.py`, tested in `tests/test_harness_flops.py`).

Multipliers of a product of forward cost c (forward + force backward +
loss backward): a dense layer or contraction whose input depends on a
weight 1 + 1 + (2 + 2) = 6c; one whose input does not (mlp_cbf3, mlp_sbf4,
mlp_cbf4) 1 + 1 + (1 + 2) = 5c, as an energy head, whose force derivative
starts from a cotangent of ones, 1 + 1 + (2 + 1) = 5c; the first bilinear
contraction, both of whose operands depend on R and on weights,
1 + 2 + (2 + 4) = 9c; a neighbour sum 1 + 2 + (1 + 3) = 7c. Serving stops
after the force backward: 2c, 2c, 2c, 3c and 3c.
"""

from __future__ import annotations

# (forward + force backward, + loss backward) multipliers by product kind
MULT = {"dense": (2, 6), "dense_basis": (2, 5), "head": (2, 5), "bilinear": (3, 9),
        "neighbour": (3, 7)}


def products(c: dict, n: dict) -> list[tuple[str, float]]:
    """(kind, forward operations) of every product of a batch with real
    counts `n` (atoms, edges, triplets, intm, quads)."""
    A, E, T = n["atoms"], n["edges"], n["triplets"]
    S, Rn, nb = c["num_spherical"], c["num_radial"], c["num_blocks"]
    a, e, rbf, cbf = c["emb_size_atom"], c["emb_size_edge"], c["emb_size_rbf"], c["emb_size_cbf"]
    t, bt = c["emb_size_trip"], c["emb_size_bil_trip"]
    out = []

    def dense(rows, n_in, n_out, kind="dense"):
        out.append((kind, 2.0 * rows * n_in * n_out))

    def residual(rows, units):
        dense(rows, units, units)
        dense(rows, units, units)

    def atom_mlp():
        dense(E, rbf, e)  # dense_rbf
        dense(A, e, a)
        for _ in range(c["num_atom"]):
            residual(A, a)

    # preamble: the shared basis layers, the embeddings, the first output block
    for _ in range(3):
        dense(E, Rn, rbf)  # mlp_rbf3, mlp_rbf_h, mlp_rbf_out
    dense(E, S * Rn, cbf, "dense_basis")  # mlp_cbf3
    dense(E, 2 * a + Rn, e)  # edge_emb
    quads = not c["triplets_only"]
    if quads:
        I, Q = n["intm"], n["quads"]
        q, sbf, bq = c["emb_size_quad"], c["emb_size_sbf"], c["emb_size_bil_quad"]
        dense(E, Rn, rbf)  # mlp_rbf4
        dense(I, S * Rn, cbf, "dense_basis")  # mlp_cbf4
        dense(E, S * S * Rn, sbf, "dense_basis")  # mlp_sbf4
    for _ in range(nb + 1):  # output blocks
        atom_mlp()
        dense(A, a, c.get("num_targets", 1), "head")
    for _ in range(nb):  # interaction blocks
        dense(E, e, e)  # dense_ca
        dense(E, e, e)  # trip: dense_ba
        dense(E, rbf, e)  # trip: mlp_rbf
        dense(E, e, t)  # trip: down_projection
        out.append(("neighbour", 2.0 * T * S * t))
        out.append(("bilinear", 2.0 * E * cbf * S * t))
        dense(E, t * cbf, bt)
        dense(E, bt, e)
        dense(E, bt, e)
        if quads:
            dense(E, e, e)  # quad: dense_db
            dense(E, rbf, e)
            dense(E, e, q)
            dense(I, cbf, q)  # quad: mlp_cbf
            out.append(("neighbour", 2.0 * Q * S * S * q))
            out.append(("bilinear", 2.0 * E * sbf * S * S * q))
            dense(E, q * sbf, bq)
            dense(E, bq, e)
            dense(E, bq, e)
        for _ in range(c["num_before_skip"] + c["num_after_skip"]):
            residual(E, e)
        atom_mlp()  # atom update, without the energy head
        dense(E, 2 * a + e, e)  # concat_layer
        for _ in range(c["num_concat"]):
            residual(E, e)
    return out


def step_flops(c: dict, n: dict, phase: str, neighbour: bool = True) -> float:
    """Operations of one step: phase "forward", "md" (forward and forces)
    or "train" (and the loss's backward); `neighbour` False leaves the
    neighbour sums out (what FlopCounterMode sees of the reference)."""
    total = 0.0
    for kind, ops in products(c, n):
        if kind == "neighbour" and not neighbour:
            continue
        total += ops * {"forward": 1, "md": MULT[kind][0], "train": MULT[kind][1]}[phase]
    return total
