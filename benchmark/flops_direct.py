"""The floating-point operations of one training step of a direct-force
GemNet-T (the `gemnet-dt-oc20` configuration: OCP's Gaussian and
spherical-harmonic bases), from the configuration's widths and a batch's
real counts alone, with `flops.py`'s structure.

Counted: every product of the model, 2 operations a multiply-add — the
dense layers, the radial down-projection, the two contractions of each
bilinear layer, the neighbour sums of the bilinear layers (2*T*S*M over
the T real triplet rows) and OCP's direct force head's edge layers
(seq_forces on m, and dense_rbf_F) — in two phases: the forward, and for
training the loss's backward to the weights.
There is no force backward: F comes out of the forward. A product's
backward computes the gradient of each operand that depends on a weight:
one whose input depends on a weight costs 1 forward + 2 backward = 3c;
one whose input does not (the radial basis' layers mlp_rbf3, mlp_rbf_h,
mlp_rbf_out and mlp_cbf3: OCP's Gaussian basis has no parameters) 1 + 1 =
2c; a neighbour sum, whose spherical rows depend on R alone, 1 + 1 = 2c;
the first bilinear contraction, both of whose operands depend on weights,
1 + 2 = 3c. Nothing is recomputed, so the count reads the same whatever
implements the step. The dense part equals what
`torch.utils.flop_counter.FlopCounterMode` counts over the plain reference
(`reference/model_dt.py`, tested in `tests/test_harness_dt.py`).
"""

from __future__ import annotations

# (forward, train) multipliers by product kind
MULT = {"dense": (1, 3), "dense_basis": (1, 2), "bilinear": (1, 3), "neighbour": (1, 2)}


def products(c: dict, n: dict) -> list[tuple[str, float]]:
    """(kind, forward operations) of every product of a batch with real
    counts `n` (atoms, edges, triplets)."""
    A, E, T = n["atoms"], n["edges"], n["triplets"]
    S, Rn, nb = c["num_spherical"], c["num_radial"], c["num_blocks"]
    a, e, rbf, cbf = c["emb_size_atom"], c["emb_size_edge"], c["emb_size_rbf"], c["emb_size_cbf"]
    t, bt = c["emb_size_trip"], c["emb_size_bil_trip"]
    targets = c.get("num_targets", 1)
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

    # preamble: the radial basis' layers and the edge embedding
    for _ in range(3):
        dense(E, Rn, rbf, "dense_basis")  # mlp_rbf3, mlp_rbf_h, mlp_rbf_out
    dense(E, Rn, S * cbf, "dense_basis")  # mlp_cbf3 on the shared radial rows
    dense(E, 2 * a + Rn, e)  # edge_emb
    for _ in range(nb + 1):  # output blocks: energy and the direct force head
        atom_mlp()
        dense(A, a, targets)  # out_energy
        dense(E, e, e)  # seq_forces
        for _ in range(c["num_atom"]):
            residual(E, e)
        dense(E, rbf, e)  # dense_rbf_F, on mlp_rbf_out's rows
        dense(E, e, targets)  # out_forces
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
        for _ in range(c["num_before_skip"] + c["num_after_skip"]):
            residual(E, e)
        atom_mlp()  # atom update, without the energy head
        dense(E, 2 * a + e, e)  # concat_layer
        for _ in range(c["num_concat"]):
            residual(E, e)
    return out


def step_flops(c: dict, n: dict, phase: str, neighbour: bool = True) -> float:
    """Operations of one step: phase "forward" or "train" (and the loss's
    backward); `neighbour` False leaves the neighbour sums out (what
    FlopCounterMode sees of the reference)."""
    total = 0.0
    for kind, ops in products(c, n):
        if kind == "neighbour" and not neighbour:
            continue
        total += ops * MULT[kind][{"forward": 0, "train": 1}[phase]]
    return total
