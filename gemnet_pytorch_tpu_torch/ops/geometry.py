"""Geometric primitives: distances, angles, dihedral projection.

Port of `gemnet_pytorch_tpu/ops/geometry.py` (reference gemnet.py:261-451).
Every sqrt and division is guarded on its INPUT, so padded rows give finite
values and finite gradients on the -dE/dR force path: `torch.where`, like
`jnp.where`, still passes a NaN of the branch not taken into the gradient.
"""

from __future__ import annotations

import torch

from .expand_gather import gather

_EPS_SQ = 1e-18  # guards |cross|^2; matches the reference's y >= 1e-9 clamp


def edge_vectors(R, id_s, id_t, sorts=(None, None)):
    """R[id_t] - R[id_s], each edge's vector s->t from the atoms' positions
    (no image shift, no mask). `sorts`: the sort metadata of the gathers
    R[id_s] and R[id_t] (`expand_gather.gather`), None for plain."""
    s_sort, t_sort = sorts
    return gather(R, id_t, t_sort) - gather(R, id_s, s_sort)


def interatomic_vectors(R, id_s, id_t, mask, shift=None, sorts=(None, None)):
    """Distances and unit directions s->t per edge (reference gemnet.py:262-286).
    `shift` (nEdges, 3): where the source is an image at R[s] + shift
    (periodic systems, `edge_shifts`). `sorts`: as `edge_vectors`'.

    Padded edges (mask False) get D=1, V=0 with zero gradient into R.
    """
    V = edge_vectors(R, id_s, id_t, sorts)
    if shift is not None:
        V = V - shift
    V = torch.where(mask[:, None], V, torch.zeros_like(V))
    d2 = torch.sum(V * V, dim=1)
    d2 = torch.where(mask, d2, torch.ones_like(d2))  # guarded: sqrt'(1) finite
    D = torch.sqrt(d2)
    V = V / D[:, None]
    return D, V


def neighbor_angles(R_ac, R_ab):
    """Angle between vector pairs via atan2(|u x v|, u.v)
    (reference gemnet.py:289-311, incl. the 1e-9 clamp on |u x v|)."""
    x = torch.sum(R_ac * R_ab, dim=-1)
    cross = torch.linalg.cross(R_ac, R_ab, dim=-1)
    # sqrt(max(|c|^2, eps^2)) == max(|c|, eps), with a finite gradient at 0
    y = torch.sqrt(torch.clamp_min(torch.sum(cross * cross, dim=-1), _EPS_SQ))
    return torch.atan2(y, x)


def vector_rejection(R_ab, P_n):
    """Component of R_ab orthogonal to P_n (reference gemnet.py:313-332),
    with a guarded denominator for degenerate padded rows."""
    a_dot_n = torch.sum(R_ab * P_n, dim=-1)
    n_dot_n = torch.clamp_min(torch.sum(P_n * P_n, dim=-1), _EPS_SQ)
    return R_ab - (a_dot_n / n_dot_n)[:, None] * P_n


def edge_shifts(edge_offset, cell, batch_seg, id_t):
    """o.cell of each edge's source image: its integer cell offset (int8,
    (nEdges, 3)) times the cell of its target's system ((nMol, 3, 3), rows
    the cell vectors), summed over the three vectors."""
    C = cell[batch_seg[id_t]]  # (nEdges, 3, 3)
    return torch.sum(edge_offset.to(C.dtype)[:, :, None] * C, dim=1)


def triplet_cosines(V, id3_reduce_ca, id3_expand_ba):
    """cos of the angle c<-a->b from the two edges' unit vectors, clamped
    to [-1, 1] (OCP's inner_product_normalized): right across a cell
    boundary, where the atoms' positions are not."""
    return torch.clamp(torch.sum(V[id3_reduce_ca] * V[id3_expand_ba], dim=-1), -1.0, 1.0)


def triplet_angles(V, id3_reduce_ca, id3_expand_ba, ca_sort=None, ba_sort=None):
    """Angles c<-a->b for triplet message passing (reference gemnet.py:420-451),
    from the edges' vectors c->a, V = R[id_a] - R[id_c] (`edge_vectors`),
    gathered to the triplet rows by both edges.

    A triplet's two edges share their atom a (id_a[id3_expand_ba] ==
    id_a[id3_reduce_ca] on every real row), so its rows of V are
    -(R[c] - R[a]) and -(R[b] - R[a]) bit for bit, and the angle between
    two negated vectors is the same floats: every product in
    `neighbor_angles` takes both signs. `ca_sort` and `ba_sort` are the
    gathers' sort metadata (`expand_gather.gather`), None for plain."""
    return neighbor_angles(gather(V, id3_reduce_ca, ca_sort), gather(V, id3_expand_ba, ba_sort))


def quadruplet_angles(
    R, id_c, id_a, id4_int_b, id4_int_a, id4_expand_abd, id4_reduce_cab,
    id4_expand_intm_db, id4_reduce_intm_ca, id4_expand_intm_ab,
    id4_reduce_intm_ab, abd_sort, cab_sort,
):
    """(angle_cab, angle_abd, angle_cabd) for quadruplet message passing
    (reference gemnet.py:334-418). angle_abd lives on the intermediate-db
    space, the other two on the quadruplet space. `abd_sort`/`cab_sort` are
    the (perm, sorted_ids, plan) metadata of the two expand gathers, or
    None for plain gathers (an ep shard's rows, JAX `ops/geometry.py:142`)."""
    # a - b <- d (intermediate db space)
    Ra = R[id4_int_a[id4_expand_intm_ab]]
    Rb = R[id4_int_b[id4_expand_intm_ab]]
    Rd = R[id_c[id4_expand_intm_db]]
    R_ba = Ra - Rb
    R_bd = Rd - Rb
    angle_abd = neighbor_angles(R_ba, R_bd)
    R_bd_proj = gather(vector_rejection(R_bd, R_ba), id4_expand_abd, abd_sort)  # -> quad space

    # c -> a <- b (intermediate ca space); one (n_intm, 4) gather for
    # [angle_cab ; R_ac_proj], as the JAX package does
    Rc = R[id_c[id4_reduce_intm_ca]]
    Ra = R[id_a[id4_reduce_intm_ca]]
    Rb = R[id4_int_b[id4_reduce_intm_ab]]
    R_ac = Rc - Ra
    R_ab = Rb - Ra
    packed = torch.cat(
        [neighbor_angles(R_ab, R_ac)[:, None], vector_rejection(R_ac, R_ab)], dim=1)
    packed = gather(packed, id4_reduce_cab, cab_sort)  # -> quad space
    angle_cab = packed[:, 0]
    R_ac_proj = packed[:, 1:]

    # dihedral c -> a - b <- d
    angle_cabd = neighbor_angles(R_ac_proj, R_bd_proj)
    return angle_cab, angle_abd, angle_cabd


def triplet_angles_halo(R, id_c, id_a, id3_reduce_ca, trip_b_atom):
    """Halo-mode triplet angles (JAX `ops/geometry.py:69-84`): the expand
    edge's source atom is precomputed per row by the host partitioner
    (parallel/halo.py), so no cross-shard edge lookup is needed;
    id3_reduce_ca holds LOCAL edge slots. Same math as `triplet_angles`."""
    Rc = R[id_c[id3_reduce_ca]]
    Ra = R[id_a[id3_reduce_ca]]
    Rb = R[trip_b_atom]
    return neighbor_angles(Rc - Ra, Rb - Ra)


def quadruplet_angles_halo(
    R, id_c, id_a, id4_int_b, id4_reduce_intm_ca, id4_reduce_intm_ab, id4_reduce_cab,
    intm_ext_a_atom, intm_ext_b_atom, intm_ext_d_atom, n_intm_db_local: int, id4_expand_abd,
):
    """Halo-mode quadruplet angles (JAX `ops/geometry.py:87-138`), the math
    of `quadruplet_angles` over the partitioned spaces, with plain gathers
    (no sort metadata exists for a shard's rows):

    - intm_ca rows are local (owned with their c->a edge;
      `id4_reduce_intm_ca` holds LOCAL edge slots);
    - the intm_db dihedral projection is computed on the EXTENDED
      [local ; halo] space from per-row ATOM indices (R is replicated, so a
      halo row's geometry needs no exchange);
    - angle_abd (the circular basis' input) is returned for the local
      intm_db rows only."""
    # c -> a <- b on local intm_ca rows, one (n, 4) gather to the quads
    Rc = R[id_c[id4_reduce_intm_ca]]
    Ra = R[id_a[id4_reduce_intm_ca]]
    Rb = R[id4_int_b[id4_reduce_intm_ab]]
    R_ac = Rc - Ra
    R_ab = Rb - Ra
    packed = torch.cat(
        [neighbor_angles(R_ab, R_ac)[:, None], vector_rejection(R_ac, R_ab)],
        dim=1)[id4_reduce_cab]
    angle_cab = packed[:, 0]
    R_ac_proj = packed[:, 1:]

    # a - b <- d on the EXTENDED intm_db space
    Ra = R[intm_ext_a_atom]
    Rb = R[intm_ext_b_atom]
    Rd = R[intm_ext_d_atom]
    R_ba = Ra - Rb
    R_bd = Rd - Rb
    angle_abd = neighbor_angles(R_ba, R_bd)[:n_intm_db_local]
    R_bd_proj = vector_rejection(R_bd, R_ba)[id4_expand_abd]  # -> quad space

    angle_cabd = neighbor_angles(R_ac_proj, R_bd_proj)
    return angle_cab, angle_abd, angle_cabd
