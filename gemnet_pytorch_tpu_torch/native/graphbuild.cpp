// Native batched molecular-graph index builder.
//
// This package's copy of gemnet_pytorch_tpu/native/graphbuild.cpp, with the
// same C ABI and the same canonical order: the C++ counterpart of
// data/graph.py's numpy builder (which replaces the reference's numba
// kernels + scipy CSR construction, reference
// gemnet/training/data_container.py:156-489). The hierarchy is generated
// directly in reduce-edge-sorted order with adjacency lists, in a single
// pass, producing the same arrays as the numpy builder
// (tests/test_torch_native.py holds them equal).
//
// ABI: plain C structs + malloc'd buffers, consumed via ctypes
// (data/native.py, which compiles this file at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Builder {
    std::vector<int32_t> id_c, id_a;                       // edges (canonical)
    std::vector<int32_t> id3_expand, id3_reduce, kidx3;    // triplets
    std::vector<int32_t> int_a, int_b;                     // interaction edges
    std::vector<int32_t> intm_ca, intm_db;                 // intermediate spaces
    std::vector<int32_t> intm_ab_r, intm_ab_e;
    std::vector<int32_t> q_reduce, q_expand, q_cab, q_abd, kidx4;
};

}  // namespace

extern "C" {

struct GraphResult {
    int64_t n_edges, n_trip, n_int_edges, n_intm_ca, n_intm_db, n_quads;
    int32_t *id_c, *id_a;
    int32_t *id3_expand, *id3_reduce, *kidx3;
    int32_t *int_a, *int_b;
    int32_t *intm_ca, *intm_db, *intm_ab_r, *intm_ab_e;
    int32_t *q_reduce, *q_expand, *q_cab, *q_abd, *kidx4;
};

static int32_t* copy_out(const std::vector<int32_t>& v) {
    auto* p = static_cast<int32_t*>(malloc(sizeof(int32_t) * (v.empty() ? 1 : v.size())));
    if (!v.empty()) memcpy(p, v.data(), sizeof(int32_t) * v.size());
    return p;
}

GraphResult* build_graph_native(const float* R, const int64_t* N, int64_t n_mol,
                                float cutoff, float int_cutoff,
                                int triplets_only) {
    Builder b;
    const float cut2 = cutoff * cutoff;
    const float icut2 = int_cutoff * int_cutoff;

    // ---- edges: canonical [lower (t<s, t-major); reversed] ----
    std::vector<int32_t> lower_t, lower_s;
    std::vector<std::pair<int32_t, int32_t>> mol_span(n_mol);
    {
        int64_t off = 0;
        for (int64_t m = 0; m < n_mol; ++m) {
            const int64_t n = N[m];
            mol_span[m] = {static_cast<int32_t>(off), static_cast<int32_t>(off + n)};
            for (int64_t t = 0; t < n; ++t) {
                const float* rt = R + 3 * (off + t);
                for (int64_t s = t + 1; s < n; ++s) {
                    const float* rs = R + 3 * (off + s);
                    const float dx = rt[0] - rs[0], dy = rt[1] - rs[1], dz = rt[2] - rs[2];
                    if (dx * dx + dy * dy + dz * dz <= cut2) {
                        lower_t.push_back(static_cast<int32_t>(off + t));
                        lower_s.push_back(static_cast<int32_t>(off + s));
                    }
                }
            }
            off += n;
        }
    }
    const int64_t n_undir = static_cast<int64_t>(lower_t.size());
    const int64_t n_edges = 2 * n_undir;
    const int64_t n_atoms = mol_span.empty() ? 0 : mol_span.back().second;
    b.id_c.reserve(n_edges);
    b.id_a.reserve(n_edges);
    for (int64_t k = 0; k < n_undir; ++k) { b.id_a.push_back(lower_t[k]); b.id_c.push_back(lower_s[k]); }
    for (int64_t k = 0; k < n_undir; ++k) { b.id_a.push_back(lower_s[k]); b.id_c.push_back(lower_t[k]); }

    // incoming edge lists per target atom, ordered by source atom — the CSR
    // column order the reference's edge_ids matrix produces
    // (data_container.py:311-315), so intermediate spaces match exactly
    std::vector<std::vector<int32_t>> incoming(n_atoms);
    for (int64_t e = 0; e < n_edges; ++e) incoming[b.id_a[e]].push_back(static_cast<int32_t>(e));
    for (auto& lst : incoming) {
        std::sort(lst.begin(), lst.end(),
                  [&](int32_t x, int32_t y) { return b.id_c[x] < b.id_c[y]; });
    }

    // ---- triplets: all edge pairs sharing a target, distinct sources ----
    for (int64_t r = 0; r < n_edges; ++r) {
        const int32_t a = b.id_a[r], c = b.id_c[r];
        int32_t k = 0;
        for (int32_t x : incoming[a]) {
            if (b.id_c[x] == c) continue;
            b.id3_reduce.push_back(static_cast<int32_t>(r));
            b.id3_expand.push_back(x);
            b.kidx3.push_back(k++);
        }
    }

    if (!triplets_only) {
        // ---- interaction edges: directed pairs within int_cutoff (t-major) ----
        for (int64_t m = 0; m < n_mol; ++m) {
            const int64_t lo = mol_span[m].first, hi = mol_span[m].second;
            for (int64_t t = lo; t < hi; ++t) {
                const float* rt = R + 3 * t;
                for (int64_t s = lo; s < hi; ++s) {
                    if (s == t) continue;
                    const float* rs = R + 3 * s;
                    const float dx = rt[0] - rs[0], dy = rt[1] - rs[1], dz = rt[2] - rs[2];
                    if (dx * dx + dy * dy + dz * dz <= icut2) {
                        b.int_a.push_back(static_cast<int32_t>(t));
                        b.int_b.push_back(static_cast<int32_t>(s));
                    }
                }
            }
        }
        const int64_t n_int = static_cast<int64_t>(b.int_a.size());

        // ---- intermediate triplet spaces (concat per interaction edge) ----
        std::vector<int32_t> ca_start(n_int + 1, 0), db_start(n_int + 1, 0);
        for (int64_t i = 0; i < n_int; ++i) {
            ca_start[i + 1] = ca_start[i] + static_cast<int32_t>(incoming[b.int_a[i]].size());
            db_start[i + 1] = db_start[i] + static_cast<int32_t>(incoming[b.int_b[i]].size());
        }
        b.intm_ca.reserve(ca_start[n_int]);
        b.intm_ab_r.reserve(ca_start[n_int]);
        b.intm_db.reserve(db_start[n_int]);
        b.intm_ab_e.reserve(db_start[n_int]);
        for (int64_t i = 0; i < n_int; ++i) {
            for (int32_t e : incoming[b.int_a[i]]) {
                b.intm_ca.push_back(e);
                b.intm_ab_r.push_back(static_cast<int32_t>(i));
            }
            for (int32_t e : incoming[b.int_b[i]]) {
                b.intm_db.push_back(e);
                b.intm_ab_e.push_back(static_cast<int32_t>(i));
            }
        }

        // reverse map: reduce edge -> its intm_ca positions (ascending)
        std::vector<std::vector<int32_t>> by_edge(n_edges);
        for (int64_t j = 0; j < static_cast<int64_t>(b.intm_ca.size()); ++j)
            by_edge[b.intm_ca[j]].push_back(static_cast<int32_t>(j));

        // ---- quadruplets, generated sorted by reduce edge ----
        for (int64_t r = 0; r < n_edges; ++r) {
            const int32_t a = b.id_a[r], c = b.id_c[r];
            int32_t k = 0;
            for (int32_t cab : by_edge[r]) {
                const int32_t i = b.intm_ab_r[cab];
                const int32_t bb = b.int_b[i];
                if (c == bb) continue;  // mask c != b
                for (int32_t abd = db_start[i]; abd < db_start[i + 1]; ++abd) {
                    const int32_t x = b.intm_db[abd];
                    const int32_t d = b.id_c[x];
                    if (d == a || d == c) continue;  // masks a != d, c != d
                    b.q_reduce.push_back(static_cast<int32_t>(r));
                    b.q_expand.push_back(x);
                    b.q_cab.push_back(cab);
                    b.q_abd.push_back(abd);
                    b.kidx4.push_back(k++);
                }
            }
        }
    }

    auto* out = static_cast<GraphResult*>(malloc(sizeof(GraphResult)));
    out->n_edges = n_edges;
    out->n_trip = static_cast<int64_t>(b.id3_reduce.size());
    out->n_int_edges = static_cast<int64_t>(b.int_a.size());
    out->n_intm_ca = static_cast<int64_t>(b.intm_ca.size());
    out->n_intm_db = static_cast<int64_t>(b.intm_db.size());
    out->n_quads = static_cast<int64_t>(b.q_reduce.size());
    out->id_c = copy_out(b.id_c);
    out->id_a = copy_out(b.id_a);
    out->id3_expand = copy_out(b.id3_expand);
    out->id3_reduce = copy_out(b.id3_reduce);
    out->kidx3 = copy_out(b.kidx3);
    out->int_a = copy_out(b.int_a);
    out->int_b = copy_out(b.int_b);
    out->intm_ca = copy_out(b.intm_ca);
    out->intm_db = copy_out(b.intm_db);
    out->intm_ab_r = copy_out(b.intm_ab_r);
    out->intm_ab_e = copy_out(b.intm_ab_e);
    out->q_reduce = copy_out(b.q_reduce);
    out->q_expand = copy_out(b.q_expand);
    out->q_cab = copy_out(b.q_cab);
    out->q_abd = copy_out(b.q_abd);
    out->kidx4 = copy_out(b.kidx4);
    return out;
}

// ---- periodic systems (OCP's GemNetT graph) ----
//
// pbc_neighbours: every directed edge s -> t whose source image R[s] + o.cell
// lies within the cutoff of R[t] (squared distance in (1e-4, cutoff^2], in
// double, OCP's radius_graph_pbc), over the image shells each cell vector's
// height asks for; per target the max_neighbors nearest, ties broken by
// (distance, source, offset); then OCP's symmetric selection
// (GemNetT.reorder_symmetric_edges): an edge is kept where s < t, or s == t
// and its offset is lexicographically negative, and the reverses of the kept
// edges (t -> s, -o) follow them. Kept edges come in (target, source, offset)
// order. The shells are searched around the atoms' positions wrapped into
// the cell, so atoms outside it find every image too; o is the offset from
// the atoms' own positions. The distance vector is (R[s] - R[t]) + o.cell
// with o.cell summed per axis in order: the images o and -o of one atom are
// at exactly equal distances, as data/graph.py's numpy builder computes them.

struct PbcEdges {
    int64_t n_edges, n_candidates, n_dropped;
    int32_t *id_c, *id_a;
    int8_t* offset;  // (n_edges, 3)
};

// The cross product of the cell vectors after `axis` (b x c, c x a, a x b)
// and the cell vector `axis` dotted with it (the signed volume).
static void cell_cross(const double* C, int axis, double* cr, double* vol) {
    const double* a = C + 3 * ((axis + 1) % 3);
    const double* b = C + 3 * ((axis + 2) % 3);
    cr[0] = a[1] * b[2] - a[2] * b[1];
    cr[1] = a[2] * b[0] - a[0] * b[2];
    cr[2] = a[0] * b[1] - a[1] * b[0];
    const double* c = C + 3 * axis;
    *vol = c[0] * cr[0] + c[1] * cr[1] + c[2] * cr[2];
}

__attribute__((optimize("fp-contract=off")))
PbcEdges* pbc_neighbours(const float* R, const int64_t* N, int64_t n_mol, const float* cell,
                         double cutoff, int64_t max_neighbors) {
    struct Cand { double d2; int32_t s; int32_t o[3]; };
    std::vector<int32_t> kept_t, kept_s;
    std::vector<int8_t> kept_o;
    int64_t n_cand = 0, n_drop = 0;
    const double cut2 = cutoff * cutoff;
    int64_t off = 0;
    for (int64_t m = 0; m < n_mol; ++m) {
        const int64_t n = N[m];
        double C[9];
        for (int i = 0; i < 9; ++i) C[i] = static_cast<double>(cell[9 * m + i]);
        // image shells ceil(cutoff / height) of each cell vector (OCP's
        // rep_a), searched around each atom's position wrapped into the
        // cell: w = floor of its fractional coordinates
        int reps[3];
        std::vector<int32_t> w(3 * n, 0);
        for (int ax = 0; ax < 3; ++ax) {
            double cr[3], vol;
            cell_cross(C, ax, cr, &vol);
            const double area = std::sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]);
            reps[ax] = vol != 0 ? static_cast<int>(std::ceil(cutoff * area / std::fabs(vol))) : 0;
            if (vol == 0) continue;
            for (int64_t i = 0; i < n; ++i) {
                const float* r = R + 3 * (off + i);
                double f = static_cast<double>(r[0]) * cr[0];
                f = f + static_cast<double>(r[1]) * cr[1];
                f = f + static_cast<double>(r[2]) * cr[2];
                w[3 * i + ax] = static_cast<int32_t>(std::floor(f / vol));
            }
        }
        std::vector<Cand> cand;
        for (int64_t t = 0; t < n; ++t) {
            cand.clear();
            const float* rt = R + 3 * (off + t);
            for (int64_t s = 0; s < n; ++s) {
                const float* rs = R + 3 * (off + s);
                const double bx = static_cast<double>(rs[0]) - static_cast<double>(rt[0]);
                const double by = static_cast<double>(rs[1]) - static_cast<double>(rt[1]);
                const double bz = static_cast<double>(rs[2]) - static_cast<double>(rt[2]);
                // the wrapped images' offsets, lexicographic; o the true one
                for (int i = -reps[0]; i <= reps[0]; ++i)
                    for (int j = -reps[1]; j <= reps[1]; ++j)
                        for (int k = -reps[2]; k <= reps[2]; ++k) {
                            const int32_t o[3] = {i - w[3 * s] + w[3 * t],
                                                  j - w[3 * s + 1] + w[3 * t + 1],
                                                  k - w[3 * s + 2] + w[3 * t + 2]};
                            double sh[3];
                            for (int x = 0; x < 3; ++x) {
                                double v = static_cast<double>(o[0]) * C[x];
                                v = v + static_cast<double>(o[1]) * C[3 + x];
                                v = v + static_cast<double>(o[2]) * C[6 + x];
                                sh[x] = v;
                            }
                            const double dx = bx + sh[0], dy = by + sh[1], dz = bz + sh[2];
                            double d2 = dx * dx;
                            d2 = d2 + dy * dy;
                            d2 = d2 + dz * dz;
                            if (d2 <= cut2 && d2 > 1e-4)
                                cand.push_back({d2, static_cast<int32_t>(s), {o[0], o[1], o[2]}});
                        }
            }
            n_cand += static_cast<int64_t>(cand.size());
            std::vector<char> keep(cand.size(), 1);
            if (max_neighbors >= 0 && static_cast<int64_t>(cand.size()) > max_neighbors) {
                std::vector<int32_t> order(cand.size());
                for (size_t i = 0; i < cand.size(); ++i) order[i] = static_cast<int32_t>(i);
                std::sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
                    const Cand &a = cand[x], &b = cand[y];
                    if (a.d2 != b.d2) return a.d2 < b.d2;
                    if (a.s != b.s) return a.s < b.s;
                    return std::lexicographical_compare(a.o, a.o + 3, b.o, b.o + 3);
                });
                for (size_t i = max_neighbors; i < order.size(); ++i) keep[order[i]] = 0;
                n_drop += static_cast<int64_t>(cand.size()) - max_neighbors;
            }
            for (size_t i = 0; i < cand.size(); ++i) {
                if (!keep[i]) continue;
                const int32_t s = cand[i].s;
                const int32_t* o = cand[i].o;
                const bool negative =
                    o[0] < 0 || (o[0] == 0 && (o[1] < 0 || (o[1] == 0 && o[2] < 0)));
                if (s < t || (s == t && negative)) {
                    kept_t.push_back(static_cast<int32_t>(off + t));
                    kept_s.push_back(static_cast<int32_t>(off + s));
                    for (int x = 0; x < 3; ++x) kept_o.push_back(static_cast<int8_t>(o[x]));
                }
            }
        }
        off += n;
    }
    const int64_t half = static_cast<int64_t>(kept_t.size());
    std::vector<int32_t> id_c(2 * half), id_a(2 * half);
    std::vector<int8_t> offset(6 * half);
    for (int64_t e = 0; e < half; ++e) {
        id_a[e] = kept_t[e]; id_c[e] = kept_s[e];
        id_a[half + e] = kept_s[e]; id_c[half + e] = kept_t[e];
        for (int x = 0; x < 3; ++x) {
            offset[3 * e + x] = kept_o[3 * e + x];
            offset[3 * (half + e) + x] = static_cast<int8_t>(-kept_o[3 * e + x]);
        }
    }
    auto* out = static_cast<PbcEdges*>(malloc(sizeof(PbcEdges)));
    out->n_edges = 2 * half;
    out->n_candidates = n_cand;
    out->n_dropped = n_drop;
    out->id_c = copy_out(id_c);
    out->id_a = copy_out(id_a);
    out->offset = static_cast<int8_t*>(malloc(offset.empty() ? 1 : offset.size()));
    if (!offset.empty()) memcpy(out->offset, offset.data(), offset.size());
    return out;
}

void free_pbc_edges(PbcEdges* e) {
    if (!e) return;
    free(e->id_c); free(e->id_a); free(e->offset);
    free(e);
}

// edge_triplets: every pair of distinct edges b -> a, c -> a sharing their
// target, reduce edge c -> a major, the expand edges b -> a in (source, edge)
// order; b == c is a triplet where the two edges differ (two images of one
// atom, GemNetT.get_triplets). Returned in GraphResult's triplet fields.
GraphResult* edge_triplets(const int32_t* id_c, const int32_t* id_a, int64_t n_edges,
                           int64_t n_atoms) {
    Builder b;
    std::vector<std::vector<int32_t>> incoming(n_atoms);
    for (int64_t e = 0; e < n_edges; ++e) incoming[id_a[e]].push_back(static_cast<int32_t>(e));
    for (auto& lst : incoming) {
        std::sort(lst.begin(), lst.end(), [&](int32_t x, int32_t y) {
            return id_c[x] != id_c[y] ? id_c[x] < id_c[y] : x < y;
        });
    }
    int64_t total = 0;
    for (int64_t r = 0; r < n_edges; ++r)
        total += static_cast<int64_t>(incoming[id_a[r]].size()) - 1;
    b.id3_reduce.reserve(total);
    b.id3_expand.reserve(total);
    b.kidx3.reserve(total);
    for (int64_t r = 0; r < n_edges; ++r) {
        int32_t k = 0;
        for (int32_t x : incoming[id_a[r]]) {
            if (x == r) continue;
            b.id3_reduce.push_back(static_cast<int32_t>(r));
            b.id3_expand.push_back(x);
            b.kidx3.push_back(k++);
        }
    }
    auto* out = static_cast<GraphResult*>(calloc(1, sizeof(GraphResult)));
    out->n_edges = n_edges;
    out->n_trip = static_cast<int64_t>(b.id3_reduce.size());
    out->id3_expand = copy_out(b.id3_expand);
    out->id3_reduce = copy_out(b.id3_reduce);
    out->kidx3 = copy_out(b.kidx3);
    return out;
}

void free_graph_native(GraphResult* g) {
    if (!g) return;
    free(g->id_c); free(g->id_a);
    free(g->id3_expand); free(g->id3_reduce); free(g->kidx3);
    free(g->int_a); free(g->int_b);
    free(g->intm_ca); free(g->intm_db); free(g->intm_ab_r); free(g->intm_ab_e);
    free(g->q_reduce); free(g->q_expand); free(g->q_cab); free(g->q_abd);
    free(g->kidx4);
    free(g);
}

}  // extern "C"
