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
