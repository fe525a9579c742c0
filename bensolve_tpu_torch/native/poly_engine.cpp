// Native polytope engine: adjacency/incidence graph surgery for the
// dual-pair online vertex enumeration (the hot host-side core).
//
// The TPU build keeps vertex coordinates and bitmasks in Python-owned
// numpy buffers (shared here by pointer, rebindable after growth) and
// stores the adjacency / facet-incidence lists natively.  The graph
// mutations of a halfspace cut, the combinatorial edge test, and the
// all-pairs adjacency rebuild are the reference's C-speed inner loops
// (bslv_poly.c:467-512 edge_test, :562-709 poly__cut, :992-1010
// poly__update_adjacence); this file gives them back C-speed under the
// array-first layout of bensolve_tpu.poly.polytope, whose Python
// implementation remains the semantic oracle (and fallback).
//
// Built with plain g++ -O2 -shared; driven via ctypes (no pybind11).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Poly {
    int dim = 0;
    int cap = 0;
    int cnt = 0;
    double* data = nullptr;    // (cap, dim) row-major, Python-owned
    double* primg = nullptr;   // (cap, primg_stride), Python-owned
    int primg_stride = 0;
    uint8_t* used = nullptr;   // (cap,) bool masks, Python-owned
    uint8_t* ideal = nullptr;
    uint8_t* sltn = nullptr;
    std::vector<std::vector<int>> adj, inc;
    Poly* dual = nullptr;
};

bool contains(const std::vector<int>& v, int x) {
    for (int u : v)
        if (u == x) return true;
    return false;
}

// Reference edge_test (bslv_poly.c:467-512): v1, v2 adjacent iff they
// share >= dim-1 facets and no third vertex is incident to all of them.
bool edge_test(const Poly* P, int v1, int v2) {
    if (P->dim == 1) return true;
    const auto& i1 = P->inc[v1];
    const auto& i2 = P->inc[v2];
    std::vector<int> mutual;
    for (int f : i2)
        if (contains(i1, f)) mutual.push_back(f);
    if ((int)mutual.size() < P->dim - 1) return false;
    std::vector<int> others;
    for (int u : P->dual->inc[mutual[0]])
        if (u != v1 && u != v2) others.push_back(u);
    std::vector<int> kept;
    for (size_t mi = 1; mi < mutual.size() && !others.empty(); ++mi) {
        const auto& fv = P->dual->inc[mutual[mi]];
        kept.clear();
        for (int u : others)
            if (contains(fv, u)) kept.push_back(u);
        others.swap(kept);
    }
    return others.empty();
}

int append(Poly* p) {
    if (p->cnt >= p->cap) return -1;
    int k = p->cnt++;
    p->used[k] = 1;
    p->ideal[k] = 0;
    p->sltn[k] = 0;
    p->adj[k].clear();
    p->inc[k].clear();
    return k;
}

void remove_first(std::vector<int>& v, int x) {
    for (size_t j = 0; j < v.size(); ++j)
        if (v[j] == x) {
            v[j] = v.back();
            v.pop_back();
            return;
        }
}

}  // namespace

extern "C" {

Poly* poly_new(int dim) {
    Poly* p = new Poly();
    p->dim = dim;
    return p;
}

void poly_delete(Poly* p) { delete p; }

void poly_set_dual(Poly* a, Poly* b) {
    a->dual = b;
    b->dual = a;
}

void poly_bind(Poly* p, double* data, double* primg, int primg_stride,
               uint8_t* used, uint8_t* ideal, uint8_t* sltn, int cap) {
    p->data = data;
    p->primg = primg;
    p->primg_stride = primg_stride;
    p->used = used;
    p->ideal = ideal;
    p->sltn = sltn;
    p->cap = cap;
    if ((int)p->adj.size() < cap) {
        p->adj.resize(cap);
        p->inc.resize(cap);
    }
}

int poly_cnt(const Poly* p) { return p->cnt; }

void poly_set_cnt(Poly* p, int n) {
    p->cnt = n;
    if ((int)p->adj.size() < n) {
        p->adj.resize(n);
        p->inc.resize(n);
    }
}

int poly_append(Poly* p) { return append(p); }

int poly_row_len(const Poly* p, int which, int i) {
    const auto& v = which ? p->inc[i] : p->adj[i];
    return (int)v.size();
}

void poly_row_get(const Poly* p, int which, int i, int* out) {
    const auto& v = which ? p->inc[i] : p->adj[i];
    if (!v.empty()) memcpy(out, v.data(), v.size() * sizeof(int));
}

void poly_row_set(Poly* p, int which, int i, const int* vals, int n) {
    auto& v = which ? p->inc[i] : p->adj[i];
    v.assign(vals, vals + n);
}

void poly_row_append(Poly* p, int which, int i, int val) {
    (which ? p->inc[i] : p->adj[i]).push_back(val);
}

int64_t poly_nnz(const Poly* p, int which) {
    int64_t s = 0;
    for (int i = 0; i < p->cnt; ++i)
        s += (int64_t)(which ? p->inc[i] : p->adj[i]).size();
    return s;
}

void poly_csr(const Poly* p, int which, int64_t* offs, int* flat) {
    int64_t o = 0;
    for (int i = 0; i < p->cnt; ++i) {
        offs[i] = o;
        const auto& v = which ? p->inc[i] : p->adj[i];
        if (!v.empty()) memcpy(flat + o, v.data(), v.size() * sizeof(int));
        o += (int64_t)v.size();
    }
    offs[p->cnt] = o;
}

void poly_csr_load(Poly* p, int which, const int64_t* offs, const int* flat,
                   int n) {
    auto& rows = which ? p->inc : p->adj;
    if ((int)rows.size() < n) rows.resize(n);
    for (int i = 0; i < n; ++i)
        rows[i].assign(flat + offs[i], flat + offs[i + 1]);
}

int poly_edge_test(const Poly* p, int v1, int v2) {
    return edge_test(p, v1, v2);
}

// Adjacency among the new facet's incident vertices (bslv_poly.c:138-143).
void poly_wire_new_facet(Poly* P, int facet) {
    const std::vector<int> members = P->dual->inc[facet];  // copy: adj mutates
    for (size_t a = 0; a < members.size(); ++a)
        for (size_t b = 0; b < a; ++b) {
            int va = members[a], vb = members[b];
            if (edge_test(P, va, vb)) {
                P->adj[va].push_back(vb);
                P->adj[vb].push_back(va);
            }
        }
}

// All-pairs adjacency rebuild (poly__update_adjacence, bslv_poly.c:992-1010).
void poly_update_adjacency(Poly* P) {
    std::vector<int> live;
    for (int i = 0; i < P->cnt; ++i)
        if (P->used[i]) live.push_back(i);
    for (size_t a = 0; a < live.size(); ++a)
        for (size_t b = 0; b < a; ++b) {
            int va = live[a], vb = live[b];
            if (edge_test(P, vb, va)) {
                P->adj[vb].push_back(va);
                P->adj[va].push_back(vb);
            }
        }
}

// Adjacency-completeness scan of the invariant checker (poly__polyck,
// bslv_poly.c:983-988): count pairs that pass edge_test but are missing
// from the adjacency lists.
int64_t poly_count_missing_adj(const Poly* P) {
    std::vector<int> live;
    for (int i = 0; i < P->cnt; ++i)
        if (P->used[i]) live.push_back(i);
    int64_t missing = 0;
    for (size_t a = 0; a < live.size(); ++a)
        for (size_t b = 0; b < a; ++b) {
            int va = live[a], vb = live[b];
            if (edge_test(P, va, vb) && !contains(P->adj[va], vb)) ++missing;
        }
    return missing;
}

// The halfspace cut (reference poly__cut, bslv_poly.c:562-709), matching
// bensolve_tpu.poly.polytope.PolytopePair._cut exactly, including the
// depth-first visit order (recursion happens mid-way through a vertex's
// adjacency scan).  hp has dim+1 entries (normal, rhs); the facet being
// inserted is the last dual vertex.  Returns 0 on success, -1 if vertex
// capacity would overflow (caller must pre-grow: new vertices per cut
// <= adjacency nnz + 1).
int poly_cut(Poly* P, int v0, const double* hp, double eps) {
    Poly* D = P->dual;
    const int dim = P->dim;
    const int newf = D->cnt - 1;
    const double* hn = hp;
    const double hd = hp[dim];
    double hn2 = 0;
    for (int j = 0; j < dim; ++j) hn2 += hn[j] * hn[j];

    auto slack_of = [&](int i) {
        double rhs = P->ideal[i] ? 0.0 : hd;
        const double* d = P->data + (size_t)i * dim;
        double s = 0;
        for (int j = 0; j < dim; ++j) s += hn[j] * d[j];
        return s - rhs;
    };

    struct Frame {
        int v;
        std::vector<int> neigh;  // snapshot of adj[v] at entry
        size_t idx = 0;
        bool on_plane = false;
        int v_out = -1;
    };
    std::vector<Frame> stack;
    bool overflow = false;

    auto enter = [&](int v) {
        Frame fr;
        fr.v = v;
        P->used[v] = 0;
        fr.on_plane = slack_of(v) > -eps;
        if (fr.on_plane) {
            // duplicate v onto the new facet (bslv_poly.c:573-588)
            int vo = append(P);
            if (vo < 0) { overflow = true; return; }
            memcpy(P->data + (size_t)vo * dim, P->data + (size_t)v * dim,
                   dim * sizeof(double));
            P->ideal[vo] = P->ideal[v];
            if (P->sltn[v]) {
                P->sltn[vo] = 1;
                if (P->primg_stride)
                    memcpy(P->primg + (size_t)vo * P->primg_stride,
                           P->primg + (size_t)v * P->primg_stride,
                           P->primg_stride * sizeof(double));
            }
            D->inc[newf].push_back(vo);
            P->inc[vo].push_back(newf);
            fr.v_out = vo;
        }
        fr.neigh = P->adj[v];
        stack.push_back(std::move(fr));
    };

    std::vector<double> interp(dim);
    enter(v0);
    while (!stack.empty() && !overflow) {
        Frame& fr = stack.back();
        bool descended = false;
        while (fr.idx < fr.neigh.size()) {
            int k = fr.neigh[fr.idx++];
            if (!P->used[k]) continue;
            double s_k = slack_of(k);
            if (s_k > eps) {
                // IN neighbour: interpolate a new vertex on edge (v,k)
                // unless v sits on the plane (then reuse its duplicate)
                int v = fr.v;
                if (!fr.on_plane) {
                    int vo = append(P);
                    if (vo < 0) { overflow = true; break; }
                    bool vi = P->ideal[v], ki = P->ideal[k];
                    const double* pv = P->data + (size_t)v * dim;
                    const double* pk = P->data + (size_t)k * dim;
                    double rhs_t;
                    bool ideal_new;
                    double hs = 0, hdir = 0;
                    for (int j = 0; j < dim; ++j) {
                        double start, drctn;
                        if (ki && vi) {
                            start = pv[j];
                            drctn = pk[j] - pv[j];
                        } else if (ki) {
                            start = pv[j];
                            drctn = pk[j];
                        } else if (vi) {
                            start = pk[j];
                            drctn = pv[j];
                        } else {
                            start = pk[j];
                            drctn = pv[j] - pk[j];
                        }
                        interp[j] = start;        // reused below with mu
                        hs += hn[j] * start;
                        hdir += hn[j] * drctn;
                    }
                    rhs_t = (ki && vi) ? 0.0 : hd;
                    ideal_new = (ki && vi);
                    double mu = (rhs_t - hs) / hdir;
                    double* out = P->data + (size_t)vo * dim;
                    for (int j = 0; j < dim; ++j) {
                        double start, drctn;
                        if (ki && vi) {
                            start = pv[j];
                            drctn = pk[j] - pv[j];
                        } else if (ki) {
                            start = pv[j];
                            drctn = pk[j];
                        } else if (vi) {
                            start = pk[j];
                            drctn = pv[j];
                        } else {
                            start = pk[j];
                            drctn = pv[j] - pk[j];
                        }
                        out[j] = start + mu * drctn;
                    }
                    P->ideal[vo] = ideal_new;
                    D->inc[newf].push_back(vo);
                    P->inc[vo].push_back(newf);
                    fr.v_out = vo;
                }
                int vo = fr.v_out;
                // relink the edge (v,k) -> (vo,k)
                auto& ak = P->adj[k];
                for (size_t j = 0; j < ak.size(); ++j)
                    if (ak[j] == v) {
                        ak[j] = vo;
                        break;
                    }
                P->adj[vo].push_back(k);
                // vo joins every facet shared by v and k
                const auto& inc_v = P->inc[v];
                for (int f : P->inc[k]) {
                    if (!contains(inc_v, f)) continue;
                    if (fr.on_plane && contains(P->inc[vo], f)) continue;
                    P->inc[vo].push_back(f);
                    auto& df = D->inc[f];
                    bool replaced = false;
                    for (size_t j = 0; j < df.size(); ++j)
                        if (df[j] == v) {
                            df[j] = vo;
                            replaced = true;
                            break;
                        }
                    if (!replaced) df.push_back(vo);
                }
            } else if (s_k > 0.01 * eps) {
                // NEAR: project k onto the plane, then cut it
                // (bslv_poly.c:666-674)
                double* dk = P->data + (size_t)k * dim;
                for (int j = 0; j < dim; ++j) dk[j] -= (s_k / hn2) * hn[j];
                enter(k);
                descended = true;
                break;
            } else {
                // OUT: unlink from v, drop v from k's facets, recurse
                // (bslv_poly.c:675-693)
                int v = fr.v;
                remove_first(P->adj[k], v);
                for (int f : P->inc[k]) {
                    auto& df = D->inc[f];
                    remove_first(df, v);
                    if (df.empty()) D->used[f] = 0;
                }
                if (P->used[k]) {
                    enter(k);
                    descended = true;
                    break;
                }
            }
        }
        if (descended || overflow) continue;
        // detach v from its facets; facets left empty die
        // (bslv_poly.c:697-705)
        int v = stack.back().v;
        for (int f : P->inc[v]) {
            auto& df = D->inc[f];
            if (!df.empty())
                remove_first(df, v);
            else
                D->used[f] = 0;
        }
        stack.pop_back();
    }
    return overflow ? -1 : 0;
}

}  // extern "C"
