// Native LCA core: Euler tour + depth array + sparse-table RMQ.
//
// Integer-id engine behind ganon_tpu.classify.lca (the Python layer keeps
// the string<->id encoding). Functional equivalent of the reference LCA
// (pirovc/ganon:src/utils/include/utils/LCA.hpp:11-174), re-implemented
// from its documented behavior: DFS in child-insertion order re-appending
// the parent after each child subtree, first-occurrence table, O(1)
// pairwise range-minimum queries over the Euler depth array, pairwise fold
// for multi-node queries.
//
// C ABI (ctypes):
//   lca_build(n_nodes, n_edges, parents[], children[], root) -> handle
//   lca_reachable(handle, out[n_nodes])   1 if node is in the Euler walk
//   lca_pair(handle, u, v) -> lca id (or -1 on invalid/unreachable input)
//   lca_list(handle, nodes[], n) -> lca id of the whole list
//   lca_free(handle)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct LcaIndex {
    int64_t n_nodes = 0;
    std::vector<int32_t> euler;   // node id per Euler step
    std::vector<int32_t> depth;   // depth per Euler step
    std::vector<int64_t> first;   // first Euler index per node (-1 if absent)
    // sparse[j][i] = argmin depth over euler[i, i + 2^j)
    std::vector<std::vector<int64_t>> sparse;
    std::vector<int32_t> log2_;   // floor(log2(i)) lookup

    int64_t rmq(int64_t i, int64_t j) const {
        if (i > j) std::swap(i, j);
        const int32_t k = log2_[j - i + 1];
        const int64_t a = sparse[k][i];
        const int64_t b = sparse[k][j - (int64_t(1) << k) + 1];
        return depth[a] <= depth[b] ? a : b;  // leftmost on ties
    }

    int32_t pair(int32_t u, int32_t v) const {
        if (u < 0 || v < 0 || u >= n_nodes || v >= n_nodes) return -1;
        if (first[u] < 0 || first[v] < 0) return -1;
        if (u == v) return u;
        return euler[rmq(first[u], first[v])];
    }
};

}  // namespace

extern "C" {

void* lca_build(int64_t n_nodes, int64_t n_edges, const int32_t* parents,
                const int32_t* children, int32_t root) {
    auto* idx = new LcaIndex();
    idx->n_nodes = n_nodes;

    // adjacency in edge-insertion order (CSR over a counting pass)
    std::vector<int64_t> deg(n_nodes + 1, 0);
    for (int64_t e = 0; e < n_edges; ++e) {
        if (parents[e] != children[e]) deg[parents[e] + 1]++;
    }
    for (int64_t i = 0; i < n_nodes; ++i) deg[i + 1] += deg[i];
    std::vector<int32_t> adj(deg[n_nodes]);
    std::vector<int64_t> fill(deg.begin(), deg.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
        if (parents[e] != children[e]) adj[fill[parents[e]]++] = children[e];
    }

    idx->first.assign(n_nodes, -1);
    // iterative DFS; parent re-appended after each finished child subtree
    struct Frame { int32_t node; int32_t d; int64_t ci; };
    std::vector<Frame> stack;
    stack.push_back({root, 0, 0});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        if (f.ci == 0 && idx->first[f.node] < 0)
            idx->first[f.node] = (int64_t)idx->euler.size();
        idx->euler.push_back(f.node);
        idx->depth.push_back(f.d);
        const int64_t c0 = deg[f.node], c1 = deg[f.node + 1];
        if (c0 + f.ci < c1) {
            stack.push_back({f.node, f.d, f.ci + 1});
            stack.push_back({adj[c0 + f.ci], (int32_t)(f.d + 1), 0});
        }
    }

    const int64_t m = (int64_t)idx->euler.size();
    idx->log2_.assign(m + 1, 0);
    for (int64_t i = 2; i <= m; ++i) idx->log2_[i] = idx->log2_[i / 2] + 1;
    const int32_t levels = idx->log2_[m > 0 ? m : 1] + 1;
    idx->sparse.resize(levels);
    idx->sparse[0].resize(m);
    for (int64_t i = 0; i < m; ++i) idx->sparse[0][i] = i;
    for (int32_t j = 1; j < levels; ++j) {
        const int64_t half = int64_t(1) << (j - 1);
        auto& cur = idx->sparse[j];
        const auto& prev = idx->sparse[j - 1];
        cur.resize(m);
        for (int64_t i = 0; i < m; ++i) {
            if (i + half < m) {
                const int64_t a = prev[i], b = prev[i + half];
                cur[i] = idx->depth[a] <= idx->depth[b] ? a : b;
            } else {
                cur[i] = prev[i];
            }
        }
    }
    return idx;
}

void lca_free(void* h) { delete static_cast<LcaIndex*>(h); }

void lca_reachable(void* h, uint8_t* out) {
    auto* idx = static_cast<LcaIndex*>(h);
    for (int64_t i = 0; i < idx->n_nodes; ++i)
        out[i] = idx->first[i] >= 0 ? 1 : 0;
}

int32_t lca_pair(void* h, int32_t u, int32_t v) {
    return static_cast<LcaIndex*>(h)->pair(u, v);
}

int32_t lca_list(void* h, const int32_t* nodes, int64_t n) {
    auto* idx = static_cast<LcaIndex*>(h);
    if (n <= 0) return -1;
    int32_t cur = nodes[0];
    for (int64_t i = 1; i < n; ++i) {
        cur = idx->pair(cur, nodes[i]);
        if (cur < 0) return -1;
    }
    return cur;
}

// Batched per-row LCA: row r holds lens[r] node ids in ids[r*K .. r*K+lens[r]).
// The LCA of a set equals euler[rmq(min first, max first)] (one range query
// instead of a pairwise fold — identical result on a tree). out[r] = -1 for
// empty rows or rows containing an unreachable/invalid id.
void lca_rows(void* h, const int32_t* ids, int64_t n_rows, int64_t K,
              const int32_t* lens, int32_t* out) {
    auto* idx = static_cast<LcaIndex*>(h);
    for (int64_t r = 0; r < n_rows; ++r) {
        // clamp to the row width: the Python fallback clips at K, and an
        // unclamped len > K would read into the next row (or past the
        // buffer on the last row)
        const int32_t len = lens[r] > (int32_t)K ? (int32_t)K : lens[r];
        if (len <= 0) { out[r] = -1; continue; }
        const int32_t* row = ids + r * K;
        int64_t fmin = INT64_MAX, fmax = -1;
        bool bad = false;
        for (int32_t j = 0; j < len; ++j) {
            const int32_t u = row[j];
            if (u < 0 || u >= idx->n_nodes || idx->first[u] < 0) {
                bad = true;
                break;
            }
            const int64_t f = idx->first[u];
            if (f < fmin) fmin = f;
            if (f > fmax) fmax = f;
        }
        if (bad) { out[r] = -1; continue; }
        out[r] = len == 1 ? row[0] : idx->euler[idx->rmq(fmin, fmax)];
    }
}

}  // extern "C"
