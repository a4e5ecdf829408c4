// merge: a level's filters' clamped counts -> the union counts + winners.
//
// Replaces the per-filter union step of the JAX device program
//   ganon_tpu/classify/device.py:542 classify_batch_packed_multi
//   (:587-604: per-filter rel-cutoff, scatter into union columns,
//   strict-greater max with the winning filter's index)          (K13).
//
// For every read b, union column u and filter f in order:
//   cutoff = max(ceil(n[b] * rel_cutoff[f]), 1)    (in double, as in JAX)
//   valid  = 0 < n[b] <= hashes_limit
//   t      = colmap[f, u]   (filter f's local target at u, or -1)
//   cand   = (t >= 0 && valid && counts_f[b, t] >= cutoff) ? counts_f[b, t] : 0
//   if cand > ucounts[b, u]: ucounts[b, u] = cand, uwin[b, u] = f
// starting from count 0 and winner 0, so the first filter wins ties and a
// column no filter passes has count 0 and winner 0.
//
// What bounds it on the H100: device memory. Each filter's [B, T_f]
// counts are read once and the [B, U] union counts and winners written
// once (146.8 MB at 8192 reads, 1024 + 512 targets into U = 1472: 0.0438
// ms at 3.35 TB/s). The earlier design, a launch a filter whose threads
// read-modify-wrote the union entries of their targets after the caller
// had zero-filled both [B, U] buffers, moved about twice that and took
// 0.0771 ms on the card for the two filters (NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Design: one launch a level. The filters' counts pointers, their T_f and
// rel-cutoffs go to the kernel by value (a __grid_constant__ struct of at
// most kMaxFilters filters); the inverse column map, int32 [F, U], is
// built once a level by the caller. A thread owns four consecutive union
// columns of one read (a quad), grid-stride over B x quads: it loads n
// once, walks the filters in order keeping the best count and its filter
// in registers, and stores each union entry once. The quads sit on
// 16-byte boundaries of the output row, so a whole quad is one 16-byte
// store of the counts and one of the winners; a row's edges (U need not
// be a multiple of 4, so each row starts at its own phase) store
// scalars in the same kernel. Where a filter's four targets are
// consecutive and 16-byte aligned in its counts row (a filter whose
// targets open the union, the common case), they are one 16-byte load.
// Nothing needs a zero fill: the first launch of a level writes every
// entry. A level of more than kMaxFilters filters takes further launches,
// each starting from what the one before wrote (init = 0).
#include <cuda_runtime.h>

#include <cstdint>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFilters = 16;  // classify/device.py MERGE_MAX_FILTERS
constexpr int kVec = 4;
constexpr int kBlocksPerSm = 8;

struct Level {
    const int* counts[kMaxFilters];  // filter f0 + j's [B, tf[j]] counts
    double rc[kMaxFilters];
    int tf[kMaxFilters];
    int nf;
    int f0;  // the first filter's index in the level (its winner id)
};

__global__ void __launch_bounds__(kThreads)
merge_kernel(const __grid_constant__ Level lv, long long B, int U, int Q,
             const int* __restrict__ n_hashes, long long hashes_limit,
             const int* __restrict__ colmap, int init,
             int* __restrict__ ucounts, int* __restrict__ uwin) {
    const long long items = B * Q;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < items; i += step) {
        const long long b = i / Q;
        const int q = (int)(i - b * Q);
        int* crow = ucounts + b * U;
        int* wrow = uwin + b * U;
        // the quads sit on 16-byte boundaries of the counts row
        const int head = (int)(((uintptr_t)crow >> 2) & (kVec - 1));
        const int u0 = q * kVec - head;
        if (u0 >= U) continue;
        const bool whole = u0 >= 0 && u0 + kVec <= U;
        int best[kVec], win[kVec];
        if (init) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) best[e] = win[e] = 0;
        } else if (whole && ((uintptr_t)(wrow + u0) & 15) == 0) {
            const int4 c = *reinterpret_cast<const int4*>(crow + u0);
            const int4 w = *reinterpret_cast<const int4*>(wrow + u0);
            best[0] = c.x; best[1] = c.y; best[2] = c.z; best[3] = c.w;
            win[0] = w.x; win[1] = w.y; win[2] = w.z; win[3] = w.w;
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const int u = u0 + e;
                const bool in = u >= 0 && u < U;
                best[e] = in ? crow[u] : 0;
                win[e] = in ? wrow[u] : 0;
            }
        }
        const int n = n_hashes[b];
        if (n > 0 && (long long)n <= hashes_limit) {
            for (int j = 0; j < lv.nf; ++j) {
                const int tf = lv.tf[j];
                const int cutoff =
                    (int)fmax(ceil((double)n * lv.rc[j]), 1.0);
                const int* mrow = colmap + (long long)(lv.f0 + j) * U;
                int t[kVec];
#pragma unroll
                for (int e = 0; e < kVec; ++e) {
                    const int u = u0 + e;
                    t[e] = (u >= 0 && u < U) ? __ldg(mrow + u) : -1;
                    if (t[e] >= tf) t[e] = -1;  // past the filter: absent
                }
                const int* row = lv.counts[j] + b * tf;
                int c[kVec];
                if (t[0] >= 0 && t[1] == t[0] + 1 && t[2] == t[0] + 2
                    && t[3] == t[0] + 3
                    && ((uintptr_t)(row + t[0]) & 15) == 0) {
                    const int4 v =
                        __ldg(reinterpret_cast<const int4*>(row + t[0]));
                    c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
                } else {
#pragma unroll
                    for (int e = 0; e < kVec; ++e)
                        c[e] = t[e] >= 0 ? __ldg(row + t[e]) : 0;
                }
#pragma unroll
                for (int e = 0; e < kVec; ++e) {
                    const int cand = c[e] >= cutoff ? c[e] : 0;
                    if (cand > best[e]) {
                        best[e] = cand;
                        win[e] = lv.f0 + j;
                    }
                }
            }
        }
        if (whole) {
            *reinterpret_cast<int4*>(crow + u0) =
                make_int4(best[0], best[1], best[2], best[3]);
            if (((uintptr_t)(wrow + u0) & 15) == 0) {
                *reinterpret_cast<int4*>(wrow + u0) =
                    make_int4(win[0], win[1], win[2], win[3]);
                continue;
            }
#pragma unroll
            for (int e = 0; e < kVec; ++e) wrow[u0 + e] = win[e];
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const int u = u0 + e;
                if (u >= 0 && u < U) {
                    crow[u] = best[e];
                    wrow[u] = win[e];
                }
            }
        }
    }
}

}  // namespace

// Merge filters f0 .. f0 + nf - 1 of a level into ucounts and uwin (int32
// [B, U], 4-byte aligned). counts: HOST int64 [nf], the card addresses of
// the filters' int32 [B, T_f] counts; tf: HOST int32 [nf]; rel_cutoffs:
// HOST double [nf] (all read here and passed to the kernel by value);
// colmap: int32 [F, U] on the card, F >= f0 + nf, each entry a local
// target below its filter's T_f or -1. init = 1 writes every entry from
// count 0 and winner 0 (the level's first launch); 0 merges into what
// ucounts and uwin hold. Refused (cudaErrorInvalidValue, before any
// launch): nf outside 1 .. kMaxFilters, f0 < 0, a T_f outside 0 .. U
// (no filter holds more targets than the union has columns), and shapes
// past the kernel's int32 quads or a grid.
extern "C" int ganon_merge(const void* n_hashes, long long B,
                           const void* counts, const void* tf,
                           const void* rel_cutoffs, int nf, int f0,
                           long long hashes_limit, const void* colmap,
                           int U, int init, void* ucounts, void* uwin,
                           void* stream) {
    if (nf < 1 || nf > kMaxFilters || f0 < 0 || U < 0 || B < 0
        || ((uintptr_t)ucounts & 3) || ((uintptr_t)uwin & 3))
        return (int)cudaErrorInvalidValue;
    Level lv{};
    lv.nf = nf;
    lv.f0 = f0;
    const long long* ptrs = (const long long*)counts;
    const int* tfs = (const int*)tf;
    const double* rcs = (const double*)rel_cutoffs;
    for (int j = 0; j < nf; ++j) {
        if (tfs[j] < 0 || tfs[j] > U || (tfs[j] && !ptrs[j]))
            return (int)cudaErrorInvalidValue;
        lv.counts[j] = (const int*)ptrs[j];
        lv.tf[j] = tfs[j];
        lv.rc[j] = rcs[j];
    }
    // quads a row: one more where the row's head is not 16-byte aligned
    const long long Q = (U + 2 * kVec - 2) / kVec;
    if (Q >= (1ll << 31) || B * Q >= (1ll << 62))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || U == 0) return (int)cudaGetLastError();
    long long blocks = (B * Q + kThreads - 1) / kThreads;
    const long long cap = (long long)sm_count() * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    merge_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        lv, B, U, (int)Q, (const int*)n_hashes, hashes_limit,
        (const int*)colmap, init, (int*)ucounts, (int*)uwin);
    return (int)cudaGetLastError();
}
