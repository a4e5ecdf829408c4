// dedup.cuh: the sorted build entries in tiles, their first-occurrence
// flags, their ranks within a warp's run and the per-file counts; shared
// by dedup.cu (counts mode, rank mode) and scatter.cu (the ranked
// scatter's chained scan, which is dedup's rank mode with another
// epilogue).
//
// A tile is kTile consecutive entries, a warp's run kWarpTile of them; a
// lane loads kRows rows of kVec consecutive entries (an int4 of keys and
// two 16-byte loads of values), row j of the run holding entries j * 128
// + 4 * lane + e. So a thread holds 16 entries from 4 + 8 vector loads,
// and the run's order is row by row, lane by lane. An entry's left
// neighbour is in the lane (e > 0), in the lane before (a shuffle), in the
// row before (lane 31's last) or, for the run's first, in device memory:
// the compare reads across every tile and chunk edge. Entries at or past
// `end` are absent. Row starts must be 16-byte aligned: the callers pass
// aligned buffers and run starts that are multiples of 4.
#pragma once

#include <cuda_runtime.h>

namespace ganon_entries {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // entries a lane loads at once
constexpr int kRows = 4;                     // loads a lane makes
constexpr int kRowSpan = 32 * kVec;          // a warp's row: 128 entries
constexpr int kWarpTile = kRowSpan * kRows;  // a warp's run: 512 entries
constexpr int kTile = kWarpTile * kWarps;    // a block's tile: 4096
constexpr unsigned kFull = 0xFFFFFFFFu;

// A lane's entries of its warp's run; bit e of ok[j] / first[j] is entry
// e of row j.
struct Entries {
    int k[kRows][kVec];
    unsigned long long v[kRows][kVec];
    unsigned ok[kRows];     // present (index < end)
    unsigned first[kRows];  // present, a first occurrence, key < R
};

// The run's entries from s0 (values only unless kKeys; absent ones read
// key -1, value 0).
template <bool kKeys>
__device__ __forceinline__ void load_rows(const int* __restrict__ key,
                                          const unsigned long long* __restrict__ val,
                                          long long s0, long long end,
                                          Entries& E) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const long long i = s0 + j * kRowSpan + kVec * lane;
        if (i + kVec <= end) {
            const ulonglong2 a = __ldg(reinterpret_cast<const ulonglong2*>(val + i));
            const ulonglong2 b =
                __ldg(reinterpret_cast<const ulonglong2*>(val + i + 2));
            E.v[j][0] = a.x;
            E.v[j][1] = a.y;
            E.v[j][2] = b.x;
            E.v[j][3] = b.y;
            if (kKeys) {
                const int4 kk = __ldg(reinterpret_cast<const int4*>(key + i));
                E.k[j][0] = kk.x;
                E.k[j][1] = kk.y;
                E.k[j][2] = kk.z;
                E.k[j][3] = kk.w;
            }
            E.ok[j] = 0xFu;
        } else {
            E.ok[j] = 0;
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const bool in = i + e < end;
                E.v[j][e] = in ? val[i + e] : 0;
                if (kKeys) E.k[j][e] = in ? key[i + e] : -1;
                E.ok[j] |= (unsigned)in << e;
            }
        }
    }
}

// first[j]: present entries that differ from their left neighbour (the
// array's entry 0 always does) and whose key is below R. The run's left
// neighbour is read only where the run holds an entry (s0 < end): a
// warp's run may start past the end, and nothing past it is read.
__device__ __forceinline__ void first_flags(const int* __restrict__ key,
                                            const unsigned long long* __restrict__ val,
                                            long long s0, long long end, int R,
                                            Entries& E) {
    const int lane = threadIdx.x & 31;
    int pk = 0;
    unsigned long long pv = 0;
    if (s0 > 0 && s0 < end) {
        pk = key[s0 - 1];
        pv = val[s0 - 1];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        int uk = __shfl_up_sync(kFull, E.k[j][kVec - 1], 1);
        unsigned long long uv = __shfl_up_sync(kFull, E.v[j][kVec - 1], 1);
        const int lk = __shfl_sync(kFull, E.k[j][kVec - 1], 31);
        const unsigned long long lv = __shfl_sync(kFull, E.v[j][kVec - 1], 31);
        bool has_left = true;
        if (lane == 0) {
            uk = pk;
            uv = pv;
            has_left = j > 0 || s0 > 0;
        }
        unsigned f = 0;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            const int ck = E.k[j][e];
            const unsigned long long cv = E.v[j][e];
            const int qk = e ? E.k[j][e - 1] : uk;
            const unsigned long long qv = e ? E.v[j][e - 1] : uv;
            const bool differs = (e == 0 && !has_left) || ck != qk || cv != qv;
            f |= (unsigned)(((E.ok[j] >> e) & 1u) && differs && ck < R) << e;
        }
        E.first[j] = f;
        pk = lk;
        pv = lv;
    }
}

// excl[j]: the number of first occurrences in the run before the lane's
// row j (entry e adds popc(first[j] & ((1 << e) - 1))); returns the run's.
__device__ __forceinline__ unsigned warp_ranks(const Entries& E,
                                               unsigned (&excl)[kRows]) {
    const int lane = threadIdx.x & 31;
    unsigned base = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const unsigned c = __popc(E.first[j]);
        unsigned x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
        }
        excl[j] = base + x - c;
        base += __shfl_sync(kFull, x, 31);
    }
    return base;
}

// The run's first occurrences added to their files' counts: a file's
// entries are contiguous, so its count in the run is the rank after its
// last entry less the rank at its first; the first entry of a file's
// piece of the run subtracts its rank (when not 0), the last adds its
// inclusive rank. One or two atomicAdds a file a run: one a run
// (512 entries) when the run holds one file.
__device__ __forceinline__ void add_counts(const Entries& E,
                                           const unsigned (&excl)[kRows],
                                           int R, int* __restrict__ counts) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        // the key right of the lane's last entry, and left of its first,
        // inside the run (-1: none)
        int nk = __shfl_down_sync(kFull, (E.ok[j] & 1u) ? E.k[j][0] : -1, 1);
        const int rk = j + 1 < kRows
            ? __shfl_sync(kFull, (E.ok[(j + 1) % kRows] & 1u)
                                      ? E.k[(j + 1) % kRows][0] : -1, 0)
            : -1;
        int pk = __shfl_up_sync(kFull, E.k[j][kVec - 1], 1);
        const int lk = j > 0
            ? __shfl_sync(kFull, E.k[(j + kRows - 1) % kRows][kVec - 1], 31)
            : -1;
        if (lane == 31) nk = rk;
        if (lane == 0) pk = lk;
        unsigned r = excl[j];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            const int ck = E.k[j][e];
            const unsigned fi = (E.first[j] >> e) & 1u;
            if (((E.ok[j] >> e) & 1u) && ck >= 0 && ck < R) {
                const int left = e ? E.k[j][e - 1] : pk;
                const int right = e + 1 < kVec
                    ? (((E.ok[j] >> (e + 1)) & 1u) ? E.k[j][(e + 1) % kVec] : -1)
                    : nk;
                if (left != ck && r) atomicAdd(counts + ck, -(int)r);
                if (right != ck && r + fi) atomicAdd(counts + ck, (int)(r + fi));
            }
            r += fi;
        }
    }
}

}  // namespace ganon_entries
