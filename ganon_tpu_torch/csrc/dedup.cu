// dedup: first occurrences of sorted build entries, their ranks, and the
// per-file distinct counts.
//
// Replaces the JAX device programs
//   ganon_tpu/index/device_build.py:137 close_sort's first-occurrence mask
//     (device_build.py:157-165) and
//   ganon_tpu/index/device_build.py:169 close_counts_sorted (K10),
// plus the rank half of device_build.py:237 _entry_coords (cumsum of the
// unique flags).
//
// Semantics, over N entries sorted by (key, unsigned value):
//   uniq[i]   = (i == 0 or entry i differs from entry i - 1) and key[i] < R
//   rank[i]   = sum of uniq[:i] (an exclusive scan)
//   counts[f] += number of i with uniq[i] and key[i] == f, when counts is
//               not NULL (a file's entries are contiguous after the sort)
// The JAX per-file overflow flag has no counterpart: the port's extract
// runs at a capacity of every window position and never overflows.
//
// What bounds it on the H100: bytes, 12 of entry read per entry; the rank
// mode writes 8 more (flag and rank), the counts mode 4 a file.
//
// Design: one read of the entries, in tiles of 4096 (dedup.cuh: 16
// entries a thread from vector loads, the left neighbour across every
// tile edge). Counts mode (the build's pass 1, rank NULL): one launch,
// no status words and nothing of size N; a warp ranks its run's first
// occurrences with shuffles and adds each file's count once or twice a
// run (dedup.cuh add_counts), so 133 files of 18.6M entries see ~36,000
// adds, not one per entry. Rank mode: one chained-scan launch (scan.cuh,
// decoupled look-back on the shared status words, kernels.scan_status):
// a block draws its tile, sums its warps' runs, publishes, takes its
// prefix from its predecessors and writes the flags and ranks with
// vector stores. The earlier design, a flag kernel and then sort.cu's
// three-kernel scan over the [N] flags, took 0.808 ms at 18,570,459
// entries (NVIDIA H100 80GB HBM3, 700.00 W); its counts mode wrote the
// [N] flags nothing read. The ranked scatter (scatter.cu) runs the same
// chained scan with its bits as the epilogue, so the build's pass 2 runs
// no rank mode of its own.
#include <cuda_runtime.h>

#include "dedup.cuh"
#include "scan.cuh"

namespace {

using namespace ganon_entries;

__global__ void __launch_bounds__(kThreads)
dedup_counts_kernel(const int* __restrict__ key,
                    const unsigned long long* __restrict__ val, long long N,
                    int R, int* __restrict__ counts) {
    const long long s0 = (long long)blockIdx.x * kTile
                         + (threadIdx.x >> 5) * kWarpTile;
    if (s0 >= N) return;  // warp-uniform
    Entries E;
    load_rows<true>(key, val, s0, N, E);
    first_flags(key, val, s0, N, R, E);
    unsigned excl[kRows];
    warp_ranks(E, excl);
    add_counts(E, excl, R, counts);
}

__global__ void __launch_bounds__(kThreads)
dedup_rank_kernel(const int* __restrict__ key,
                  const unsigned long long* __restrict__ val, long long N,
                  int R, unsigned long long* status, unsigned long long epoch,
                  int* __restrict__ uniq, int* __restrict__ rank,
                  int* __restrict__ counts) {
    __shared__ unsigned s_tile;
    __shared__ unsigned s_warp[kWarps];
    __shared__ long long s_excl;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    ganon_scan::draw_tile(status, &s_tile);
    __syncthreads();
    const long long tile = s_tile;
    const long long s0 = tile * kTile + wid * kWarpTile;
    Entries E;
    load_rows<true>(key, val, s0, N, E);
    first_flags(key, val, s0, N, R, E);
    unsigned excl[kRows];
    const unsigned run = warp_ranks(E, excl);
    if (lane == 0) s_warp[wid] = run;
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const unsigned x = s_warp[w];
        before += w < wid ? x : 0;
        total += x;
    }
    const long long base =
        ganon_scan::chain_publish(status + 1, tile, tile == 0, total, epoch,
                                  &s_excl) + before;
    if (counts) add_counts(E, excl, R, counts);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const long long i = s0 + j * kRowSpan + kVec * lane;
        int u[kVec], r[kVec];
        unsigned x = excl[j];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            u[e] = (E.first[j] >> e) & 1u;
            r[e] = (int)(base + x);
            x += u[e];
        }
        if (E.ok[j] == 0xFu) {
            *reinterpret_cast<int4*>(uniq + i) = make_int4(u[0], u[1], u[2], u[3]);
            *reinterpret_cast<int4*>(rank + i) = make_int4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                if ((E.ok[j] >> e) & 1u) {
                    uniq[i + e] = u[e];
                    rank[i + e] = r[e];
                }
            }
        }
    }
}

}  // namespace

// key, val: the N sorted entries (16-byte aligned); counts: int32 [R],
// added to (NULL = none). Counts mode (rank NULL: uniq, status unused):
// counts required. Rank mode: uniq and rank int32 [N] (16-byte aligned),
// written whole; status: int64 [1 + ceil(N / 4096)] chained-scan words
// and epoch as for ganon_ragged (scan.cu).
extern "C" int ganon_dedup(const void* key, const void* val, long long N,
                           int R, void* uniq, void* rank, void* counts,
                           void* status, unsigned long long epoch,
                           void* stream) {
    if (N >= (1ll << 31) || (!rank && !counts)
        || (rank && (!uniq || !status || epoch < 1 || epoch >= (1ull << 31))))
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
    const long long tiles = (N + kTile - 1) / kTile;
    cudaStream_t s = (cudaStream_t)stream;
    if (!rank) {
        dedup_counts_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
            (const int*)key, (const unsigned long long*)val, N, R,
            (int*)counts);
    } else {
        dedup_rank_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
            (const int*)key, (const unsigned long long*)val, N, R,
            (unsigned long long*)status, epoch, (int*)uniq, (int*)rank,
            (int*)counts);
    }
    return (int)cudaGetLastError();
}
