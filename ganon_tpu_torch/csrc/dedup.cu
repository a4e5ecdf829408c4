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
//   rank[i]   = sum of uniq[:i] (an exclusive scan), when rank is not NULL
//   counts[f] += number of i with uniq[i] and key[i] == f, when counts is
//               not NULL (a file's entries are contiguous after the sort)
// The JAX per-file overflow flag has no counterpart: the port's extract
// runs at a capacity of every window position and never overflows.
//
// What bounds it on the H100: bytes (12 bytes of entry read, 4 of flag
// and 4 of rank written per entry). The counts are adds into R int32
// slots that every entry of a file hits in turn: one atomicAdd per
// distinct entry contends on a handful of addresses (13.7 ms for 18.6M
// entries in 133 files, chip_smoke.py on an NVIDIA H100 80GB HBM3 at
// 700 W), so a warp adds once per file.
//
// Design: one thread per entry compares with its left neighbour; the
// warp's entries of one file are found with __match_any_sync and counted
// with a ballot; the rank is sort.cu's exclusive scan over the flags.
#include <cuda_runtime.h>

#include <cstdint>

extern "C" int ganon_scan(const void* in, void* out, long long M, void* sums,
                          const void* base, void* total, void* stream);

namespace {

__global__ void dedup_flags(const int* __restrict__ key,
                            const long long* __restrict__ val,
                            long long N, int R, int* __restrict__ uniq,
                            int* __restrict__ counts) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    int k = -1, u = 0;
    if (i < N) {
        k = key[i];
        u = (i == 0 || k != key[i - 1] || val[i] != val[i - 1]) && k < R;
        uniq[i] = u;
    }
    if (!counts) return;
    // one atomicAdd per file present in the warp: a sorted warp holds one
    // or two files, so the R counters see ~n/32 adds, not one per entry
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const unsigned ones = __ballot_sync(0xffffffffu, u);
    const int lane = threadIdx.x & 31;
    if (u && lane == __ffs(peers & ones) - 1)
        atomicAdd(counts + k, __popc(peers & ones));
}

}  // namespace

// key, val: the N sorted entries; uniq: int32 [N]; rank: int32 [N] or
// NULL; counts: int32 [R] (added to) or NULL; sums: int64 scan scratch of
// ceil(N / 2048) entries.
extern "C" int ganon_dedup(const void* key, const void* val, long long N,
                           int R, void* uniq, void* rank, void* counts,
                           void* sums, void* stream) {
    if (N <= 0) return (int)cudaGetLastError();
    const int threads = 256;
    const long long blocks = (N + threads - 1) / threads;
    dedup_flags<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)key, (const long long*)val, N, R, (int*)uniq,
        (int*)counts);
    int err = (int)cudaGetLastError();
    if (err || !rank) return err;
    return ganon_scan(uniq, rank, N, sums, nullptr, nullptr, stream);
}
