// merge: one filter's clamped counts -> the level's union counts + winners.
//
// Replaces the per-filter union step of the JAX device program
//   ganon_tpu/classify/device.py:542 classify_batch_packed_multi
//   (:587-604: per-filter rel-cutoff, scatter into union columns,
//   strict-greater max with the winning filter's index)          (K13).
//
// For every read b and target t of filter f:
//   cutoff = max(ceil(n[b] * rel_cutoff), 1)    (in double, as in JAX)
//   valid  = 0 < n[b] <= hashes_limit
//   cand   = (counts[b, t] >= cutoff && valid) ? counts[b, t] : 0
//   if cand > ucounts[b, cols[t]]: ucounts[b, cols[t]] = cand, uwin[.] = f
//
// The caller zeroes ucounts and uwin and launches once per filter, in
// filter order, on one stream: that order is what makes the first filter
// win ties (a later one must be strictly greater), with no atomics,
// because cols holds no column twice within one filter. A column no
// filter passes keeps count 0 and winner 0.
//
// What bounds it on the H100: device memory, an elementwise pass reading
// the [B, T_f] counts and reading and writing the touched union entries
// (about 16 bytes per element). Design: one thread per element, blocks
// along a read's row (blockIdx.x the read, blockIdx.y the column chunk),
// so each thread reads its row's n once and its loads coalesce.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ counts, int Tf,
             const int* __restrict__ n_hashes, double rel_cutoff,
             long long hashes_limit, const int* __restrict__ cols, int f,
             int* __restrict__ ucounts, int* __restrict__ uwin, int U) {
    const long long b = blockIdx.x;
    const int t = blockIdx.y * kThreads + threadIdx.x;
    if (t >= Tf) return;
    const int n = n_hashes[b];
    const bool valid = n > 0 && (long long)n <= hashes_limit;
    if (!valid) return;  // cand is 0 and never beats a union entry
    const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
    const int c = counts[b * Tf + t];
    if (c < cutoff) return;
    const long long u = b * U + cols[t];
    if (c > ucounts[u]) {
        ucounts[u] = c;
        uwin[u] = f;
    }
}

}  // namespace

extern "C" int ganon_merge(const void* counts, long long B, int Tf,
                           const void* n_hashes, double rel_cutoff,
                           long long hashes_limit, const void* cols, int f,
                           void* ucounts, void* uwin, int U, void* stream) {
    if (B <= 0 || Tf <= 0) return 0;
    const unsigned chunks = (unsigned)((Tf + kThreads - 1) / kThreads);
    if (chunks > 65535u) return (int)cudaErrorInvalidValue;
    merge_kernel<<<dim3((unsigned)B, chunks), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const int*)counts, Tf, (const int*)n_hashes, rel_cutoff,
        hashes_limit, (const int*)cols, f, (int*)ucounts, (int*)uwin, U);
    return (int)cudaGetLastError();
}
