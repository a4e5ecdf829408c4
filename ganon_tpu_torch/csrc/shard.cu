// combine: the partial counts of a column-sharded table -> clamped counts.
//
// Replaces the cross-shard half of the JAX device program K17:
// ganon_tpu/parallel/mesh.py:79 ShardedClassifier.counts over the
// column-sharded DeviceFilter (ganon_tpu/classify/device.py:749-768), where
// GSPMD all-gathers the per-byte counts [B, W8] over the mesh's bins axis
// before the per-target segment sum and the clamp of filter_counts_u8.
// Here every shard sums its own targets (count.cu in shard mode, clamp
// off), its partials reach the batch row's first device, and this kernel
// adds the nb partials of each (read, target) and clamps the sum to
// n_hashes[b]. The clamp must follow the sum: a target split across two
// shards can be under n in each half and over n in total.
//
// Layout: parts holds nb blocks, shard j's block at element
// B * sum_{i<j} (t_hi[i] - t_lo[i]), row-major [B, t_hi[j] - t_lo[j]] over
// its targets t_lo[j] .. t_hi[j] - 1 (a shard's partials are sized by its
// target range, never [B, T]). Flat or forest mode writes
// counts[b * ldc + col0 + t]; column-max mode (a raptor sub, cols given)
// writes counts[b * ldc + cols[t]] = max(old, v), as count.cu does. A
// target no shard holds (a zero-width byte range) reads 0.
//
// What bounds it on the H100: device memory. Each partial is read once
// and [B, T] written once; a compare and an add per shard per element.
//
// Design: one block per read; the shards' target spans and block offsets
// sit in shared memory; thread t walks the spans (nb is the mesh's bins
// axis, a handful) and adds the partials of the shards that hold t.
// Consecutive threads read consecutive targets of a block row, so the
// reads are coalesced; the block owns its output row, so no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 1024;

__global__ void __launch_bounds__(kThreads)
combine_kernel(const int* __restrict__ parts, const int* __restrict__ t_lo,
               const int* __restrict__ t_hi, int nb, long long B, int T,
               const int* __restrict__ n_hashes, int* __restrict__ counts,
               long long ldc, int col0, const int* __restrict__ cols) {
    __shared__ int lo[kMaxShards];
    __shared__ int hi[kMaxShards];
    __shared__ long long off[kMaxShards];

    if (threadIdx.x == 0) {
        long long o = 0;
        for (int j = 0; j < nb; ++j) {
            lo[j] = t_lo[j];
            hi[j] = t_hi[j];
            off[j] = o;
            o += B * (long long)(hi[j] - lo[j]);
        }
    }
    __syncthreads();
    const long long b = blockIdx.x;
    const int n = n_hashes[b];
    int* orow = counts + b * ldc;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        int acc = 0;
        for (int j = 0; j < nb; ++j) {
            if (t >= lo[j] && t < hi[j]) {
                const long long w = hi[j] - lo[j];
                acc += parts[off[j] + b * w + (t - lo[j])];
            }
        }
        const int v = min(acc, n);
        if (cols) {
            int* o = orow + cols[t];
            *o = max(*o, v);
        } else {
            orow[col0 + t] = v;
        }
    }
}

}  // namespace

extern "C" int ganon_combine(const void* parts, const void* t_lo,
                             const void* t_hi, int nb, long long B, int T,
                             const void* n_hashes, void* counts,
                             long long ldc, int col0, const void* cols,
                             void* stream) {
    if (nb < 1 || nb > kMaxShards || col0 < 0
        || (!cols && col0 + (long long)T > ldc) || (cols && col0 != 0))
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || T <= 0) return (int)cudaGetLastError();
    combine_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)parts, (const int*)t_lo, (const int*)t_hi, nb, B, T,
        (const int*)n_hashes, (int*)counts, ldc, col0, (const int*)cols);
    return (int)cudaGetLastError();
}
