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
// target range, never [B, T]). The spans are sorted (t_lo and t_hi
// nondecreasing) and overlap only at the targets a byte-range cut splits;
// a wide target can sit in three shards or more. Flat or forest mode
// writes counts[b * ldc + col0 + t] for every t < T; column-max mode (a
// raptor sub, cols given) writes counts[b * ldc + cols[t]] = max(old, v),
// as count.cu does. A target no shard holds (a zero-width byte range)
// reads 0.
//
// What bounds it on the H100: device memory. Each partial is read once
// and [B, T] written once; an add per shard per element.
//
// Design: the spans and the blocks' offsets go to the kernel by value (a
// __grid_constant__ parameter struct of at most kMaxShards shards), so no
// block loads them and none waits at a barrier. A thread owns kVec
// consecutive targets of a row (a quad), grid-stride over B x quads; the
// quads sit on 16-byte boundaries of the output, so a whole quad is one
// 16-byte store, and the edges of a row (col0 or ldc not multiples of 4,
// T not a multiple of 4) store scalars in the same kernel. A thread finds
// the first shard that holds its quad once; a quad inside one shard's span
// and no other's reads its four partials as one 16-byte load where the
// block row's alignment allows; a quad at a boundary target walks on to
// the next shards for that target only. Neighbouring threads read
// neighbouring partials of one block row, so the loads coalesce. (The
// earlier design, a block a read with the spans loaded into shared memory
// by one thread behind a barrier and every thread testing all nb spans a
// target, took 0.046 ms a call at 4096 x 1024 and 4 shards, bound 0.0100,
// on a caller that zero-filled both buffers first; NVIDIA H100 80GB HBM3,
// 700.00 W.)
#include <cuda_runtime.h>

#include <cstdint>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 32;  // ops/ibf_query.py COMBINE_MAX_SHARDS
constexpr int kVec = 4;
constexpr int kBlocksPerSm = 8;

struct Spans {
    long long off[kMaxShards];  // shard j's block: parts + off[j]
    int lo[kMaxShards];
    int hi[kMaxShards];
    int nb;
};

__global__ void __launch_bounds__(kThreads)
combine_kernel(const __grid_constant__ Spans sp,
               const int* __restrict__ parts, long long B, int T, int Q,
               const int* __restrict__ n_hashes, int* __restrict__ counts,
               long long ldc, int col0, const int* __restrict__ cols) {
    const long long items = B * Q;
    const long long step = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < items; i += step) {
        const long long b = i / Q;
        const int q = (int)(i - b * Q);
        int* orow = counts + b * ldc + (cols ? 0 : col0);
        // the quads sit on 16-byte boundaries of the output row
        const int head = cols ? 0 : (int)(((uintptr_t)orow >> 2) & (kVec - 1));
        const int t0 = q * kVec - head;
        if (t0 >= T) continue;
        const int n = n_hashes[b];
        // the first shard whose span ends past the quad's first target
        const int tf = t0 > 0 ? t0 : 0;
        int j = 0;
        while (j < sp.nb - 1 && sp.hi[j] <= tf) ++j;
        int acc[kVec];
        const bool whole = t0 >= 0 && t0 + kVec <= T;
        if (whole && sp.lo[j] <= t0 && t0 + kVec <= sp.hi[j]
            && (j + 1 == sp.nb || sp.lo[j + 1] >= t0 + kVec)) {
            // the quad lies in shard j alone
            const int* p = parts + sp.off[j]
                           + b * (sp.hi[j] - sp.lo[j]) + (t0 - sp.lo[j]);
            if (((uintptr_t)p & 15) == 0) {
                const int4 v = __ldg(reinterpret_cast<const int4*>(p));
                acc[0] = v.x; acc[1] = v.y; acc[2] = v.z; acc[3] = v.w;
            } else {
#pragma unroll
                for (int e = 0; e < kVec; ++e) acc[e] = __ldg(p + e);
            }
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const int t = t0 + e;
                acc[e] = 0;
                if (t < 0 || t >= T) continue;
                while (j < sp.nb - 1 && sp.hi[j] <= t) ++j;
                // j and the next shards that start at or before t: more
                // than one only at a boundary target
                for (int k = j; k < sp.nb && sp.lo[k] <= t; ++k) {
                    if (t < sp.hi[k])
                        acc[e] += __ldg(parts + sp.off[k]
                                        + b * (sp.hi[k] - sp.lo[k])
                                        + (t - sp.lo[k]));
                }
            }
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = min(acc[e], n);
        if (cols) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const int t = t0 + e;
                if (t < T) {
                    int* o = orow + __ldg(cols + t);
                    *o = max(*o, acc[e]);
                }
            }
        } else if (whole) {
            *reinterpret_cast<int4*>(orow + t0) =
                make_int4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
                const int t = t0 + e;
                if (t >= 0 && t < T) orow[t] = acc[e];
            }
        }
    }
}

}  // namespace

// parts: parts_n int32 partials; t_lo, t_hi: HOST int32 [nb], the shards'
// target spans (read here and passed to the kernel by value), at most
// kMaxShards, sorted within [0, T], their blocks inside parts: else
// cudaErrorInvalidValue, before any launch.
extern "C" int ganon_combine(const void* parts, long long parts_n,
                             const void* t_lo, const void* t_hi, int nb,
                             long long B, int T,
                             const void* n_hashes, void* counts,
                             long long ldc, int col0, const void* cols,
                             void* stream) {
    if (nb < 1 || nb > kMaxShards || col0 < 0 || T < 0
        || (!cols && col0 + (long long)T > ldc) || (cols && col0 != 0)
        || ((uintptr_t)counts & 3))
        return (int)cudaErrorInvalidValue;
    Spans sp{};
    sp.nb = nb;
    const int* lo = (const int*)t_lo;
    const int* hi = (const int*)t_hi;
    long long off = 0;
    for (int j = 0; j < nb; ++j) {
        if (lo[j] < 0 || lo[j] > hi[j] || hi[j] > T
            || (j && (lo[j] < lo[j - 1] || hi[j] < hi[j - 1])))
            return (int)cudaErrorInvalidValue;
        sp.lo[j] = lo[j];
        sp.hi[j] = hi[j];
        sp.off[j] = off;
        off += B * (long long)(hi[j] - lo[j]);
    }
    if (off > parts_n) return (int)cudaErrorInvalidValue;
    if (B <= 0 || T <= 0) return (int)cudaGetLastError();
    // quads a row: one more where the row's head is not 16-byte aligned
    const int Q = cols ? (T + kVec - 1) / kVec : (T + 2 * kVec - 2) / kVec;
    const long long items = B * Q;
    long long blocks = (items + kThreads - 1) / kThreads;
    const long long cap = (long long)sm_count() * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    combine_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        sp, (const int*)parts, B, T, Q, (const int*)n_hashes, (int*)counts,
        ldc, col0, (const int*)cols);
    return (int)cudaGetLastError();
}
