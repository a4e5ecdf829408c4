// bins, tsum, bins_target: the ops library's counts over the interleaved
// bit-matrix.
//
// Replaces the JAX device programs of the library API (K18):
//   ganon_tpu/ops/ibf_query.py:113 bulk_count_bins     (mode bins),
//   ganon_tpu/ops/ibf_query.py:137 target_counts       (mode tsum),
//   ganon_tpu/ops/ibf_query.py:470 bulk_target_counts  (mode bins_target).
//
// bins: counts[b, 32 w + i] = number of valid hashes m (hash_mask[b, m])
// whose S rows rows[b, m, :] all have bit i of word w set, over the
// matrix bits [R, W] as saved (bin j in word j / 32, bit j % 32; padding
// bins are counted too, as in JAX). tsum: out[b, t] = sum of
// bin_counts[b, j] over the bins j with bin_to_target[j] == t; an id
// outside [0, T) is dropped (JAX's one_hot zeroes it; padding bins carry
// id T). bins_target: the per-bin counts, permuted by perm when it is
// given (column j of the permuted matrix is bin perm[j]), summed over
// [starts[t], ends[t]) (JAX's cumsum difference: a range with ends <
// starts reads minus the sum over [ends, starts)).
//
// What bounds it on the H100: device memory. bins gathers each valid
// hash's S rows of 4 W bytes and writes 128 W bytes per read, so the
// [B, 32 W] int32 output dominates the bytes at a filter's widths; tsum
// reads [B, TB] and writes [B, T]. The TPU program expanded [B, M, W, 32]
// bit planes and summed them (~4 GB at 16,384 reads of a 1024-target
// filter); here nothing of that size exists.
//
// Design: bins is one block per read. Each thread owns one word of the
// row at a time and keeps its 32 bit counters in registers; the read's
// rows and mask come through shared memory in chunks of kMChunk hashes;
// a row wider than the block loops. tsum is one block per read: a row of
// at most kSharedT targets accumulates in shared memory with shared
// atomics and is written once, a wider row adds straight into the zeroed
// output with global atomics (integer adds, so the order does not matter).
// bins_target runs bins into a [B, 32 W] scratch buffer, then one block
// per read walks each target's range (ranges are a few bins wide).
#include <cuda_runtime.h>

namespace {

constexpr int kMChunk = 256;   // hashes whose rows sit in shared memory
constexpr int kMaxS = 8;       // hash functions (rows per hash)
constexpr int kSharedT = 12288;  // targets a tsum block sums in shared

__global__ void bins_kernel(const unsigned* __restrict__ bits, long long W,
                            const int* __restrict__ rows, int M, int S,
                            const unsigned char* __restrict__ mask,
                            int* __restrict__ out) {
    __shared__ int srows[kMChunk * kMaxS];
    __shared__ unsigned char smask[kMChunk];
    const long long b = blockIdx.x;
    const int* brows = rows + b * (long long)M * S;
    const unsigned char* bmask = mask + b * (long long)M;
    int* orow = out + b * W * 32;
    for (long long w0 = 0; w0 < W; w0 += blockDim.x) {
        const long long w = w0 + threadIdx.x;
        int cnt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) cnt[i] = 0;
        for (int m0 = 0; m0 < M; m0 += kMChunk) {
            const int mn = min(kMChunk, M - m0);
            __syncthreads();
            for (int i = threadIdx.x; i < mn * S; i += blockDim.x)
                srows[i] = brows[(long long)m0 * S + i];
            for (int i = threadIdx.x; i < mn; i += blockDim.x)
                smask[i] = bmask[m0 + i];
            __syncthreads();
            if (w >= W) continue;
            for (int m = 0; m < mn; ++m) {
                if (!smask[m]) continue;
                unsigned v = bits[(long long)srows[m * S] * W + w];
                for (int s = 1; s < S; ++s)
                    v &= bits[(long long)srows[m * S + s] * W + w];
#pragma unroll
                for (int i = 0; i < 32; ++i) cnt[i] += (v >> i) & 1u;
            }
        }
        if (w < W) {
#pragma unroll
            for (int i = 0; i < 32; ++i) orow[w * 32 + i] = cnt[i];
        }
    }
}

__global__ void tsum_kernel(const int* __restrict__ bc, long long TB,
                            const int* __restrict__ b2t, int T,
                            int* __restrict__ out, int use_shared) {
    extern __shared__ int acc[];
    const long long b = blockIdx.x;
    int* orow = out + b * (long long)T;
    if (use_shared) {
        for (int t = threadIdx.x; t < T; t += blockDim.x) acc[t] = 0;
        __syncthreads();
    }
    const int* row = bc + b * TB;
    for (long long j = threadIdx.x; j < TB; j += blockDim.x) {
        const int t = b2t[j];
        const int v = row[j];
        if (t < 0 || t >= T || v == 0) continue;
        atomicAdd(use_shared ? acc + t : orow + t, v);
    }
    if (use_shared) {
        __syncthreads();
        for (int t = threadIdx.x; t < T; t += blockDim.x) orow[t] = acc[t];
    }
}

__global__ void segment_kernel(const int* __restrict__ cb, long long TB,
                               const int* __restrict__ perm,
                               const int* __restrict__ starts,
                               const int* __restrict__ ends, int T,
                               int* __restrict__ out) {
    const long long b = blockIdx.x;
    const int* row = cb + b * TB;
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const int s = starts[t], e = ends[t];
        const int lo = min(s, e), hi = max(s, e);
        int acc = 0;
        for (int j = lo; j < hi; ++j) acc += row[perm ? perm[j] : j];
        out[b * T + t] = s <= e ? acc : -acc;
    }
}

int bins_threads(long long W) {
    const long long t = (W + 31) / 32 * 32;
    return (int)(t < 32 ? 32 : t > 256 ? 256 : t);
}

}  // namespace

extern "C" int ganon_bins(const void* bits, long long R, long long W,
                          const void* rows, long long B, int M, int S,
                          const void* mask, void* out, void* stream) {
    (void)R;
    if (W <= 0 || S < 1 || S > kMaxS || M < 0)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    bins_kernel<<<(unsigned)B, bins_threads(W), 0, (cudaStream_t)stream>>>(
        (const unsigned*)bits, W, (const int*)rows, M, S,
        (const unsigned char*)mask, (int*)out);
    return (int)cudaGetLastError();
}

extern "C" int ganon_tsum(const void* bc, long long B, long long TB,
                          const void* b2t, int T, void* out, void* stream) {
    if (T <= 0 || TB < 0) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const int use_shared = T <= kSharedT;
    tsum_kernel<<<(unsigned)B, 256, use_shared ? T * sizeof(int) : 0,
                  (cudaStream_t)stream>>>(
        (const int*)bc, TB, (const int*)b2t, T, (int*)out, use_shared);
    return (int)cudaGetLastError();
}

extern "C" int ganon_bins_target(const void* bits, long long R, long long W,
                                 const void* rows, long long B, int M, int S,
                                 const void* mask, void* scratch,
                                 const void* perm, const void* starts,
                                 const void* ends, int T, void* out,
                                 void* stream) {
    (void)R;
    if (W <= 0 || S < 1 || S > kMaxS || M < 0 || T <= 0)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    bins_kernel<<<(unsigned)B, bins_threads(W), 0, st>>>(
        (const unsigned*)bits, W, (const int*)rows, M, S,
        (const unsigned char*)mask, (int*)scratch);
    segment_kernel<<<(unsigned)B, 256, 0, st>>>(
        (const int*)scratch, W * 32, (const int*)perm, (const int*)starts,
        (const int*)ends, T, (int*)out);
    return (int)cudaGetLastError();
}
