// gate: compacted minimizers -> coarse group counts, cutoff, top-S groups.
//
// Replaces the JAX device programs of the merged-bin pruned forest
//   ganon_tpu/classify/device.py:1067 bulk_group_counts            (K14),
//   the gate and top-S block of :1119 classify_batch_packed_pruned
//     (:1168-1192)                                                  (K14),
//   and the gate of :1394 _pruned_all_counts (:1437-1451)          (K15).
//
// Per read: gcount[g] = number of the read's first min(n, M) hashes whose
// coarse_h coarse rows all have bit g set. The read is valid when
// 0 < n <= hashes_limit; cutoff = max(1, ceil(n * rel_cutoff)) in double;
// group g survives when the read is valid and gcount[g] >= cutoff. The
// top S survivors by descending count, the lower group id first on ties
// (jnp.argmax takes the first maximum), go to gsel/slot_ok; dead slots
// read gsel 0, slot_ok 0. overflow_out = overflow_in | (n_surv > S).
// With surv given, the [B, G] survive mask is written too (the probe-all
// path); S may be 0 there.
//
// What bounds it on the H100: the coarse table is small (ceil(G/8) bytes
// per row, 16 bytes at G = 128) and stays in L2, so per read it is h
// gathers per hash of a few words and the shared-memory counter adds.
//
// Design: one block per read. The block hashes its minimizers into
// shared memory, then (hash, word) pairs spread over the threads: each
// ANDs its h coarse words and adds every set bit to its group's counter
// with a shared atomicAdd. Counters are int32 (exact at any n) in tiles
// of kGroupTile groups (32 KB), so any G fits shared memory: a tile is
// counted, its survivors written and counted, and its best S keys merged
// into a running top-S list. A key is (count << 32) | (~g): unique, and
// ordered exactly as the argmax passes order their picks. The coarse
// table is bit-packed per group (no per-target byte padding); padding
// bits past G are never set and are skipped.
#include <cuda_runtime.h>

#include <cstdint>

#include "ibf_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupTile = 8192;  // int32 counters per tile: 32 KB
constexpr int kHashChunk = 128;   // hashes whose rows sit in shared memory
constexpr int kMaxH = 5;
constexpr int kMaxS = 32;

__device__ unsigned long long block_max_u64(unsigned long long v,
                                            unsigned long long* scratch) {
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(0xFFFFFFFFu, v, o);
        v = u > v ? u : v;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch is free
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int i = 1; i < kWarps; ++i) v = scratch[i] > v ? scratch[i] : v;
    return v;
}

__device__ int block_sum(int v, unsigned long long* scratch) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if (lane == 0) scratch[warp] = (unsigned long long)v;
    __syncthreads();
    int s = 0;
    for (int i = 0; i < kWarps; ++i) s += (int)scratch[i];
    return s;
}

__global__ void __launch_bounds__(kThreads)
gate_kernel(const unsigned* __restrict__ ctbl, long long W32,
            const long long* __restrict__ hashes, int M,
            const int* __restrict__ n_hashes, unsigned long long bin_size,
            int h, int shift, int G, double rel_cutoff, long long hashes_limit,
            int S, const unsigned char* __restrict__ overflow_in,
            int* __restrict__ gsel, unsigned char* __restrict__ slot_ok,
            unsigned char* __restrict__ overflow_out,
            unsigned char* __restrict__ surv) {
    __shared__ int cnt[kGroupTile];
    __shared__ unsigned long long rows[kHashChunk * kMaxH];
    __shared__ unsigned long long scratch[kWarps];
    __shared__ unsigned long long top[kMaxS];

    const long long b = blockIdx.x;
    const int n = n_hashes[b];
    const bool valid = n > 0 && (long long)n <= hashes_limit;
    const int nvalid = valid ? min(n, M) : 0;  // invalid reads count nothing
    const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
    const long long* hrow = hashes + b * M;
    if (threadIdx.x < S) top[threadIdx.x] = 0;  // 0: an empty slot

    int n_surv = 0;  // this thread's survivors
    for (int g0 = 0; g0 < G; g0 += kGroupTile) {
        const int tg = min(kGroupTile, G - g0);
        const int tw = (tg + 31) >> 5;        // words of the tile
        const long long w0 = g0 >> 5;         // kGroupTile is a multiple of 32
        for (int j = threadIdx.x; j < tg; j += blockDim.x) cnt[j] = 0;
        for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
            const int mn = min(kHashChunk, nvalid - m0);
            __syncthreads();  // counters cleared; the last chunk's rows read
            for (int q = threadIdx.x; q < mn * h; q += blockDim.x) {
                const int m = q / h, s = q - m * h;
                rows[q] = ganon_ibf_row((unsigned long long)hrow[m0 + m], s,
                                        bin_size, shift);
            }
            __syncthreads();
            for (int q = threadIdx.x; q < mn * tw; q += blockDim.x) {
                const int m = q / tw, j = q - m * tw;
                const unsigned long long* r = rows + m * h;
                unsigned v = ctbl[(long long)r[0] * W32 + w0 + j];
                for (int s = 1; s < h; ++s)
                    v &= ctbl[(long long)r[s] * W32 + w0 + j];
                while (v) {
                    const int g = (j << 5) + __ffs(v) - 1;
                    v &= v - 1;
                    if (g < tg) atomicAdd(cnt + g, 1);
                }
            }
        }
        __syncthreads();  // the tile's counts are complete
        for (int j = threadIdx.x; j < tg; j += blockDim.x) {
            const bool sv = valid && cnt[j] >= cutoff;
            n_surv += sv;
            if (surv) surv[b * G + g0 + j] = sv;
        }
        // the tile's best S keys, merged into the running top (thread 0)
        unsigned long long prev = ~0ULL;
        for (int s = 0; s < S; ++s) {
            unsigned long long best = 0;
            for (int j = threadIdx.x; j < tg; j += blockDim.x) {
                if (valid && cnt[j] >= cutoff) {
                    const unsigned long long key =
                        ((unsigned long long)cnt[j] << 32) |
                        (0xFFFFFFFFu - (unsigned)(g0 + j));
                    if (key < prev && key > best) best = key;
                }
            }
            best = block_max_u64(best, scratch);
            if (best == 0) break;  // uniform: every thread read the same
            prev = best;
            if (threadIdx.x == 0 && best > top[S - 1]) {
                int i = S - 1;
                while (i > 0 && top[i - 1] < best) {
                    top[i] = top[i - 1];
                    --i;
                }
                top[i] = best;
            }
        }
        __syncthreads();  // before the next tile clears the counters
    }
    n_surv = block_sum(n_surv, scratch);  // syncs: top[] is final
    if (threadIdx.x < S) {
        const unsigned long long key = top[threadIdx.x];
        gsel[b * S + threadIdx.x] =
            key ? (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFu)) : 0;
        slot_ok[b * S + threadIdx.x] = key != 0;
    }
    if (threadIdx.x == 0 && overflow_out)
        overflow_out[b] = (unsigned char)((overflow_in ? overflow_in[b] : 0) |
                                          (n_surv > S ? 1 : 0));
}

}  // namespace

extern "C" int ganon_gate(const void* ctbl, long long R, long long W8,
                          const void* hashes, long long B, int M,
                          const void* n_hashes, unsigned long long bin_size,
                          int h, int shift, int G, double rel_cutoff,
                          long long hashes_limit, int S,
                          const void* overflow_in, void* gsel, void* slot_ok,
                          void* overflow_out, void* surv, void* stream) {
    (void)R;
    if (h < 1 || h > kMaxH || W8 % 4 || S < 0 || S > kMaxS || G < 1 ||
        (long long)(G + 31) / 32 > W8 / 4)
        return (int)cudaErrorInvalidValue;
    gate_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)ctbl, W8 / 4, (const long long*)hashes, M,
        (const int*)n_hashes, bin_size, h, shift, G, rel_cutoff, hashes_limit,
        S, (const unsigned char*)overflow_in, (int*)gsel,
        (unsigned char*)slot_ok, (unsigned char*)overflow_out,
        (unsigned char*)surv);
    return (int)cudaGetLastError();
}
