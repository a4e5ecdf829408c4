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
// per row, 16 bytes at G = 128) and mostly L2-resident, and a read needs
// ~40 hashes x coarse_h rows of it: a few KB a read, so the bytes bound
// is microseconds for a batch. A launch costs latency (a hash load, then
// a row load) and the instructions that turn the rows' bits into counts.
//
// Design: one warp a read, kWarps reads a block, no shared memory and no
// block barrier (warp_bits.cuh). In each round of 32 hashes lane i takes
// hash m0 + i, computes its coarse_h rows and loads each row's words of
// the current group tile (one 16-byte load at G = 128), ANDed over
// coarse_h. The warp then counts every group bit of the round at once by
// a bit transpose of shuffles: group g0 + 32 r
// + k is cnt[r] of lane k, NW registers a lane for a tile of 32 NW groups
// (NW <= 32, so up to 1024 groups; a larger G walks tiles and hashes the
// rows again). After a tile its survivors are written coalesced, and its
// best keys enter a running top-S list held by lanes 0..S-1: rounds of a
// warp max (__shfl_xor_sync) over the key (count << 32) | ~g, unique and
// ordered as the argmax passes order their picks, each inserted in place
// by a ballot of the keys above it, until a key falls below the list.
// The coarse table is bit-packed per group; padding bits past G are never
// counted.
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_bits.cuh"

namespace {

constexpr int kWarps = 8;  // reads a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxS = 32;  // one slot a lane
constexpr int kMaxWords = 32;  // group words a tile: 1024 groups

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(kFullMask, v, o);
        v = u > v ? u : v;
    }
    return v;
}

// the top-S key of group g with count c: 0 for a group out of the running
__device__ __forceinline__ unsigned long long top_key(int c, int g) {
    return c < 0 ? 0ULL
                 : ((unsigned long long)c << 32) | (0xFFFFFFFFu - (unsigned)g);
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const unsigned* __restrict__ ctbl, long long W32, bool vec,
            const long long* __restrict__ hashes, long long B, int M,
            const int* __restrict__ n_hashes, unsigned long long bin_size,
            int h, int shift, int G, double rel_cutoff, long long hashes_limit,
            int S, const unsigned char* __restrict__ overflow_in,
            int* __restrict__ gsel, unsigned char* __restrict__ slot_ok,
            unsigned char* __restrict__ overflow_out,
            unsigned char* __restrict__ surv) {
    constexpr int kTile = 32 * NW;  // groups a tile
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp
    const int n = n_hashes[b];
    const bool valid = n > 0 && (long long)n <= hashes_limit;
    const int nvalid = valid ? min(n, M) : 0;  // invalid reads count nothing
    const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
    const long long* hrow = hashes + b * M;

    unsigned long long top = 0;      // lane s < S: the s-th best key, 0 empty
    unsigned long long top_min = 0;  // lane S - 1's key
    int n_surv = 0;                  // the same in every lane
    for (int g0 = 0; g0 < G; g0 += kTile) {
        const long long w0 = g0 >> 5;
        int cnt[NW];
#pragma unroll
        for (int r = 0; r < NW; ++r) cnt[r] = 0;
        count_rows<NW>(ctbl, W32, vec, w0, hrow, nvalid, bin_size, shift, 0,
                       h, G - g0, lane, cnt);
        // survivors; every other group leaves the running (count -1)
#pragma unroll
        for (int r = 0; r < NW; ++r) {
            const int g = g0 + 32 * r + lane;
            const bool sv = valid && g < G && cnt[r] >= cutoff;
            n_surv += __popc(__ballot_sync(kFullMask, sv));
            if (surv && g < G) surv[b * G + g] = sv;
            if (!sv) cnt[r] = -1;
        }
        // the tile's keys in descending order, while they beat the list
        for (int s = 0; s < S; ++s) {
            unsigned long long best = 0;
#pragma unroll
            for (int r = 0; r < NW; ++r) {
                const unsigned long long key =
                    top_key(cnt[r], g0 + 32 * r + lane);
                best = key > best ? key : best;
            }
            best = warp_max_u64(best);
            if (best <= top_min) break;  // uniform; 0 when none is left
#pragma unroll
            for (int r = 0; r < NW; ++r)
                if (top_key(cnt[r], g0 + 32 * r + lane) == best) cnt[r] = -1;
            // insert: lanes past its place shift down one, the last drops
            const int pos = __popc(__ballot_sync(kFullMask,
                                                 lane < S && top > best));
            const unsigned long long up = __shfl_up_sync(kFullMask, top, 1);
            if (lane > pos) top = up;
            if (lane == pos) top = best;
            top_min = __shfl_sync(kFullMask, top, S - 1);
        }
    }
    if (lane < S) {
        gsel[b * S + lane] =
            top ? (int)(0xFFFFFFFFu - (unsigned)(top & 0xFFFFFFFFu)) : 0;
        slot_ok[b * S + lane] = top != 0;
    }
    if (lane == 0 && overflow_out)
        overflow_out[b] = (unsigned char)((overflow_in ? overflow_in[b] : 0) |
                                          (n_surv > S ? 1 : 0));
}

template <int NW>
int launch(const void* ctbl, long long W8, const void* hashes, long long B,
           int M, const void* n_hashes, unsigned long long bin_size, int h,
           int shift, int G, double rel_cutoff, long long hashes_limit, int S,
           const void* overflow_in, void* gsel, void* slot_ok,
           void* overflow_out, void* surv, cudaStream_t stream) {
    const long long blocks = (B + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    gate_kernel<NW><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const unsigned*)ctbl, W8 / 4, rows_vectorizable<NW>(ctbl, W8 / 4),
        (const long long*)hashes, B, M, (const int*)n_hashes, bin_size, h,
        shift, G, rel_cutoff, hashes_limit, S,
        (const unsigned char*)overflow_in, (int*)gsel, (unsigned char*)slot_ok,
        (unsigned char*)overflow_out, (unsigned char*)surv);
    return (int)cudaGetLastError();
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
    if (h < 1 || h > kMaxHashFns || W8 % 4 || S < 0 || S > kMaxS || G < 1 ||
        (long long)(G + 31) / 32 > W8 / 4)
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int words = (G + 31) / 32;  // the smallest tile that holds G
    const auto run = words <= 1    ? &launch<1>
                     : words <= 2  ? &launch<2>
                     : words <= 4  ? &launch<4>
                     : words <= 8  ? &launch<8>
                     : words <= 16 ? &launch<16>
                                   : &launch<kMaxWords>;
    return run(ctbl, W8, hashes, B, M, n_hashes, bin_size, h, shift, G,
               rel_cutoff, hashes_limit, S, overflow_in, gsel, slot_ok,
               overflow_out, surv, (cudaStream_t)stream);
}
