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
// Design. bins gives a warp a read's run of up to kMaxPer spans of kSpan
// words (fewer while the grid would leave an SM under kWarpsPerSm warps),
// kWarps warps a block, no shared memory and no block barrier. The warp
// compacts the read's valid slots by ballot into rounds of 32 hashes (a
// read with n valid hashes takes ceil(n / 32) rounds, wherever the mask's
// holes are); lane i keeps its hash's row index for the round and walks
// the spans with it, loading each span of its S rows in 16-byte tiles
// where the rows allow (warp_bits.cuh's load_words) and ANDing them, and
// the warp counts every bit of the span by the shuffle bit transpose
// (warp_count): bin 32 (w0 + r) + k lands in lane k's cnt[r], so each of
// the span's words is stored as one whole 128-byte line (a later round
// adds to what the first stored). At 64 registers a thread an SM holds 32
// warps. bins_target counts the same way into a slice of shared memory
// (32 W int32 a read; up to kWarps reads a block while their slices fit
// kFusedBlockBytes, the block's warps shared among them), waits on a
// barrier of the read's warps only, then the read's threads walk one
// target each over that slice and write [B, T] once: one launch, no
// scratch. A row whose slice does not fit a block's shared memory (the
// wrapper decides by shape: ops.library.bins_target_fused) takes two
// launches: bins into the caller's [B, 32 W] scratch, then one block a
// read walks each target's range there. Both walks load several targets'
// ranges, then their first counts, at once. tsum is one block per read: a
// row of at most kSharedT targets accumulates in shared memory with
// shared atomics and is written once, a wider row adds straight into the
// zeroed output with global atomics (integer adds, so the order does not
// matter).
#include <cuda_runtime.h>

#include "sm_count.cuh"
#include "warp_bits.cuh"

namespace {

constexpr int kMaxS = 8;         // hash functions (rows per hash)
constexpr int kSharedT = 12288;  // targets a tsum block sums in shared
constexpr int kWarps = 8;        // warps a bins / bins_target block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;    // blocks an SM: 64 registers a thread
constexpr int kTile = 4;         // words a load: 16 bytes
constexpr int kSpan = 16;        // words a warp counts: 16 counts a lane
constexpr int kTiles = kSpan / kTile;
// targets a thread sums at once: from shared memory, from the scratch
constexpr int kSharedTargets = 4;
constexpr int kScratchTargets = 8;
// shared memory a fused block fills with reads before it takes one
constexpr long long kFusedBlockBytes = 48 << 10;
constexpr int kMaxPer = 8;       // spans a bins warp walks, at most
constexpr int kWarpsPerSm = 32;  // bins warps to keep an SM busy

// Position of the k-th (from 0) set bit of x, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned x, int k) {
    int pos = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int c = __popc(x & ((1u << s) - 1u));
        if (k >= c) {
            k -= c;
            x >>= s;
            pos += s;
        }
    }
    return pos;
}

// v = the span of words from word w of slot's S rows, ANDed (zeros past
// the row; all zero when slot < 0).
__device__ __forceinline__ void load_hash(const unsigned* __restrict__ bits,
                                          long long W, bool vec, long long w,
                                          const int* __restrict__ brows,
                                          int S, int slot,
                                          unsigned (&v)[kTiles][kTile]) {
    if (slot < 0) {
#pragma unroll
        for (int t = 0; t < kTiles; ++t)
#pragma unroll
            for (int r = 0; r < kTile; ++r) v[t][r] = 0u;
        return;
    }
    const int* hr = brows + (long long)slot * S;
    const unsigned* row = bits + (long long)hr[0] * W + w;
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
        load_words<kTile>(row + t * kTile, W - w - t * kTile, vec, v[t]);
#pragma unroll
    for (int s = 1; s < kMaxS; ++s) {
        if (s >= S) break;
        row = bits + (long long)hr[s] * W + w;
#pragma unroll
        for (int t = 0; t < kTiles; ++t) {
            unsigned u[kTile];
            load_words<kTile>(row + t * kTile, W - w - t * kTile, vec, u);
#pragma unroll
            for (int r = 0; r < kTile; ++r) v[t][r] &= u[r];
        }
    }
}

// Adds to cnt one round of hashes: lane i's hash is slot (none when
// slot < 0); the warp counts the bits of the span (the first nbits of it
// exist).
__device__ __forceinline__ void count_round(
    const unsigned* __restrict__ bits, long long W, bool vec, long long w0,
    const int* __restrict__ brows, int S, int slot, int nbits, int lane,
    int (&cnt)[kTiles][kTile]) {
    unsigned v[kTiles][kTile];
    load_hash(bits, W, vec, w0, brows, S, slot, v);
#pragma unroll
    for (int t = 0; t < kTiles; ++t)
        warp_count<kTile>(v[t], nbits - 32 * kTile * t, lane, cnt[t]);
}

// Writes the counts of a read's spans sp0, sp0 + step, ... below end to
// dst (the read's [32 W] counts, in device or shared memory): bin 32 w + k
// of a span's word w as lane k's, so each word is one line of the 32
// lanes. The read's valid slots (bmask over M) enter rounds of 32 in slot
// order, the mask read 128 slots at a time (four independent loads a
// lane, then four ballots); each round walks every span with its row
// indices in registers, the first writing the counts and later ones
// (more than 32 valid hashes) adding to them.
__device__ __forceinline__ void count_spans(
    const unsigned* __restrict__ bits, long long W, bool vec,
    const int* __restrict__ brows, int M, int S,
    const unsigned char* __restrict__ bmask, long long sp0, long long step,
    long long end, int lane, int* __restrict__ dst) {
    int g = 0;     // the next group of 128 slots to read
    int m0 = 0;    // the current 32-slot chunk's first slot
    int left = 0;  // the group's chunks after the current
    unsigned bal = 0, n1 = 0, n2 = 0, n3 = 0;  // their untaken valid slots
    for (bool first = true;; first = false) {  // uniform: a round a pass
        int slot = -1, npend = 0;  // the round: lanes [0, npend)
        while (npend < 32) {
            if (!bal) {
                if (left) {
                    bal = n1, n1 = n2, n2 = n3, n3 = 0;
                    m0 += 32;
                    --left;
                } else if (g < M) {
                    bool ok[4];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int m = g + 32 * c + lane;
                        ok[c] = m < M && bmask[m];
                    }
                    bal = __ballot_sync(kFullMask, ok[0]);
                    n1 = __ballot_sync(kFullMask, ok[1]);
                    n2 = __ballot_sync(kFullMask, ok[2]);
                    n3 = __ballot_sync(kFullMask, ok[3]);
                    m0 = g;
                    left = 3;
                    g += 128;
                } else {
                    break;
                }
                continue;
            }
            const int take = min(__popc(bal), 32 - npend);
            const int k = lane - npend;
            if (k >= 0 && k < take) slot = m0 + nth_set_bit(bal, k);
            npend += take;
            // the slots taken, by their rank among the chunk's
            const bool mine = (bal >> lane) & 1u;
            const int rank = __popc(bal & ((1u << lane) - 1u));
            bal &= ~__ballot_sync(kFullMask, mine && rank < take);
        }
        if (!npend && !first) break;  // a read with none writes zeros
        for (long long sp = sp0; sp < end; sp += step) {
            const long long w0 = sp * kSpan;
            const int nbits = (int)min((long long)kSpan, W - w0) * 32;
            int cnt[kTiles][kTile];
#pragma unroll
            for (int t = 0; t < kTiles; ++t)
#pragma unroll
                for (int r = 0; r < kTile; ++r) cnt[t][r] = 0;
            if (npend)
                count_round(bits, W, vec, w0, brows, S, slot, nbits, lane,
                            cnt);
#pragma unroll
            for (int r = 0; r < kSpan; ++r) {
                if (w0 + r >= W) break;
                int* p = dst + (w0 + r) * 32 + lane;
                int v = cnt[r / kTile][r % kTile];
                if (!first) v += *p;  // uniform
                *p = v;
            }
        }
        if (npend < 32) break;
    }
}

// out[t] = the sum of cnt[perm ? perm[j] : j] over [min(s, e), max(s, e))
// (negated when e < s) for the targets t = t0, t0 + step, ... below T,
// U a pass: their ranges, then each range's first count, load together
// (a range is mostly one bin).
template <int U>
__device__ __forceinline__ void segment_sums(
    const int* __restrict__ cnt, const int* __restrict__ perm,
    const int* __restrict__ starts, const int* __restrict__ ends, int T,
    int t0, int step, int* __restrict__ out) {
    for (; t0 < T; t0 += U * step) {
        int lo[U], hi[U], acc[U];
        bool neg[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = t0 + u * step;
            const int s = t < T ? starts[t] : 0, e = t < T ? ends[t] : 0;
            lo[u] = min(s, e);
            hi[u] = max(s, e);
            neg[u] = e < s;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            acc[u] = lo[u] < hi[u] ? cnt[perm ? perm[lo[u]] : lo[u]] : 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            for (int j = lo[u] + 1; j < hi[u]; ++j)
                acc[u] += cnt[perm ? perm[j] : j];
            if (t0 + u * step < T)
                out[t0 + u * step] = neg[u] ? -acc[u] : acc[u];
        }
    }
}

// A warp for each (read, run of up to per spans).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bins_kernel(const unsigned* __restrict__ bits, long long W, bool vec,
            const int* __restrict__ rows, long long B, int M, int S,
            const unsigned char* __restrict__ mask, long long nspans,
            long long per, int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long runs = (nspans + per - 1) / per;
    const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    const long long b = g / runs;
    if (b >= B) return;  // the whole warp
    const long long sp0 = (g - b * runs) * per;
    count_spans(bits, W, vec, rows + b * M * S, M, S, mask + b * M, sp0, 1,
                min(sp0 + per, nspans), lane, out + b * W * 32);
}

// rpb reads a block, kWarps / rpb warps a read, each on every
// (kWarps / rpb)-th span; the read's counts in its slice of shared
// memory, then its threads one target each.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bins_target_kernel(const unsigned* __restrict__ bits, long long W, bool vec,
                   const int* __restrict__ rows, long long B, int M, int S,
                   const unsigned char* __restrict__ mask, long long nspans,
                   int rpb, const int* __restrict__ perm,
                   const int* __restrict__ starts,
                   const int* __restrict__ ends, int T,
                   int* __restrict__ out) {
    extern __shared__ int slice[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wpr = kWarps / rpb;
    const int q = warp % wpr;
    const long long b = (long long)blockIdx.x * rpb + warp / wpr;
    int* sc = slice + (long long)(warp / wpr) * W * 32;
    if (b < B)
        count_spans(bits, W, vec, rows + b * M * S, M, S, mask + b * M, q,
                    wpr, nspans, lane, sc);
    // the read's slice is whole: a named barrier a read (1 + its place in
    // the block; 0 is __syncthreads'), so reads do not wait for each other
    if (wpr == 1)  // block-uniform
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / wpr), "r"(32 * wpr)
                     : "memory");
    if (b >= B) return;
    segment_sums<kSharedTargets>(sc, perm, starts, ends, T, q * 32 + lane,
                                 wpr * 32, out + b * T);
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
    segment_sums<kScratchTargets>(cb + b * TB, perm, starts, ends, T,
                                  threadIdx.x, blockDim.x, out + b * T);
}

int launch_bins(const void* bits, long long W, const void* rows, long long B,
                int M, int S, const void* mask, void* out, cudaStream_t st) {
    const long long nspans = (W + kSpan - 1) / kSpan;
    // spans a warp: up to kMaxPer while the card keeps kWarpsPerSm warps
    // an SM to run
    long long per = B * nspans / ((long long)sm_count() * kWarpsPerSm);
    per = per < 1 ? 1 : per > kMaxPer ? kMaxPer : per;
    const long long warps = B * ((nspans + per - 1) / per);
    const long long blocks = (warps + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    bins_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const unsigned*)bits, W, rows_vectorizable<kTile>(bits, W),
        (const int*)rows, B, M, S, (const unsigned char*)mask, nspans, per,
        (int*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ganon_bins(const void* bits, long long R, long long W,
                          const void* rows, long long B, int M, int S,
                          const void* mask, void* out, void* stream) {
    (void)R;
    if (W <= 0 || S < 1 || S > kMaxS || M < 0)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    return launch_bins(bits, W, rows, B, M, S, mask, out,
                       (cudaStream_t)stream);
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

// scratch NULL: the fused route (a read's 128 W bytes of counts must fit a
// block's shared memory, else cudaErrorInvalidValue); otherwise bins into
// scratch [B, 32 W], then the segment pass.
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
    if (scratch) {
        const int err = launch_bins(bits, W, rows, B, M, S, mask, scratch, st);
        if (err) return err;
        segment_kernel<<<(unsigned)B, 256, 0, st>>>(
            (const int*)scratch, W * 32, (const int*)perm,
            (const int*)starts, (const int*)ends, T, (int*)out);
        return (int)cudaGetLastError();
    }
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const long long read_bytes = W * 32 * (long long)sizeof(int);
    if (read_bytes > optin) return (int)cudaErrorInvalidValue;
    const long long nspans = (W + kSpan - 1) / kSpan;
    int rpb = kWarps;  // reads a block
    while (rpb > 1 && rpb * read_bytes > kFusedBlockBytes) rpb >>= 1;
    const long long smem = rpb * read_bytes;
    if (smem > (48 << 10)) {
        e = cudaFuncSetAttribute(bins_target_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (B + rpb - 1) / rpb;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    bins_target_kernel<<<(unsigned)blocks, kThreads, (size_t)smem, st>>>(
        (const unsigned*)bits, W, rows_vectorizable<kTile>(bits, W),
        (const int*)rows, B, M, S, (const unsigned char*)mask, nspans, rpb,
        (const int*)perm, (const int*)starts, (const int*)ends, T,
        (int*)out);
    return (int)cudaGetLastError();
}
