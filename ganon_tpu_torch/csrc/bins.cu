// bins, tsum (with its plan, tsum_plan), bins_target: the ops library's
// counts over the interleaved bit-matrix.
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
// ranges, then their first counts, at once.
//
// tsum cuts the targets into nt tiles of TT (the caller's
// ops.library.tsum_tiles: balanced, a multiple of 4, at most kSharedT, so
// a tile's sums fit 48 KB of shared memory) and gives each (read, tile) to
// a team of 1-8 warps (enough for one pass of kTsumLoads 16-byte loads a
// lane over the tile's expected bins: two warps a read at a 1024-bin row,
// four reads a block; 64 registers, 32 warps an SM). The team issues its
// first pass's loads of counts and ids, zeroes its sums meanwhile, meets
// at its own barrier, adds the nonzero counts of the tile's bins with
// shared atomics, meets again and stores the tile whole (zeros included;
// 16 bytes a store where T % 4 == 0): the output comes unfilled from the
// caller, every cell is written once by its team, and no global atomic
// is left. Past one tile a team reads only its tile's window of bins,
// [lo, hi) from the first to one past the last bin whose id falls in the
// tile, which tsum_plan computes on the card beforehand (a block a tile
// over the map, from L2; no host sync). For every map a ganon filter
// makes (ascending ids, the padding bins' T at the end) the windows are
// disjoint and each bin is read once; for any other map they may
// overlap, and a bin of another tile inside a window is skipped by the
// id check, so the sums stay exact and only the time grows. Rows off 16 bytes (TB % 4 != 0, or a view at an offset)
// take one int a load, kTsumScalar of them in flight.
#include <climits>

#include <cuda_runtime.h>

#include "sm_count.cuh"
#include "warp_bits.cuh"

namespace {

constexpr int kMaxS = 8;         // hash functions (rows per hash)
constexpr int kSharedT = 12288;  // targets a tsum tile, at most: 48 KB
constexpr int kTsumLoads = 4;    // 16-byte loads of counts a tsum lane
constexpr int kTsumScalar = 16;  // loads a lane where rows are not aligned
constexpr long long kMaxTsumBins = 1LL << 30;  // bins a tsum row
constexpr int kPlanThreads = 1024;  // a tsum_plan block (a tile)
constexpr int kWarps = 8;        // warps a block of each kernel here
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

// Syncs a team of wpt warps of a tsum block: its own named barrier (1 +
// team; 0 is __syncthreads'), so teams do not wait for each other.
__device__ __forceinline__ void team_sync(int wpt, int team) {
    if (wpt == 1)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" ::"r"(1 + team), "r"(32 * wpt)
                     : "memory");
}

// acc[t - t0] += v for a bin of target t in the tile [t0, t1) with a
// count (zeros and other tiles' bins are skipped).
__device__ __forceinline__ void tsum_add(int* acc, int t0, int t1, int t,
                                         int v) {
    if (v != 0 && t >= t0 && t < t1) atomicAdd(acc + (t - t0), v);
}

// Windows of the tsum tiles: win[k] = [lo, hi), the first and one past the
// last bin whose id lies in tile k ([k TT, min(T, (k + 1) TT))); [0, 0)
// for a tile with no bin. A block a tile, over the whole map (from L2).
__global__ void __launch_bounds__(kPlanThreads)
tsum_plan_kernel(const int* __restrict__ b2t, int TB, int T, int TT,
                 bool vec, int* __restrict__ win) {
    __shared__ int part[2][kPlanThreads / 32];
    const int k = blockIdx.x;
    const int t0 = k * TT, t1 = t0 + min(TT, T - t0);
    int lo = INT_MAX, hi = 0;
    if (vec) {
        const int4* m4 = reinterpret_cast<const int4*>(b2t);
#pragma unroll 4
        for (int q = threadIdx.x; q < TB / 4; q += kPlanThreads) {
            const int4 m = __ldg(m4 + q);
            const int ids[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
                if (ids[r] >= t0 && ids[r] < t1) {
                    lo = min(lo, 4 * q + r);
                    hi = max(hi, 4 * q + r + 1);
                }
        }
    } else {
#pragma unroll 4
        for (int j = threadIdx.x; j < TB; j += kPlanThreads) {
            const int t = __ldg(b2t + j);
            if (t >= t0 && t < t1) {
                lo = min(lo, j);
                hi = max(hi, j + 1);
            }
        }
    }
    lo = __reduce_min_sync(kFullMask, lo);
    hi = __reduce_max_sync(kFullMask, hi);
    if ((threadIdx.x & 31) == 0) {
        part[0][threadIdx.x >> 5] = lo;
        part[1][threadIdx.x >> 5] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kPlanThreads / 32; ++w) {
            lo = min(lo, part[0][w]);
            hi = max(hi, part[1][w]);
        }
        win[2 * k] = hi ? lo : 0;
        win[2 * k + 1] = hi;
    }
}

// A team of wpt warps (kWarps / wpt teams a block) for each (read, tile of
// TT targets), read-major: the read's counts over the tile's bin window
// (win[k], or the whole row when win is NULL), kTsumLoads 16-byte loads of
// counts and of ids a lane in flight before its adds (the first pass's
// issued before the team zeroes its TT sums in shared memory), shared
// atomics for the nonzero counts of the tile's bins, then the tile stored
// whole, 16 bytes a store where the output rows allow (vec_out). `vec`:
// the rows and the map are 16-byte aligned (TB % 4 == 0); else one int a
// load, kTsumScalar of them in flight.
__global__ void __launch_bounds__(kThreads)
tsum_kernel(const int* __restrict__ bc, long long B, int TB,
            const int* __restrict__ b2t, int T, int TT, int nt,
            const int* __restrict__ win, int wpt, bool vec, bool vec_out,
            int* __restrict__ out) {
    extern __shared__ int4 tsum_sums[];
    const int team = (threadIdx.x >> 5) / wpt, nthr = 32 * wpt;
    const int tid = threadIdx.x - team * nthr;
    const long long u = (long long)blockIdx.x * (kWarps / wpt) + team;
    if (u >= B * nt) return;  // the whole team
    const long long b = u / nt;
    const int k = (int)(u - b * nt);
    const int t0 = k * TT, tw = min(TT, T - t0), t1 = t0 + tw;
    const int lo = win ? win[2 * k] : 0, hi = win ? win[2 * k + 1] : TB;
    int4* acc4 = tsum_sums + (long long)team * (TT / 4);
    int* acc = reinterpret_cast<int*>(acc4);
    const int zero4 = (tw + 3) / 4;
    const int* row = bc + b * TB;
    if (vec) {
        const int4* r4 = reinterpret_cast<const int4*>(row);
        const int4* m4 = reinterpret_cast<const int4*>(b2t);
        // the quads over [lo, hi): their bins outside it hold other
        // tiles' ids
        const int q1 = (hi + 3) >> 2;
        bool first = true;
        for (int q0 = lo >> 2; first || q0 < q1; q0 += kTsumLoads * nthr) {
            int4 c[kTsumLoads], m[kTsumLoads];
#pragma unroll
            for (int i = 0; i < kTsumLoads; ++i) {
                const int q = q0 + i * nthr + tid;
                c[i] = q < q1 ? __ldg(r4 + q) : make_int4(0, 0, 0, 0);
                m[i] = q < q1 ? __ldg(m4 + q) : make_int4(-1, -1, -1, -1);
            }
            if (first) {
                for (int x = tid; x < zero4; x += nthr)
                    acc4[x] = make_int4(0, 0, 0, 0);
                team_sync(wpt, team);
                first = false;
            }
#pragma unroll
            for (int i = 0; i < kTsumLoads; ++i) {
                tsum_add(acc, t0, t1, m[i].x, c[i].x);
                tsum_add(acc, t0, t1, m[i].y, c[i].y);
                tsum_add(acc, t0, t1, m[i].z, c[i].z);
                tsum_add(acc, t0, t1, m[i].w, c[i].w);
            }
        }
    } else {
        bool first = true;
        for (int j0 = lo; first || j0 < hi; j0 += kTsumScalar * nthr) {
            int c[kTsumScalar], m[kTsumScalar];
#pragma unroll
            for (int i = 0; i < kTsumScalar; ++i) {
                const int j = j0 + i * nthr + tid;
                c[i] = j < hi ? __ldg(row + j) : 0;
                m[i] = j < hi ? __ldg(b2t + j) : -1;
            }
            if (first) {
                for (int x = tid; x < zero4; x += nthr)
                    acc4[x] = make_int4(0, 0, 0, 0);
                team_sync(wpt, team);
                first = false;
            }
#pragma unroll
            for (int i = 0; i < kTsumScalar; ++i)
                tsum_add(acc, t0, t1, m[i], c[i]);
        }
    }
    team_sync(wpt, team);
    int* orow = out + b * T + t0;
    if (vec_out) {
        int4* o4 = reinterpret_cast<int4*>(orow);
        for (int x = tid; x < tw / 4; x += nthr) o4[x] = acc4[x];
    } else {
        for (int x = tid; x < tw; x += nthr) orow[x] = acc[x];
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

// The tile width TT (a multiple of 4, at most kSharedT) is the caller's
// (ops.library.tsum_tiles); past one tile, win holds the plan's windows.
extern "C" int ganon_tsum_plan(const void* b2t, long long TB, int T, int TT,
                               void* win, void* stream) {
    if (T <= 0 || TB < 0 || TB > kMaxTsumBins || TT < 4 || TT > kSharedT
        || TT % 4)
        return (int)cudaErrorInvalidValue;
    const int nt = (int)(((long long)T + TT - 1) / TT);
    tsum_plan_kernel<<<(unsigned)nt, kPlanThreads, 0,
                       (cudaStream_t)stream>>>(
        (const int*)b2t, (int)TB, T, TT, rows_vectorizable<4>(b2t, TB),
        (int*)win);
    return (int)cudaGetLastError();
}

extern "C" int ganon_tsum(const void* bc, long long B, long long TB,
                          const void* b2t, int T, int TT, const void* win,
                          void* out, void* stream) {
    if (T <= 0 || TB < 0 || TB > kMaxTsumBins || TT < 4 || TT > kSharedT
        || TT % 4)
        return (int)cudaErrorInvalidValue;
    const long long nt = ((long long)T + TT - 1) / TT;
    if (nt > 1 && !win) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    // a team's warps: enough for a pass over its expected window (a tile's
    // share of the row, or the whole row) and for its TT sums
    long long ew = nt == 1 ? TB : (TB + nt - 1) / nt;
    if (ew < TT) ew = TT;
    int wpt = 1;
    while (wpt < kWarps && (long long)wpt * 32 * 4 * kTsumLoads < ew)
        wpt <<= 1;
    const int tpb = kWarps / wpt;
    const long long blocks = (B * nt + tpb - 1) / tpb;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    tsum_kernel<<<(unsigned)blocks, kThreads, (size_t)tpb * TT * sizeof(int),
                  (cudaStream_t)stream>>>(
        (const int*)bc, B, (int)TB, (const int*)b2t, T, TT, (int)nt,
        (const int*)win, wpt,
        rows_vectorizable<4>(bc, TB) && rows_vectorizable<4>(b2t, TB),
        rows_vectorizable<4>(out, T), (int*)out);
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
