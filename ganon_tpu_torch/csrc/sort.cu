// sort: the build's (file key, u64 value) entries in lexicographic order,
// plus the scan and the pack that feed it.
//
// Replaces the JAX device programs
//   ganon_tpu/ops/bigsort.py:31 sort_flat (K19, Leighton's columnsort of
//     (i32 key, u32 hi, u32 lo) tuples) as called by
//   ganon_tpu/index/device_build.py:137 close_sort (K10), whose flatten
//     and valid-slot mask (device_build.py:144-149) becomes `pack`.
//
// Semantics: `sort` orders entries by (key, value) with the value read as
// UNSIGNED 64-bit (lax.sort's u32 (hi, lo) order), stable. `pack` copies
// the first n[b] slots of every row b of an extract output [B, mc] into
// exact entry buffers of sum(n) slots, tagged with the row's file key.
// Entry counts are host values (the caller fetches each launch's total
// once), so every grid is sized by the real entries; they stay below
// 2^31, since positions, ranks and radix offsets are int32.
//
// What bounds it on the H100: bytes. Every radix pass reads and writes
// each entry once. The columnsort was an XLA compile-time workaround and
// has no counterpart. The earlier design here ran all eight value passes
// plus the key's whatever the data, five launches and two reads of the
// entries a pass, with uncoalesced scatters (9.084 ms at the 1.024 Gbp
// build's first pass-1 group, 18,570,459 entries, against torch.sort's
// 2.292; NVIDIA H100 80GB HBM3, 700.00 W).
//
// Design: a stable LSD radix sort of 8-bit digits, value digits least
// significant first and the key digits last, so the result is
// lexicographic, in the style of Onesweep (Adinets and Merrill, 2022):
// - `sort_hist`: one read of the entries counts every digit's histogram
//   (8 value digits, ceil(key_bits / 8) key digits) in shared memory; a
//   digit the whole warp shares (an OR-reduction of each lane's bits
//   against the first lane's tells) is one add. The blocks add their
//   counts into one table, and a small kernel scans each digit's: every
//   pass has its global digit offsets up front.
// - The caller reads the histograms and skips every digit that puts all
//   entries in one bucket: such a pass leaves a stable order unchanged
//   (k = 19 values lie below 2^38, so value digits 5-7 never run there).
//   With no pass left, `sort` copies the input.
// - `sort`: one kernel a remaining pass. A block takes its tile id from
//   an atomic counter, loads its tile (a warp's entries contiguous,
//   coalesced), ranks each entry among its warp's equal digits (eight
//   ballots, per-warp digit counters in shared memory), and publishes
//   its 256 digit counts as status words. Each thread, one digit, then
//   adds its predecessors' counts by a decoupled look-back, eight words
//   in flight at a time (a predecessor's inclusive prefix ends the
//   walk). The tile is staged in shared memory in digit order and
//   written out, so neighbouring threads write neighbouring slots of
//   each digit run.
// Sized for the H100's 132 SMs: 256 threads, 12 entries a thread, three
// blocks an SM (36 KB of staging and 11 KB of counters a block). The
// status words carry their pass in their high bits, so one clear a call
// serves every pass.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;

constexpr int kRadix = 256;
constexpr int kItems = 12;                  // entries a thread in a pass
constexpr int kTile = kThreads * kItems;    // a pass's tile
constexpr int kStageBytes = kTile * 12;     // the tile's keys and values
constexpr int kPassBlocks = 3;              // an SM (<= 85 registers)
constexpr int kLookback = 8;                // status words read at a time
constexpr int kMaxDigits = 12;              // 8 value + 4 key digits
constexpr int kHistThreads = 512;
constexpr int kHistUnroll = 4;
constexpr int kHistBlocks = 528;            // four an SM on 132 SMs
constexpr int kCounters = 16;               // status words of tile counters
// status word: pass (epoch) << 34 | flag << 32 | count
constexpr int kEpochShift = 34;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

// Exclusive scan of v over the block; *total gets the block's sum.
__device__ long long block_scan(long long v, long long* warp_sums,
                                long long* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        long long s = lane < kWarps ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        warp_sums[lane] = s;
    }
    __syncthreads();
    const long long before = warp ? warp_sums[warp - 1] : 0;
    *total = warp_sums[kWarps - 1];
    __syncthreads();
    return before + x - v;
}

__global__ void scan_reduce(const int* __restrict__ in, long long M,
                            long long* __restrict__ sums) {
    __shared__ long long ws[32];
    const long long t0 = (long long)blockIdx.x * kScanTile;
    long long s = 0;
    for (int r = 0; r < kScanItems; ++r) {
        const long long i = t0 + (long long)r * kThreads + threadIdx.x;
        if (i < M) s += in[i];
    }
    long long total;
    block_scan(s, ws, &total);
    if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: exclusive scan of the block sums in place, offset by *base;
// *total_out = *base + the sum (base and total_out may alias).
__global__ void scan_top(long long* __restrict__ sums, long long nb,
                         const long long* base, long long* total_out) {
    __shared__ long long ws[32];
    __shared__ long long carry;
    if (threadIdx.x == 0) carry = base ? *base : 0;
    __syncthreads();
    for (long long c0 = 0; c0 < nb; c0 += kThreads) {
        const long long i = c0 + threadIdx.x;
        const long long v = i < nb ? sums[i] : 0;
        long long total;
        const long long ex = block_scan(v, ws, &total);
        if (i < nb) sums[i] = carry + ex;
        __syncthreads();
        if (threadIdx.x == 0) carry += total;
        __syncthreads();
    }
    if (threadIdx.x == 0 && total_out) *total_out = carry;
}

// in and out may alias: each thread reads its entries before it writes
// them.
__global__ void scan_down(const int* in, int* out, long long M,
                          const long long* __restrict__ offs) {
    __shared__ long long ws[32];
    // each thread owns kScanItems consecutive entries
    const long long i0 = (long long)blockIdx.x * kScanTile
                         + (long long)threadIdx.x * kScanItems;
    int v[kScanItems];
    long long s = 0;
    for (int r = 0; r < kScanItems; ++r) {
        v[r] = i0 + r < M ? in[i0 + r] : 0;
        s += v[r];
    }
    long long total;
    long long run = offs[blockIdx.x] + block_scan(s, ws, &total);
    for (int r = 0; r < kScanItems; ++r) {
        if (i0 + r < M) out[i0 + r] = (int)run;
        run += v[r];
    }
}

// The [D, 256] digit histograms of the entries, added into counts (zeroed
// by the caller): each block counts its grid-stride share in shared
// memory, then adds its nonzero buckets.
__global__ void __launch_bounds__(kHistThreads)
digit_hist(const int* __restrict__ key,
           const unsigned long long* __restrict__ val, long long n, int D,
           unsigned* __restrict__ counts) {
    __shared__ unsigned h[kMaxDigits * kRadix];
    for (int j = threadIdx.x; j < D * kRadix; j += kHistThreads) h[j] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long step = (long long)gridDim.x * kHistThreads * kHistUnroll;
    for (long long base = (long long)blockIdx.x * kHistThreads * kHistUnroll;
         base < n; base += step) {
        int k[kHistUnroll];
        unsigned long long v[kHistUnroll];
#pragma unroll
        for (int r = 0; r < kHistUnroll; ++r) {
            const long long i =
                base + (long long)r * kHistThreads + threadIdx.x;
            k[r] = i < n ? key[i] : 0;
            v[r] = i < n ? val[i] : 0;
        }
#pragma unroll
        for (int r = 0; r < kHistUnroll; ++r) {
            const bool ok =
                base + (long long)r * kHistThreads + threadIdx.x < n;
            const unsigned live = __ballot_sync(0xffffffffu, ok);
            if (!live) continue;  // warp-uniform
            const int lead = __ffs(live) - 1;
            // the bits in which a live lane differs from the lead lane: a
            // digit with none (a constant digit, a run of one file's keys)
            // is one add for the warp, not 32 on one address
            const unsigned long long v0 = __shfl_sync(0xffffffffu, v[r], lead);
            const int k0 = __shfl_sync(0xffffffffu, k[r], lead);
            const unsigned long long dv = ok ? v[r] ^ v0 : 0;
            const unsigned dk = ok ? (unsigned)(k[r] ^ k0) : 0;
            const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)dv);
            const unsigned hi =
                __reduce_or_sync(0xffffffffu, (unsigned)(dv >> 32));
            const unsigned kd = __reduce_or_sync(0xffffffffu, dk);
            auto add = [&](int d, unsigned x, unsigned differ) {
                if (!differ) {
                    if (lane == lead)
                        atomicAdd(&h[d * kRadix + x], __popc(live));
                } else if (ok) {
                    atomicAdd(&h[d * kRadix + x], 1u);
                }
            };
#pragma unroll
            for (int d = 0; d < 8; ++d)
                add(d, (unsigned)(v[r] >> (8 * d)) & 255u,
                    ((d < 4 ? lo : hi) >> (8 * (d % 4))) & 255u);
            for (int d = 8; d < D; ++d)
                add(d, ((unsigned)k[r] >> (8 * (d - 8))) & 255u,
                    (kd >> (8 * (d - 8))) & 255u);
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < D * kRadix; j += kHistThreads)
        if (h[j]) atomicAdd(&counts[j], h[j]);
}

// <<<D, 256>>>: offs[d][b], the exclusive scan of counts[d] over the
// buckets b (digit d's first global slot).
__global__ void digit_offsets(const int* __restrict__ counts,
                              int* __restrict__ offs) {
    __shared__ long long ws[32];
    const int at = blockIdx.x * kRadix + threadIdx.x;
    long long total;
    offs[at] = (int)block_scan(counts[at], ws, &total);
}

// One pass of one digit over the tile the block draws: the digit at
// `shift` of the key (on_key) or of the value. digit_offs: [256] the
// digit's global first slots; status: [tiles, 256] words of this call
// (epoch = the pass's ordinal, from 1).
__global__ void __launch_bounds__(kThreads, kPassBlocks)
onesweep_pass(const int* __restrict__ kin,
              const unsigned long long* __restrict__ vin,
              int* __restrict__ kout, unsigned long long* __restrict__ vout,
              long long n, int on_key, int shift,
              const int* __restrict__ digit_offs,
              unsigned long long* status, unsigned* tile_counter,
              unsigned long long epoch) {
    constexpr int kWarpTile = 32 * kItems;  // a warp's contiguous entries
    extern __shared__ unsigned long long sval[];  // [kTile], then skey
    int* skey = reinterpret_cast<int*>(sval + kTile);
    __shared__ unsigned whist[kWarps][kRadix];
    __shared__ int tile_start[kRadix];
    __shared__ long long gbase[kRadix];
    __shared__ long long ws[32];
    __shared__ unsigned s_tile;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (t == 0) s_tile = atomicAdd(tile_counter, 1u);
    for (int j = t; j < kWarps * kRadix; j += kThreads) (&whist[0][0])[j] = 0;
    __syncthreads();
    const long long tile = s_tile;
    const long long t0 = tile * kTile;
    const int tile_n = (int)min((long long)kTile, n - t0);
    const int w0 = warp * kWarpTile;
    auto digit = [&](int key, unsigned long long val) -> unsigned {
        if (on_key) return ((unsigned)key >> shift) & 255u;
        return (unsigned)(val >> shift) & 255u;
    };

    // 1. load a warp's contiguous entries; rank each among its warp's
    // equal digits, in entry order (so the pass is stable): eight ballots
    // find a lane's peers
    int k[kItems];
    unsigned long long v[kItems];
    int rank[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const int i = w0 + j * 32 + lane;
        k[j] = i < tile_n ? kin[t0 + i] : 0;
        v[j] = i < tile_n ? vin[t0 + i] : 0;
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const bool ok = w0 + j * 32 + lane < tile_n;
        const unsigned d = digit(k[j], v[j]);
        unsigned peers = __ballot_sync(0xffffffffu, ok);
        if (!ok) peers = ~peers;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            const unsigned bit = __ballot_sync(0xffffffffu, (d >> b) & 1u);
            peers &= ((d >> b) & 1u) ? bit : ~bit;
        }
        const int leader = __ffs(peers) - 1;
        unsigned before = 0;
        if (ok && lane == leader)
            before = atomicAdd(&whist[warp][d], __popc(peers));
        before = __shfl_sync(0xffffffffu, before, leader);
        rank[j] = (int)before + __popc(peers & below);
    }
    __syncthreads();

    // 2. thread t is digit t: each warp's first rank of it, the tile's count
    unsigned cnt = 0;
    for (int w = 0; w < kWarps; ++w) {
        const unsigned c = whist[w][t];
        whist[w][t] = cnt;
        cnt += c;
    }

    // 3. publish the count, then look back over the tiles before this
    // one, kLookback words in flight at a time
    volatile unsigned long long* st = status;
    const unsigned long long tag = epoch << kEpochShift;
    long long excl = digit_offs[t];
    if (tile > 0) {
        st[tile * kRadix + t] = tag | kAggregate | cnt;
        excl = 0;
        for (long long p = tile - 1;; p -= kLookback) {
            unsigned long long s[kLookback];
#pragma unroll
            for (int w = 0; w < kLookback; ++w)
                s[w] = p - w >= 0 ? st[(p - w) * kRadix + t] : tag | kInclusive;
            bool done = false;
#pragma unroll
            for (int w = 0; w < kLookback && !done; ++w) {
                while ((s[w] >> kEpochShift) != epoch) {
                    __nanosleep(32);
                    s[w] = st[(p - w) * kRadix + t];
                }
                excl += (unsigned)s[w];
                done = (s[w] & kInclusive) != 0;
            }
            if (done) break;
        }
    }
    st[tile * kRadix + t] = tag | kInclusive | (unsigned long long)(excl + cnt);
    gbase[t] = excl;
    long long total;
    tile_start[t] = (int)block_scan(cnt, ws, &total);
    __syncthreads();

    // 4. stage the tile in digit order
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (w0 + j * 32 + lane < tile_n) {
            const unsigned d = digit(k[j], v[j]);
            const int at = tile_start[d] + (int)whist[warp][d] + rank[j];
            skey[at] = k[j];
            sval[at] = v[j];
        }
    }
    __syncthreads();

    // 5. write it out: neighbouring threads, neighbouring slots of a run
    for (int i = t; i < tile_n; i += kThreads) {
        const int kk = skey[i];
        const unsigned long long vv = sval[i];
        const unsigned d = digit(kk, vv);
        const long long pos = gbase[d] + (i - tile_start[d]);
        kout[pos] = kk;
        vout[pos] = vv;
    }
}

void launch_pass(const int* kin, const unsigned long long* vin, int* kout,
                 unsigned long long* vout, long long n, int on_key, int shift,
                 const int* offs, unsigned long long* words,
                 unsigned* counter, int epoch, cudaStream_t s) {
    onesweep_pass<<<(unsigned)((n + kTile - 1) / kTile), kThreads,
                    kStageBytes, s>>>(kin, vin, kout, vout, n, on_key, shift,
                                      offs, words, counter,
                                      (unsigned long long)epoch);
}

// One block per extract row: its first n[b] slots go to offs[b]..
// (slots at or past N, the buffers' size, are dropped).
__global__ void pack_kernel(const long long* __restrict__ hashes, int mc,
                            const int* __restrict__ n,
                            const int* __restrict__ keys,
                            const int* __restrict__ offs,
                            int* __restrict__ out_key,
                            long long* __restrict__ out_val, long long N) {
    const long long b = blockIdx.x;
    const int cnt = min(n[b], mc);
    const long long o = offs[b];
    const int key = keys[b];
    for (int j = threadIdx.x; j < cnt && o + j < N; j += blockDim.x) {
        out_key[o + j] = key;
        out_val[o + j] = hashes[b * mc + j];
    }
}

}  // namespace

// Exclusive scan of int32 in[M] into out[M] (out[i] = *base + sum of
// in[:i]; base may be NULL for 0), *total = *base + sum(in) when total is
// not NULL (base and total may alias). sums: int64 scratch of
// ceil(M / 2048) entries. Shared by pack and dedup.
extern "C" int ganon_scan(const void* in, void* out, long long M, void* sums,
                          const void* base, void* total, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long nb = (M + kScanTile - 1) / kScanTile;
    if (nb > 0) {
        scan_reduce<<<(unsigned)nb, kThreads, 0, s>>>((const int*)in, M,
                                                      (long long*)sums);
    }
    scan_top<<<1, kThreads, 0, s>>>((long long*)sums, nb,
                                    (const long long*)base, (long long*)total);
    if (nb > 0) {
        scan_down<<<(unsigned)nb, kThreads, 0, s>>>(
            (const int*)in, (int*)out, M, (const long long*)sums);
    }
    return (int)cudaGetLastError();
}

// Copy the valid slots of an extract output into entry buffers of N =
// sum(min(n[b], mc)) slots. offs: int32 [B] scratch; sums: int64
// [ceil(B / 2048)] scratch.
extern "C" int ganon_pack(const void* hashes, long long B, int mc,
                          const void* n, const void* keys, void* offs,
                          void* sums, void* out_key, void* out_val,
                          long long N, void* stream) {
    if (B <= 0 || N <= 0) return (int)cudaGetLastError();
    int err = ganon_scan(n, offs, B, sums, nullptr, nullptr, stream);
    if (err) return err;
    pack_kernel<<<(unsigned)B, 128, 0, (cudaStream_t)stream>>>(
        (const long long*)hashes, mc, (const int*)n, (const int*)keys,
        (const int*)offs, (int*)out_key, (long long*)out_val, N);
    return (int)cudaGetLastError();
}

// The sort's first step: the D digit histograms of the N entries (D = 8 +
// ceil(key_bits / 8), at most 12) into hist int32 [2, D, 256]: hist[0]
// the counts, hist[1] their exclusive scans per digit.
extern "C" int ganon_sort_hist(const void* key, const void* val, long long N,
                               int D, void* hist, void* stream) {
    if (D < 8 || D > kMaxDigits || N < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long per = (long long)kHistThreads * kHistUnroll;
    long long blocks = (N + per - 1) / per;
    if (blocks > kHistBlocks) blocks = kHistBlocks;
    cudaMemsetAsync(hist, 0, (size_t)D * kRadix * 4, s);
    digit_hist<<<(unsigned)blocks, kHistThreads, 0, s>>>(
        (const int*)key, (const unsigned long long*)val, N, D,
        (unsigned*)hist);
    digit_offsets<<<D, kRadix, 0, s>>>((const int*)hist,
                                       (int*)hist + D * kRadix);
    return (int)cudaGetLastError();
}

// The passes of the digits set in `digits` (bit d: digit d of
// ganon_sort_hist's numbering), lowest first; offs: int32 [D, 256] the
// digits' first slots (hist[1]). key, val are not modified. The first
// pass reads (key, val) and writes A, later passes alternate A and B, so
// the result is in A after an odd pass count, else in B; with no pass, A
// gets a copy. status: int64 [ceil(N / 3072) * 256 + 16] scratch,
// cleared here.
extern "C" int ganon_sort(const void* key, const void* val, long long N,
                          int digits, const void* offs, void* key_a,
                          void* val_a, void* key_b, void* val_b, void* status,
                          void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (N < 1 || digits < 0 || digits >= (1 << kMaxDigits))
        return (int)cudaErrorInvalidValue;
    if (digits == 0) {
        cudaMemcpyAsync(key_a, key, N * 4, cudaMemcpyDeviceToDevice, s);
        cudaMemcpyAsync(val_a, val, N * 8, cudaMemcpyDeviceToDevice, s);
        return (int)cudaGetLastError();
    }
    cudaFuncSetAttribute(onesweep_pass,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kStageBytes);
    const long long tiles = (N + kTile - 1) / kTile;
    unsigned long long* words = (unsigned long long*)status;
    cudaMemsetAsync(words, 0, (tiles * kRadix + kCounters) * 8, s);
    unsigned* counters = (unsigned*)(words + tiles * kRadix);
    const int* kin = (const int*)key;
    const unsigned long long* vin = (const unsigned long long*)val;
    for (int d = 0, p = 0; d < kMaxDigits; ++d) {
        if (!(digits >> d & 1)) continue;
        int* kout = (int*)(p % 2 == 0 ? key_a : key_b);
        unsigned long long* vout =
            (unsigned long long*)(p % 2 == 0 ? val_a : val_b);
        launch_pass(kin, vin, kout, vout, N, d >= 8, 8 * (d % 8),
                    (const int*)offs + d * kRadix, words, counters + p, p + 1,
                    s);
        kin = kout;
        vin = vout;
        ++p;
    }
    return (int)cudaGetLastError();
}
