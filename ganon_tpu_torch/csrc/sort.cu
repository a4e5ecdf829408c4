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
// each 12-byte entry once; eight value passes plus one or two key passes.
// The columnsort was an XLA compile-time workaround and has no counterpart.
//
// Design: a stable LSD radix sort, 8 bits a pass, least significant value
// digit first and the key digits last, so the result is lexicographic.
// Each pass is three steps: a per-block digit histogram into a digit-major
// [256, blocks] table, an exclusive scan of that table (the scan below),
// and a scatter in which each block ranks its tile in order, 256 entries
// a round: __match_any_sync groups a warp's equal digits, per-warp digit
// counts in shared memory order the warps, and the block's running digit
// offsets carry over rounds. The scan is a three-kernel reduce / top-level
// scan / down-sweep.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // rounds per radix tile
constexpr int kTile = kThreads * kItems;   // entries per radix block
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;

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

// in and out may alias (the sort scans its histogram table in place):
// each thread reads its entries before it writes them.
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

__device__ __forceinline__ unsigned digit_of(int key, long long val, int on_key,
                                             int shift) {
    return on_key ? ((unsigned)key >> shift) & 255u
                  : (unsigned)(((unsigned long long)val >> shift) & 255ull);
}

__global__ void radix_hist(const int* __restrict__ key,
                           const long long* __restrict__ val,
                           long long n, int on_key, int shift,
                           int* __restrict__ counts, long long nb) {
    __shared__ int h[256];
    h[threadIdx.x] = 0;
    __syncthreads();
    const long long t0 = (long long)blockIdx.x * kTile;
    for (int r = 0; r < kItems; ++r) {
        const long long i = t0 + (long long)r * kThreads + threadIdx.x;
        if (i < n) atomicAdd(&h[digit_of(key[i], val[i], on_key, shift)], 1);
    }
    __syncthreads();
    counts[(long long)threadIdx.x * nb + blockIdx.x] = h[threadIdx.x];
}

__global__ void radix_scatter(const int* __restrict__ kin,
                              const long long* __restrict__ vin,
                              int* __restrict__ kout,
                              long long* __restrict__ vout,
                              long long n, int on_key, int shift,
                              const int* __restrict__ offs, long long nb) {
    __shared__ int base[256];
    __shared__ int wcount[kWarps][257];  // digit 256: no entry
    const long long t0 = (long long)blockIdx.x * kTile;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    base[t] = offs[(long long)t * nb + blockIdx.x];
    for (int r = 0; r < kItems; ++r) {
        for (int j = t; j < kWarps * 257; j += kThreads) (&wcount[0][0])[j] = 0;
        __syncthreads();
        const long long i = t0 + (long long)r * kThreads + t;
        const bool ok = i < n;
        const int k = ok ? kin[i] : 0;
        const long long v = ok ? vin[i] : 0;
        const unsigned d = ok ? digit_of(k, v, on_key, shift) : 256u;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        if (lane == __ffs(peers) - 1) wcount[warp][d] = __popc(peers);
        __syncthreads();
        if (ok) {
            int pos = base[d] + __popc(peers & ((1u << lane) - 1u));
            for (int w = 0; w < warp; ++w) pos += wcount[w][d];
            kout[pos] = k;
            vout[pos] = v;
        }
        __syncthreads();
        int add = 0;
        for (int w = 0; w < kWarps; ++w) add += wcount[w][t];
        base[t] += add;
        __syncthreads();  // wcount is read above before the next round zeroes it
    }
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
// ceil(M / 2048) entries. Shared by pack, sort and dedup.
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

// Stable LSD radix sort of the N entries of (key, val) by (key, unsigned
// val): 8 value passes, then ceil(key_bits / 8) key passes. The first
// pass reads (key, val) and writes buffer A; later passes alternate A and
// B, so the result is in A after an odd pass count, else in B. key, val
// are not modified. counts: int32 [256 * ceil(N / 4096)]; sums: int64
// [ceil(256 * ceil(N / 4096) / 2048)].
extern "C" int ganon_sort(const void* key, const void* val, long long N,
                          int key_bits, void* key_a, void* val_a, void* key_b,
                          void* val_b, void* counts, void* sums,
                          void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long nb = (N + kTile - 1) / kTile;
    if (nb <= 0) return (int)cudaGetLastError();
    const int passes = 8 + (key_bits + 7) / 8;
    const int* kin = (const int*)key;
    const long long* vin = (const long long*)val;
    for (int p = 0; p < passes; ++p) {
        const int on_key = p >= 8;
        const int shift = on_key ? 8 * (p - 8) : 8 * p;
        int* kout = (int*)(p % 2 == 0 ? key_a : key_b);
        long long* vout = (long long*)(p % 2 == 0 ? val_a : val_b);
        radix_hist<<<(unsigned)nb, kThreads, 0, s>>>(
            kin, vin, N, on_key, shift, (int*)counts, nb);
        int err = ganon_scan(counts, counts, 256 * nb, sums, nullptr, nullptr,
                             stream);
        if (err) return err;
        radix_scatter<<<(unsigned)nb, kThreads, 0, s>>>(
            kin, vin, kout, vout, N, on_key, shift, (const int*)counts, nb);
        err = (int)cudaGetLastError();
        if (err) return err;
        kin = kout;
        vin = vout;
    }
    return (int)cudaGetLastError();
}
