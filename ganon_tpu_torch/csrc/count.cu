// count: compacted minimizers -> per-target hit counts, clamped.
//
// Replaces the JAX device programs
//   ganon_tpu/ops/ibf_query.py:65 ibf_row_indices (+ :52 _mulhi64)  (K4),
//   ganon_tpu/ops/ibf_query.py:320 bulk_target_counts_u8, :277 _u32,
//     :355 _segment_matmul (via :397 bulk_target_counts_packed), and the
//     clamp of ganon_tpu/classify/device.py:120 classify_counts_fused /
//     :87 filter_counts_u8                                            (K5).
//
// counts[b, t] = min(n[b], sum over the read's first min(n[b], M) hashes
// of popcount(AND_s tbl[row_s(hash), bytes of target t])).
//
// What bounds it on the H100: device memory. Each valid hash gathers h
// table rows of W8 bytes from a table far larger than L2 (a 1024-target
// filter packs to 1 KB rows), so a batch moves about
// B x hashes x h x W8 bytes; arithmetic per byte is an AND and a popcount.
// The gathers are random, so what the card reaches is set by how many of
// them are in flight: the layouts below keep every thread gathering.
//
// Design: one block per read. The block hashes its minimizers into
// shared memory (u64 multiply and __umul64hi on the card, no limbs), a
// chunk of 128 at a time, then takes one of three layouts by the row's
// width W32 (u32 words), and sums the per-byte counts over each target's
// byte range. Targets are contiguous byte ranges in ascending order. The
// block owns its output row, so no atomics reach device memory; the
// segment sum the TPU ran as a one-hot matmul is a short loop here.
// Shared memory is dynamic and sized to the row: the hashed rows (128 x h
// u64) and the per-byte counts (4 ints a word, at most a tile's).
//
// - Narrow rows (W32 < 256: a mesh shard of 64 words, a forest or raptor
//   sub of 16-17): the 256 threads split into G = 256 / W32p groups (W32p
//   is W32 rounded up to a power of two); group g gathers word j of hashes
//   g, g + G, ... and each thread keeps its word's four byte counters in
//   registers. The groups of one warp fold by shuffles, then one shared
//   atomic add a word and byte gives the per-byte counts. A row of 16
//   words so keeps 16 hashes' gathers in flight a block, where one thread
//   a word left 240 of 256 threads idle. Toward 256 words it degenerates
//   to one group walking the hashes a row at a time, with the block's
//   hashing, barriers and stores between reads (31% of the bound at the
//   flat arc_cg_ibf table's 160 words).
// - The ring route (rows of 96 to 512 words in whole 16-byte words,
//   outside column-max mode; ops/ibf_query.py count_route picks it: the
//   flat arc_cg_ibf table's 640 one-byte targets at 160 words, the
//   1024-target table at 256): a
//   thread owns one 16-byte word of the row, so a group of W32 / 4
//   threads covers it, and each of the block's groups issues kRingDepth
//   rows' 16-byte loads before their first use (three groups of 40
//   threads at 160 words: 24 rows in flight a block, 8 blocks an SM).
//   The rows' bits are counted a byte at a time by SIMD popcounts in
//   packed bytes, flushed to shared memory before a byte can pass 255, so
//   a thread holds four words of counters, not 16. The band's edges and
//   the block's shape come from scripts/torch_count_select_ab.py's
//   count_arc widths (PERF.md section 6): at 160 words, h 1, 0.089 ms of
//   card against the narrow route's 0.203; faster than the narrow route
//   and the tile walk at every width from 64 to 512 words (NVIDIA H100
//   80GB HBM3, 700.00 W). Like the narrow route it stores every target of
//   its row, so the flat caller allocates without a fill
//   (count_writes_every_cell).
// - Other rows of 256 words or more (the wide filters, rows off the
//   16-byte grid): the row in tiles of 2048 u32 words; consecutive threads read
//   consecutive words of the same row, so every gather is a coalesced row
//   segment, and each thread owns its words' byte counters. After each
//   tile the threads sum the byte ranges of the targets that intersect it
//   (found by binary search). At most one target is open at a tile
//   boundary (a large user bin split over many technical bins can span
//   several tiles): its partial sum carries to the next tile in shared
//   memory (two slots, read one and write the other, so the reader and the
//   writer of one tile never race), and a target's clamped sum is written
//   once, at its last tile.
// The earlier kernel took the tile walk at every width with a fixed 32 KB
// count array: 6 blocks an SM, and at 16 words a row 15 of 16 warps idle
// through the gathers (a forest sub 21x its bound, NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Forest mode (K11, ganon_tpu/classify/device.py:432
// classify_batch_packed_forest): the output row is ``counts + b * ldc +
// col0``, so each sub-IBF of a forest counts straight into its own column
// range of one shared [B, ldc] matrix (a flat filter passes ldc = T,
// col0 = 0).
//
// Column-max mode (K12, ganon_tpu/classify/device.py:488
// classify_batch_packed_raptor, and the exact path's
// DeviceRaptorHIBF.counts at :1037): a raptor user bin can sit in several
// sub-IBFs, so sub target t writes max(old, clamped sum) into column
// cols[t] of the [B, ldc] matrix (a target in no sub reads 0). The clamp
// commutes with the max, so this equals JAX's max of unclamped sums
// followed by one clamp. A sub's cols are distinct (sorted file
// positions). ganon_count_raptor counts every sub of an archive in one
// launch: the block writes its row's zeros, then counts the subs in turn
// (each from the sub-descriptor array, rehashing the read's minimizers
// with that sub's bin size), max-merging each; a barrier between subs
// keeps the writers of a cell apart, so no atomics and no zeroed matrix.
// ganon_count with cols counts one sub into a matrix the caller zeroed
// (the mesh path, and single subs), one launch a sub in order on one
// stream.
//
// Shard mode (K17, the column-sharded table of ganon_tpu/parallel/mesh.py
// :79 ShardedClassifier.counts and ganon_tpu/classify/device.py:749-768):
// the table is one shard's column slice and the byte ranges its targets'
// ranges clipped to the slice and rebased; clamp = 0 writes the unclamped
// partial sums, which combine (shard.cu) adds over the shards before the
// clamp. JAX all-gathers per-byte counts [B, W8] before the segment sum;
// the per-target partials [B, T_shard] are the same function with less to
// move.
#include <cuda_runtime.h>

#include <cstdint>

#include "ibf_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 2048;  // 8 KB of table bytes per tile
constexpr int kHashChunk = 128;   // hashes whose rows sit in shared memory
constexpr int kMaxH = 5;

// One table in the query layout: a flat filter, a forest or raptor sub,
// a column shard. Every field takes 8 bytes, so a row of the int64
// sub-descriptor array (ops/ibf_query.py sub_descriptors) is one Table.
struct Table {
    const unsigned* tbl;           // [R, W32]
    long long W32;
    const int* byte_starts;        // [T]
    const int* byte_ends;          // [T]
    long long T;
    unsigned long long bin_size;
    long long h;
    long long shift;
    const int* cols;               // column-max mode: [T] columns, else NULL
};
static_assert(sizeof(Table) == 9 * 8, "a descriptor row is 9 int64 words");

// Dynamic shared memory of a block: the hashed rows, then the per-byte
// counts of a tile (narrow rows: of the whole row).
__host__ __device__ inline long long smem_bytes(long long h, long long W32) {
    const long long tile = W32 < kTileWords ? W32 : kTileWords;
    return 8ll * kHashChunk * h + 16ll * tile;
}

struct Block {
    unsigned long long* rows;  // [kHashChunk * h]
    int* cnt;                  // [4 * tile words]
    int* t_first;
    int* carry;                // [2]: the open target's sum, by tile parity
};

__device__ __forceinline__ void hash_chunk(const Table& tb,
                                           const long long* hrow, int m0,
                                           int mn, unsigned long long* rows) {
    const int h = (int)tb.h;
    for (int q = threadIdx.x; q < mn * h; q += kThreads) {
        const int m = q / h, s = q - m * h;
        rows[q] = ganon_ibf_row((unsigned long long)hrow[m0 + m], s,
                                tb.bin_size, (int)tb.shift);
    }
}

__device__ __forceinline__ void store(const Table& tb, int* orow,
                                      long long col0, int t, int acc, int n,
                                      int clamp) {
    const int v = clamp ? min(acc, n) : acc;
    if (tb.cols) {
        int* o = orow + tb.cols[t];
        *o = max(*o, v);
    } else {
        orow[col0 + t] = v;
    }
}

// W32 < kThreads: groups of W32p threads, one hash a group at a time.
__device__ void count_narrow(const Table& tb, const long long* hrow,
                             int nvalid, int n, int* orow, long long col0,
                             int clamp, const Block& sm) {
    const int W32 = (int)tb.W32, h = (int)tb.h, T = (int)tb.T;
    int lw = 0;
    while ((1 << lw) < W32) ++lw;
    const int j = threadIdx.x & ((1 << lw) - 1);  // the thread's word
    const int g = threadIdx.x >> lw;              // its group
    const int G = kThreads >> lw;
    for (int x = threadIdx.x; x < 4 * W32; x += kThreads) sm.cnt[x] = 0;
    int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    const unsigned* col = tb.tbl + j;
    for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
        const int mn = min(kHashChunk, nvalid - m0);
        __syncthreads();  // readers of the previous chunk's rows are done
        hash_chunk(tb, hrow, m0, mn, sm.rows);
        __syncthreads();
        if (j < W32) {
#pragma unroll 4
            for (int m = g; m < mn; m += G) {
                const unsigned long long* r = sm.rows + m * h;
                unsigned v = __ldg(col + (long long)r[0] * W32);
                for (int s = 1; s < h; ++s)
                    v &= __ldg(col + (long long)r[s] * W32);
                c0 += __popc(v & 0x000000FFu);
                c1 += __popc(v & 0x0000FF00u);
                c2 += __popc(v & 0x00FF0000u);
                c3 += __popc(v & 0xFF000000u);
            }
        }
    }
    // the groups of one warp share their words (W32p < 32): fold them
    for (int o = 1 << lw; o < 32; o <<= 1) {
        c0 += __shfl_xor_sync(0xFFFFFFFFu, c0, o);
        c1 += __shfl_xor_sync(0xFFFFFFFFu, c1, o);
        c2 += __shfl_xor_sync(0xFFFFFFFFu, c2, o);
        c3 += __shfl_xor_sync(0xFFFFFFFFu, c3, o);
    }
    __syncthreads();  // cnt is zero
    if (j < W32 && (lw >= 5 || (threadIdx.x & 31) < (1 << lw))) {
        atomicAdd(sm.cnt + 4 * j, c0);
        atomicAdd(sm.cnt + 4 * j + 1, c1);
        atomicAdd(sm.cnt + 4 * j + 2, c2);
        atomicAdd(sm.cnt + 4 * j + 3, c3);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += kThreads) {
        int acc = 0;
        for (int x = tb.byte_starts[t], e = tb.byte_ends[t]; x < e; ++x)
            acc += sm.cnt[x];
        store(tb, orow, col0, t, acc, n, clamp);
    }
    __syncthreads();  // before the shared memory is used again
}

// W32 >= kThreads: the row in tiles of kTileWords words.
__device__ void count_tiles(const Table& tb, const long long* hrow,
                            int nvalid, int n, int* orow, long long col0,
                            int clamp, const Block& sm) {
    const long long W32 = tb.W32;
    const int h = (int)tb.h, T = (int)tb.T;
    int tile = 0;
    for (long long w0 = 0; w0 < W32; w0 += kTileWords, ++tile) {
        const int tw = (int)min((long long)kTileWords, W32 - w0);
        for (int j = threadIdx.x; j < tw * 4; j += kThreads) sm.cnt[j] = 0;
        for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
            const int mn = min(kHashChunk, nvalid - m0);
            __syncthreads();  // readers of the previous chunk's rows are done
            hash_chunk(tb, hrow, m0, mn, sm.rows);
            __syncthreads();
            // each thread owns its words' four byte counters: no races
            for (int j = threadIdx.x; j < tw; j += kThreads) {
                int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
#pragma unroll 4
                for (int m = 0; m < mn; ++m) {
                    const unsigned long long* r = sm.rows + m * h;
                    unsigned v = tb.tbl[(long long)r[0] * W32 + w0 + j];
                    for (int s = 1; s < h; ++s)
                        v &= tb.tbl[(long long)r[s] * W32 + w0 + j];
                    c0 += __popc(v & 0x000000FFu);
                    c1 += __popc(v & 0x0000FF00u);
                    c2 += __popc(v & 0x00FF0000u);
                    c3 += __popc(v & 0xFF000000u);
                }
                sm.cnt[4 * j] += c0;
                sm.cnt[4 * j + 1] += c1;
                sm.cnt[4 * j + 2] += c2;
                sm.cnt[4 * j + 3] += c3;
            }
        }
        const long long lo = w0 * 4, hi = lo + (long long)tw * 4;
        if (threadIdx.x == 0) {  // first target whose range ends past lo
            int a = 0, z = T;
            while (a < z) {
                const int mid = (a + z) >> 1;
                if (tb.byte_ends[mid] > lo) z = mid; else a = mid + 1;
            }
            *sm.t_first = a;
        }
        __syncthreads();
        const int cin = tile & 1;
        for (int t = *sm.t_first + threadIdx.x; t < T; t += kThreads) {
            const long long s0 = tb.byte_starts[t], e0 = tb.byte_ends[t];
            if (s0 >= hi) break;  // ranges ascend: no later target intersects
            const long long x0 = s0 > lo ? s0 : lo;
            const long long x1 = e0 < hi ? e0 : hi;
            int acc = 0;
            for (long long x = x0; x < x1; ++x) acc += sm.cnt[x - lo];
            if (s0 < lo) acc += sm.carry[cin];  // opened in an earlier tile
            if (e0 > hi) {                      // still open: carry it on
                sm.carry[cin ^ 1] = acc;
                continue;
            }
            store(tb, orow, col0, t, acc, n, clamp);
        }
        __syncthreads();  // before the next tile clears cnt and reads carry
    }
}

__device__ __forceinline__ void count_read(const Table& tb,
                                           const long long* hrow, int nvalid,
                                           int n, int* orow, long long col0,
                                           int clamp, const Block& sm) {
    if (tb.W32 < kThreads)
        count_narrow(tb, hrow, nvalid, n, orow, col0, clamp, sm);
    else
        count_tiles(tb, hrow, nvalid, n, orow, col0, clamp, sm);
}

__device__ __forceinline__ Block block_smem(unsigned long long* smem,
                                            long long h, int* t_first,
                                            int* carry) {
    return Block{smem, (int*)(smem + kHashChunk * h), t_first, carry};
}

// MinBlocks 8 (narrow rows) holds the registers to 32 a thread, so 8
// blocks fit an SM: the narrow layout's gathers gain more from the warps
// in flight than they lose to a few spilled registers, the tile walk the
// other way, which takes 6 (40 registers; left free, ptxas gave it 80 and
// 3 blocks an SM). scripts/torch_count_select_ab.py on an NVIDIA H100
// 80GB HBM3 at 700.00 W: a forest sub 0.061 against 0.073 ms on the card
// at 8 and unbounded, the flat table 0.566 against 0.389 at 8 and 6.
template <int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
count_kernel(Table tb, const long long* __restrict__ hashes, int M,
             const int* __restrict__ n_hashes, int* __restrict__ counts,
             long long ldc, long long col0, int clamp) {
    extern __shared__ unsigned long long smem[];
    __shared__ int t_first, carry[2];
    const long long b = blockIdx.x;
    const int n = n_hashes[b];
    count_read(tb, hashes + b * M, min(n, M), n, counts + b * ldc, col0,
               clamp, block_smem(smem, tb.h, &t_first, carry));
}

// Every sub of a raptor archive, max-merged into the block's own row.
template <int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
count_raptor_kernel(const Table* __restrict__ subs, int S, long long hmax,
                    const long long* __restrict__ hashes, int M,
                    const int* __restrict__ n_hashes,
                    int* __restrict__ counts, long long ldc) {
    extern __shared__ unsigned long long smem[];
    __shared__ int t_first, carry[2];
    const long long b = blockIdx.x;
    const int n = n_hashes[b];
    int* orow = counts + b * ldc;
    for (long long t = threadIdx.x; t < ldc; t += kThreads) orow[t] = 0;
    __syncthreads();
    const Block sm = block_smem(smem, hmax, &t_first, carry);
    for (int s = 0; s < S; ++s) {
        const Table tb = subs[s];
        count_read(tb, hashes + b * M, min(n, M), n, orow, 0, 1, sm);
    }
}

// The ring route: groups of W32 / 4 threads, one 16-byte word a thread,
// each group kRingDepth rows in flight. Dynamic shared memory as
// smem_bytes: the hashed rows, then the per-byte counts with byte x of
// 16-byte word j at x * Q + j (a warp's flushes fall on distinct banks).
constexpr int kRingThreads = 128;
constexpr int kRingDepth = 8;
constexpr int kRingMinBlocks = 8;
constexpr int kRingRows = 31;  // rows a packed byte sum holds (31 x 8 bits)

// the popcount of each byte of v, in that byte
__device__ __forceinline__ unsigned byte_pop(unsigned v) {
    v -= (v >> 1) & 0x55555555u;
    v = (v & 0x33333333u) + ((v >> 2) & 0x33333333u);
    return (v + (v >> 4)) & 0x0F0F0F0Fu;
}

__device__ __forceinline__ void and4(uint4& v, const uint4 w) {
    v.x &= w.x;
    v.y &= w.y;
    v.z &= w.z;
    v.w &= w.w;
}

__global__ void __launch_bounds__(kRingThreads, kRingMinBlocks)
count_kernel_ring(Table tb, const long long* __restrict__ hashes, int M,
                  const int* __restrict__ n_hashes, int* __restrict__ counts,
                  long long ldc, long long col0, int clamp) {
    extern __shared__ unsigned long long smem[];
    const int h = (int)tb.h, T = (int)tb.T, Q = (int)(tb.W32 >> 2);
    const int G = kRingThreads / Q;
    const int g = threadIdx.x / Q, j = threadIdx.x - g * Q;
    unsigned long long* rows = smem;
    int* cnt = (int*)(smem + kHashChunk * h);
    const long long b = blockIdx.x;
    const int n = n_hashes[b], nvalid = min(n, M);
    const long long* hrow = hashes + b * M;
    for (int x = threadIdx.x; x < 16 * Q; x += kRingThreads) cnt[x] = 0;
    const uint4* col = reinterpret_cast<const uint4*>(tb.tbl) + j;
    for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
        const int mn = min(kHashChunk, nvalid - m0);
        __syncthreads();  // readers of the previous chunk's rows are done
        for (int q = threadIdx.x; q < mn * h; q += kRingThreads) {
            const int m = q / h, s = q - m * h;
            rows[q] = ganon_ibf_row((unsigned long long)hrow[m0 + m], s,
                                    tb.bin_size, (int)tb.shift);
        }
        __syncthreads();
        if (g >= G) continue;
        // the group's hashes g, g + G, ...: kRingRows of them a flush
        for (int m1 = g; m1 < mn; m1 += kRingRows * G) {
            const int me = min(mn, m1 + kRingRows * G);
            uint4 p = make_uint4(0, 0, 0, 0);
            for (int m = m1; m < me; m += kRingDepth * G) {
                uint4 v[kRingDepth];
#pragma unroll
                for (int u = 0; u < kRingDepth; ++u) {
                    const int mu = m + u * G;
                    v[u] = mu < me ? __ldg(col + (long long)rows[mu * h] * Q)
                                   : make_uint4(0, 0, 0, 0);
                }
                for (int s = 1; s < h; ++s) {
#pragma unroll
                    for (int u = 0; u < kRingDepth; ++u) {
                        const int mu = m + u * G;
                        if (mu < me)
                            and4(v[u], __ldg(col + (long long)rows[mu * h + s]
                                                       * Q));
                    }
                }
#pragma unroll
                for (int u = 0; u < kRingDepth; ++u) {
                    p.x += byte_pop(v[u].x);
                    p.y += byte_pop(v[u].y);
                    p.z += byte_pop(v[u].z);
                    p.w += byte_pop(v[u].w);
                }
            }
            const unsigned pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int y = 0; y < 4; ++y)
                    atomicAdd(cnt + (4 * k + y) * Q + j,
                              (int)((pw[k] >> (8 * y)) & 0xFFu));
        }
    }
    __syncthreads();
    int* orow = counts + b * ldc + col0;
    for (int t = threadIdx.x; t < T; t += kRingThreads) {
        int acc = 0;
        for (int x = tb.byte_starts[t], e = tb.byte_ends[t]; x < e; ++x)
            acc += cnt[(x & 15) * Q + (x >> 4)];
        orow[t] = clamp ? min(acc, n) : acc;
    }
}

}  // namespace

// ring: take the ring route (ops/ibf_query.py count_route chose it; here
// only checked: no column-max mode, 16-byte rows on a 16-byte grid, at
// least one group a block).
extern "C" int ganon_count(const void* tbl, long long R, long long W8,
                           const void* byte_starts, const void* byte_ends,
                           int T, const void* hashes, long long B, int M,
                           const void* n_hashes, unsigned long long bin_size,
                           int h, int shift, void* counts, long long ldc,
                           int col0, const void* cols, int clamp, int ring,
                           void* stream) {
    (void)R;
    if (h < 1 || h > kMaxH || W8 % 4 || col0 < 0
        || (!cols && col0 + (long long)T > ldc) || (cols && col0 != 0)
        || (cols && !clamp)
        || (ring && (cols || W8 % 16 || W8 / 16 > kRingThreads
                     || (unsigned long long)tbl % 16)))
        return (int)cudaErrorInvalidValue;
    const Table tb{(const unsigned*)tbl, W8 / 4, (const int*)byte_starts,
                   (const int*)byte_ends, T, bin_size, h, shift,
                   (const int*)cols};
    auto kernel = tb.W32 < kThreads ? count_kernel<8> : count_kernel<6>;
    if (ring)
        count_kernel_ring<<<(unsigned)B, kRingThreads,
                            (size_t)smem_bytes(h, W8 / 4),
                            (cudaStream_t)stream>>>(
            tb, (const long long*)hashes, M, (const int*)n_hashes,
            (int*)counts, ldc, col0, clamp);
    else
        kernel<<<(unsigned)B, kThreads, (size_t)smem_bytes(h, W8 / 4),
                 (cudaStream_t)stream>>>(
            tb, (const long long*)hashes, M, (const int*)n_hashes,
            (int*)counts, ldc, col0, clamp);
    return (int)cudaGetLastError();
}

// subs: int64 [S, 9] sub descriptors on the card (struct Table); hmax and
// wmax their largest h and W32 (they size the shared memory); counts
// [B, T] int32, every cell written (zero where no sub counts it).
extern "C" int ganon_count_raptor(const void* subs, int S, int hmax,
                                  long long wmax, const void* hashes,
                                  long long B, int M, const void* n_hashes,
                                  void* counts, long long T, void* stream) {
    if (S < 1 || hmax < 1 || hmax > kMaxH || wmax < 1)
        return (int)cudaErrorInvalidValue;
    auto kernel = wmax < kThreads ? count_raptor_kernel<8>
                                  : count_raptor_kernel<6>;
    kernel<<<(unsigned)B, kThreads, (size_t)smem_bytes(hmax, wmax),
             (cudaStream_t)stream>>>(
        (const Table*)subs, S, hmax, (const long long*)hashes, M,
        (const int*)n_hashes, (int*)counts, T);
    return (int)cudaGetLastError();
}
