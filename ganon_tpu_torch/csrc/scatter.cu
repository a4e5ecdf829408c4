// scatter: (minimizer, technical bin) pairs -> bits ORed into the IBF.
//
// Replaces the JAX device program ganon_tpu/index/ibf.py:231
// _scatter_chunk_jit.step (K9, driven by ibf.py:291 scatter_hashes_device):
// every pair sets bit (bin & 31) of word row_s * W + (bin >> 5) for each
// hash function s, with row_s from the shared IBF hash family.
//
// Ranked mode (K10: ganon_tpu/index/device_build.py:185 scatter_sorted with
// :237 _entry_coords, and close_sort's first-occurrence mask at :157-165):
// the build's sorted entries (file key, value). An entry is set when it is
// a first occurrence (it differs from its left neighbour and its key is
// below R, dedup.cu's flag); a first occurrence of file f with rank r
// among them (dedup.cu's rank) has index idx = r - key_start[f] +
// offset[f] in its target's file-concatenated order and lands in technical
// bin bin_base[f] + idx / max(nhb[f], 1) (the reference's index-range
// split, GanonBuild.cpp:619-653). params holds int32 [4, R]: bin_base,
// nhb, offset, key_start per file. The flags and ranks are computed here,
// in the same chained scan as dedup.cu's rank mode, so no [N] flag or
// rank array exists. The JAX u8 lane-major plane and its row-range chunks
// were TPU tiling workarounds.
//
// Span mode (K17: ganon_tpu/index/device_build.py:308-367
// make_scatter_mesh, whose shard bodies run :279 _scatter_span): bits is
// one shard's rows [row0, row0 + R_rows) of the row-major matrix; a bit
// of a row outside them is dropped, before them as well as past them (JAX
// clamps the negative offsets onto its drop sentinel at :288-289); the
// rest are rebased. The whole matrix is row0 = 0, R_rows = bin_size.
//
// What bounds it on the H100: memory requests. The pairs or entries are
// read once; each distinct word set costs a 32-byte sector read and
// written, in a matrix several times the 50 MB L2 (347 MB for 1024
// targets) at rows that are random, so the requests, not the bytes,
// decide. Atomics do not serve: the earlier design, one thread a pair and
// an atomicOr straight into the matrix, ran at ~14G ORs/s (0.339 ms for
// 4M pairs, K9; 1.402 ms for 18.6M entries ranked), and the same
// atomicOrs partitioned so that they hit L2 ran no faster (~16G/s), all
// on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md, section 6).
//
// Design: sort the bits by shared-memory tile, OR each tile in shared
// memory, and write each of its words once, without atomics in device
// memory. The caller names the word columns the bins lie in (a build
// group's or a flush's bins span a few of them); a tile is rpt rows by
// cw of those columns, at most 4096 tiles a call (the caller cuts the
// rows into windows past that). An item is one bit to set, a u32 (its
// word in its tile << 5 | bit). Two kernels a call:
//   stage  a block takes a tile of 4096 pairs or entries (dedup.cuh),
//          makes its items and sorts them by shared-memory tile in
//          shared memory (a shared atomicAdd a item gives its rank among
//          its tile's, a scan of the counts its tile's first slot), then
//          writes them in full lines to its own run of the items and
//          each tile's first slot in the run to loc. In ranked mode the
//          block runs dedup's chained scan first (its tile drawn in
//          order, its warps' runs, the look-back on the shared status
//          words, kernels.scan_status): flags, ranks and bins never leave
//          the block.
//   apply  a block a tile gathers the tile's items from every stage
//          block's run, ORs them into shared memory, and ORs the tile's
//          nonzero words into the matrix with a plain read and write:
//          each word once a call, whatever the number of ORs, and no two
//          blocks share one.
// The bits of the earlier calls and groups stay: the tiles are ORed in,
// never written over. Items outside the rows (span mode, a window) are
// dropped when they are made. The band is a hint, not a promise: an item
// outside its columns is ORed into the matrix with an atomicOr in stage
// (the earlier design's cost, for that bit only), so the bits never
// depend on it. The caller bounds a call's items (the
// scratch) and cuts larger inputs into calls; the ranked mode then
// carries the rank from call to call on the card. A first design counted
// the items in one pass, scanned the [tiles, blocks] counts and placed
// them in a second (two reads of the entries, every item stored alone):
// 1.02 ms on the card ranked; this one, 0.53.
//
// Pruned mode (K16: ganon_tpu/index/pruned.py:283 _pruned_scatter_jit
// .step, driven by :337 _device_scatter_table): a flush of the pruned
// forest's build sets both its tables in one launch. Its hashes come in
// runs, one a target: run r covers hashes [start[r], start[r + 1]) of
// group grp[r] at lane lane[r]. For each hash x of a run and hash
// function s, the fine table gets bit lane of row row_off[g] +
// ganon_ibf_row(x, s, bin_size[g]) (fine_h functions; a bin size per
// group), the coarse table bit g of row ganon_ibf_row(x, s,
// coarse_bin_size) (coarse_h functions). Rows are u32 words of the
// little-endian byte tables (row bytes padded to x4), so bit c of a row is
// bit c & 31 of word c >> 5.
//
// What bounds it on the H100: memory requests. A flush's 4M hashes are
// read (32 MB) and each distinct word set is read and written once: the
// fine rows of the ~24 groups a flush touches (~10 MB) and random rows of
// the 27.7 MB coarse table. The earlier design, two launches a flush
// (fine, then coarse), a thread a pair and an atomicOr a bit in device
// memory, read the hashes twice and per-pair group and lane arrays the
// host expanded and copied (32 of the fine call's 67 MB), and took 0.162
// ms on the card a flush (0.064 fine, 0.077 coarse; NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Design: one launch, two kinds of blocks, on tables staged by word
// column (the caller transposes them back once a build): word w of row r
// at w * R + r, so a flush's coarse bits, whose groups share one or two
// word columns, touch one 7 MB column of the coarse table rather than
// every 32-byte sector of it, and a slice's fine words are contiguous.
// A fine block owns a slice of one word column of one group's rows (at
// most SLICE_BYTES of pruned.py, 216 KB: a group's whole column at the
// build's shapes), zeroes it in shared memory, walks the runs of its
// group whose lanes lie in its column (the host hands the runs grouped by
// group and column, a CSR of run ids, so the stream need not be
// group-major: a warp a run, four hashes a lane in flight), ORs the bits
// that fall in its slice into shared memory with shared atomics, and ORs
// the slice's nonzero words into the table with plain reads and writes,
// eight in flight a thread: no other block writes those words, so no fine
// bit takes a device-memory atomic. A hash is read by the slices of its
// column, one at the build's shapes, more as a group's bin size passes
// 55,296 rows. The host's plan (pruned.py pruned_plan) gives a column no
// slice where it would need more than MAX_COLUMN_SLICES or holds more
// than 1 / COLUMN_SHARE of the flush (genome-sized targets, a small
// flush): its fine bits take an atomicOr in the coarse blocks, which
// read each hash once, since there one block reading a column alone
// took up to 29x the atomics' time. A coarse block reads a chunk of the
// hashes once (the run that holds its first hash by binary search, then
// the runs on) and sets their coarse bits, and those fine bits, with
// atomicOr, bound by the L2's atomic rate (77G a second, the coarse
// blocks alone); a flush with no slice takes no shared memory and up to
// four coarse blocks an SM. The plan lists the slices (bin size, first
// row in the group, rows, first row in the table, the span of the run
// CSR and the word column) and each run's fine bin size and first row
// where the coarse blocks set its fine bits. The first design, slices of
// whole rows at 56 KB with 256 threads a block, every slice re-reading
// its group's hashes, took 0.32 ms on the card (scripts/
// torch_merge_pruned_ab.py, PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

#include "dedup.cuh"
#include "ibf_hash.cuh"
#include "scan.cuh"
#include "sm_count.cuh"

namespace {

using namespace ganon_entries;

constexpr int kMaxTiles = 4096;      // stage's shared counters
constexpr int kApplyThreads = 1024;
constexpr int kSortedH = 4;          // stage sorts in shared memory up to h
// a block's dynamic shared memory at most: 227 KB less apply's static
constexpr int kMaxTileBytes = 232448 - 512;

// floor(x / d) for 0 <= x < 2^31 as (x * m) >> s (Granlund and
// Montgomery: m = ceil(2^s / d), s = 31 + ceil(log2 d))
struct FastDiv {
    unsigned long long m;
    int s;
};

__host__ __device__ __forceinline__ FastDiv make_fastdiv(long long d) {
    int l = 0;
    while ((1ll << l) < d) ++l;
    return {((1ull << (31 + l)) + (unsigned long long)d - 1) / (unsigned long long)d,
            31 + l};
}

__device__ __forceinline__ unsigned fastdiv(unsigned x, const FastDiv& f) {
    return (unsigned)(((unsigned long long)x * f.m) >> f.s);
}

// A call's geometry: bits holds rows [row0, row0 + rows) of a matrix of
// W words a row; the bins lie in word columns [c0, c0 + band). A tile is
// rpt rows by cw columns (rpt * cw words of shared memory); the band is
// ncb column blocks, so tile d is row block d / ncb, column block d %
// ncb, and T = ncb * ceil(rows / rpt).
struct Geometry {
    long long W, row0, rows;
    int c0, band, cw, ncb, rpt, T;
    FastDiv rdiv, cdiv;  // by rpt, by cw
    unsigned long long bin_size;
    int h, shift;
};

// Hash function s's bit of (x, bin): its tile and *item, its word in the
// tile << 5 | bit; -1 where the row lies outside the rows (or the bin
// outside the matrix); -2 where the column lies outside the band, with
// *word its word in bits (the band is the caller's hint: such a bit is
// set there directly).
__device__ __forceinline__ int item_at(const Geometry& g,
                                       unsigned long long x, int s, int bin,
                                       unsigned* item, long long* word) {
    const long long lr =
        (long long)ganon_ibf_row(x, s, g.bin_size, g.shift) - g.row0;
    if (lr < 0 || lr >= g.rows) return -1;
    const int c = (bin >> 5) - g.c0;
    if (c < 0 || c >= g.band) {
        if (bin < 0 || (bin >> 5) >= g.W) return -1;
        *word = lr * g.W + (bin >> 5);
        return -2;
    }
    const unsigned rb = fastdiv((unsigned)lr, g.rdiv);
    const unsigned cb = g.ncb > 1 ? fastdiv((unsigned)c, g.cdiv) : 0u;
    *item = (((unsigned)lr - rb * g.rpt) * g.cw + ((unsigned)c - cb * g.cw))
                << 5
            | (unsigned)(bin & 31);
    return (int)(rb * g.ncb + cb);
}

// Ranked mode: the tile's first occurrences' ranks from the rank of its
// first, `base`, and their bins into E.k: a first occurrence of file f
// at rank r has index idx = r - key_start[f] + offset[f] and bin
// bin_base[f] + floor(idx / max(nhb[f], 1)). A lane's entries hold one
// file or two, so it loads a file's parameters (and makes its divisor's
// multiplier) when the file changes.
__device__ __forceinline__ void ranked_bins(Entries& E,
                                            const unsigned (&excl)[kRows],
                                            long long base,
                                            const int* __restrict__ params,
                                            int R) {
    int cf = -1, cbase = 0, cd = 1;
    long long cdelta = 0;
    FastDiv cdiv = make_fastdiv(1);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        long long rk = base + excl[j];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            if ((E.first[j] >> e) & 1u) {
                const int f = E.k[j][e];
                if (f != cf) {
                    cf = f;
                    cbase = __ldg(params + f);
                    cd = max(__ldg(params + R + f), 1);
                    cdelta = (long long)__ldg(params + 2 * R + f)
                             - __ldg(params + 3 * R + f);
                    cdiv = make_fastdiv(cd);
                }
                const long long idx = rk + cdelta;
                long long q;
                if (idx >= 0 && idx < (1ll << 31)) {
                    q = fastdiv((unsigned)idx, cdiv);
                } else {  // floor division, as the plain version's
                    q = idx >= 0 ? idx / cd : -((-idx + cd - 1) / cd);
                }
                E.k[j][e] = (int)(cbase + q);
                ++rk;
            }
        }
    }
}

// A warp's run totals summed over the block: *before gets the runs of the
// warps before this one; returns the tile's.
__device__ __forceinline__ unsigned tile_sum(unsigned run, unsigned* s_warp,
                                             unsigned* before) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) s_warp[wid] = run;
    __syncthreads();
    unsigned b = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const unsigned x = s_warp[w];
        b += w < wid ? x : 0;
        total += x;
    }
    *before = b;
    return total;
}

// stage: the items of one 4096-entry tile (tile blockIdx.x in pairs
// mode, key = bins and val = hashes; in ranked mode the tile drawn in
// order for dedup's chained scan, the ranks from *carry_in on and the
// call's end rank to *carry_out from the block of the last tile), sorted
// by shared-memory tile and written to the block's run of items at tile
// * cap: each item is made once, counted with a shared atomicAdd whose
// result is its rank among its tile's items, and kept in shared memory
// with it; the counts are scanned, and each item goes to its tile's
// first slot plus its rank. loc[d * gridDim.x + tile] gets the first
// slot of tile d in the run (loc[T * gridDim.x + tile] the run's
// length). A bit outside the band is ORed into bits with an atomicOr
// (its word lies in no tile, so apply never writes it).
template <bool kRanked, int kH>
__global__ void __launch_bounds__(kThreads)
stage_kernel(unsigned* __restrict__ bits, const int* __restrict__ key,
             const unsigned long long* __restrict__ val, long long start,
             long long end, int R, Geometry g, const int* __restrict__ params,
             unsigned long long* status, unsigned long long epoch,
             const long long* carry_in, long long* carry_out,
             int* __restrict__ loc, unsigned* __restrict__ items) {
    // [kTile * h] items, [kTile * h] (tile << 16 | rank), and where h <=
    // kSortedH [kTile * h] the items in order, copied out in full lines
    extern __shared__ unsigned kept[];
    constexpr bool kSorted = kH <= kSortedH;
    __shared__ unsigned hist[kMaxTiles];
    __shared__ long long warp_sums[32];
    __shared__ unsigned s_tile, s_n;
    __shared__ unsigned s_warp[kWarps];
    __shared__ long long s_excl;
    for (int d = threadIdx.x; d < g.T; d += kThreads) hist[d] = 0;
    long long tile = blockIdx.x;
    if (kRanked) {
        ganon_scan::draw_tile(status, &s_tile);
        __syncthreads();
        tile = s_tile;
    }
    const long long s0 = start + tile * kTile + (threadIdx.x >> 5) * kWarpTile;
    Entries E;
    load_rows<true>(key, val, s0, end, E);
    if (kRanked) {
        first_flags(key, val, s0, end, R, E);
        unsigned excl[kRows], before;
        const unsigned total = tile_sum(warp_ranks(E, excl), s_warp, &before);
        const long long rank0 = carry_in ? *carry_in : 0;
        const long long bexcl = ganon_scan::chain_publish(
            status + 1, tile, tile == 0, total, epoch, &s_excl);
        if (tile == gridDim.x - 1 && threadIdx.x == 0 && carry_out)
            *carry_out = rank0 + bexcl + total;
        ranked_bins(E, excl, rank0 + bexcl + before, params, R);
    }
    __syncthreads();
    unsigned* tag = kept + kTile * kH;
    // the items, kept in the order of their slots (a warp's 32 lanes on
    // 32 consecutive slots)
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
        const unsigned live = kRanked ? E.first[j] : E.ok[j];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
            #pragma unroll
            for (int s = 0; s < kH; ++s) {
                unsigned item;
                long long word;
                const int d = ((live >> e) & 1u)
                    ? item_at(g, E.v[j][e], s, E.k[j][e], &item, &word) : -1;
                const unsigned slot =
                    ((j * kVec + e) * kH + s) * kThreads + threadIdx.x;
                unsigned t = 0xFFFFFFFFu;
                if (d >= 0) {
                    t = (unsigned)d << 16 | atomicAdd(hist + d, 1u);
                    kept[slot] = item;
                } else if (d == -2) {
                    atomicOr(bits + word, 1u << (E.k[j][e] & 31));
                }
                tag[slot] = t;
            }
        }
    }
    __syncthreads();
    // each thread scans a run of the tiles' counts
    const int per = (g.T + kThreads - 1) / kThreads;
    const int d0 = threadIdx.x * per;
    long long sum = 0;
    for (int q = 0; q < per && d0 + q < g.T; ++q) sum += hist[d0 + q];
    long long n;
    long long x = ganon_scan::block_scan(sum, warp_sums, &n);
    for (int q = 0; q < per && d0 + q < g.T; ++q) {
        const unsigned c = hist[d0 + q];
        hist[d0 + q] = (unsigned)x;
        loc[(long long)(d0 + q) * gridDim.x + tile] = (int)x;
        x += c;
    }
    if (threadIdx.x == 0) {
        loc[(long long)g.T * gridDim.x + tile] = (int)n;
        s_n = (unsigned)n;
    }
    __syncthreads();
    unsigned* run = items + tile * (long long)kTile * kH;
    unsigned* sorted = kSorted ? tag + kTile * kH : run;
#pragma unroll 4
    for (int slot = threadIdx.x; slot < kTile * kH; slot += kThreads) {
        const unsigned t = tag[slot];
        if (t != 0xFFFFFFFFu)
            sorted[hist[t >> 16] + (t & 0xFFFFu)] = kept[slot];
    }
    if (kSorted) {
        __syncthreads();
        for (unsigned i = threadIdx.x; i < s_n; i += kThreads)
            run[i] = sorted[i];
    }
}

// apply: one block a tile gathers its items from every stage block's run
// and ORs them into shared memory, then ORs the tile's nonzero words into
// bits with a read and a write (the block owns them). The runs' lengths
// are scanned in shared memory into their first positions in the
// concatenation of the tile's items; warp w takes a range of it, its
// lanes 32 consecutive positions at a time (so a load reads a run or two,
// not 32 of them), each lane walking forward through the runs, kBatch
// loads in flight.
constexpr int kBatch = 8;

__global__ void __launch_bounds__(kApplyThreads)
apply_kernel(unsigned* __restrict__ bits, const unsigned* __restrict__ items,
             const int* __restrict__ loc, int B, Geometry g) {
    extern __shared__ unsigned smem[];
    __shared__ long long warp_sums[32];
    const int d = blockIdx.x;
    const int words = g.rpt * g.cw;
    unsigned* tile = smem;         // [words]
    unsigned* pre = tile + words;  // [B + 1] runs' first positions
    unsigned* at = pre + B + 1;    // [B] runs' first items, less pre
    for (int w = threadIdx.x; w < words; w += kApplyThreads) tile[w] = 0;
    const long long cap = (long long)kTile * g.h;
    const int per = (B + kApplyThreads - 1) / kApplyThreads;
    const int b0 = threadIdx.x * per;
    long long sum = 0;
    for (int q = 0; q < per && b0 + q < B; ++q) {
        const int b = b0 + q;
        const int lo = loc[(long long)d * B + b];
        const int len = loc[(long long)(d + 1) * B + b] - lo;
        pre[b] = (unsigned)len;
        at[b] = (unsigned)(b * cap + lo);
        sum += len;
    }
    long long total;
    long long x = ganon_scan::block_scan(sum, warp_sums, &total);
    for (int q = 0; q < per && b0 + q < B; ++q) {
        const unsigned len = pre[b0 + q];
        pre[b0 + q] = (unsigned)x;
        at[b0 + q] -= (unsigned)x;
        x += len;
    }
    if (threadIdx.x == 0) pre[B] = (unsigned)total;
    __syncthreads();
    // warp w: positions [p0, p1) of the concatenation
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kWarpsA = kApplyThreads / 32;
    const long long span = ((total + kWarpsA - 1) / kWarpsA + 31) & ~31ll;
    const unsigned p0 = (unsigned)min(total, warp * span);
    const unsigned p1 = (unsigned)min(total, (long long)p0 + span);
    int b = 0;
    if (p0 + lane < p1) {
        int hi = B;  // pre[b] <= p0 + lane < pre[hi]
        while (hi - b > 1) {
            const int mid = (b + hi) >> 1;
            if (pre[mid] <= p0 + lane) b = mid; else hi = mid;
        }
    }
    for (unsigned i = p0 + lane; i < p1; i += 32 * kBatch) {
        unsigned it[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const unsigned k = i + 32 * q;
            if (k < p1) {
                while (pre[b + 1] <= k) ++b;
                it[q] = __ldcs(items + at[b] + k);
            }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            if (i + 32 * q < p1)
                atomicOr(tile + (it[q] >> 5), 1u << (it[q] & 31));
    }
    __syncthreads();
    const long long r0 = (long long)(d / g.ncb) * g.rpt;
    const long long col0 = g.c0 + (long long)(d % g.ncb) * g.cw;
    for (int w0 = 0; w0 < words; w0 += kApplyThreads * kBatch) {
        unsigned v[kBatch], old[kBatch];
        unsigned* p[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int w = w0 + q * kApplyThreads + threadIdx.x;
            v[q] = w < words ? tile[w] : 0u;
            const int r = w / g.cw;
            p[q] = bits + (r0 + r) * g.W + col0 + (w - r * g.cw);
            old[q] = v[q] ? *p[q] : 0u;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
            if (v[q]) *p[q] = old[q] | v[q];
    }
}

constexpr int kPrunedThreads = 1024;
constexpr int kPrunedUnroll = 4;     // hashes a lane in flight
constexpr int kWriteBatch = 8;       // slice words a thread in flight
constexpr int kSliceFields = 8;      // a fine slice's int64 fields
constexpr int kCoarseChunk = 8192;   // the least hashes a coarse block

// Tables by word column: fine_t int32 [Wf, Rf], coarse_t [Wc, Rc] (the
// build's staging layout; word w of row r at w * R + r).
// meta (int64): start [nr + 1], grp [nr], lane [nr], order [nr] (run ids
// by group and word column, stable), fbsz [nr] and foff [nr] (the run's
// group's fine bin size and first row where the coarse blocks set its
// fine bits, fbsz 0 where its column's slices do), then nfb slices of kSliceFields:
// bin_size, r0 (first row in the group), rows, arow (first row in the
// table), lo, hi (the runs of the slice's group and column: order[lo ..
// hi)), wc (the word column), 0.
__global__ void __launch_bounds__(kPrunedThreads, 1)
scatter_pruned_kernel(unsigned* __restrict__ fine_t, long long Rf,
                      unsigned* __restrict__ coarse_t,
                      unsigned long long Rc,
                      const unsigned long long* __restrict__ hashes,
                      long long N, const long long* __restrict__ meta,
                      int nr, int nfb, long long chunk, int fh, int ch) {
    const long long* start = meta;
    const long long* rgrp = start + nr + 1;
    const long long* rlane = rgrp + nr;
    const long long* order = rlane + nr;
    const long long* fbsz = order + nr;
    const long long* foff = fbsz + nr;
    extern __shared__ unsigned slice[];
    if ((int)blockIdx.x < nfb) {
        const long long* sl =
            foff + nr + (long long)blockIdx.x * kSliceFields;
        const unsigned long long bsz = (unsigned long long)sl[0];
        const unsigned long long r0 = (unsigned long long)sl[1];
        const int rows = (int)sl[2];
        const long long arow = sl[3], lo = sl[4], hi = sl[5];
        const int sh = __clzll((long long)bsz);
        for (int w = threadIdx.x; w < rows; w += kPrunedThreads)
            slice[w] = 0u;
        __syncthreads();
        // a warp a run: the run's lane is one bit of the slice's column
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        for (long long k = lo + warp; k < hi; k += kPrunedThreads / 32) {
            const long long r = order[k];
            const long long s0 = start[r], s1 = start[r + 1];
            const unsigned mask = 1u << (rlane[r] & 31);
            for (long long i = s0 + lane; i < s1;
                 i += 32 * kPrunedUnroll) {
                unsigned long long x[kPrunedUnroll];
#pragma unroll
                for (int q = 0; q < kPrunedUnroll; ++q)
                    x[q] = i + 32 * q < s1 ? __ldg(hashes + i + 32 * q) : 0;
#pragma unroll
                for (int q = 0; q < kPrunedUnroll; ++q) {
                    if (i + 32 * q >= s1) continue;
                    for (int s = 0; s < fh; ++s) {
                        // a row before the slice wraps past rows
                        const unsigned long long row =
                            ganon_ibf_row(x[q], s, bsz, sh) - r0;
                        if (row < (unsigned long long)rows)
                            atomicOr(slice + row, mask);
                    }
                }
            }
        }
        __syncthreads();
        // the slice's nonzero words ORed into its rows of the column, a
        // batch of loads in flight a thread
        unsigned* out = fine_t + sl[6] * Rf + arow;
        for (int w0 = 0; w0 < rows; w0 += kPrunedThreads * kWriteBatch) {
            unsigned v[kWriteBatch], old[kWriteBatch];
#pragma unroll
            for (int q = 0; q < kWriteBatch; ++q) {
                const int w = w0 + q * kPrunedThreads + threadIdx.x;
                v[q] = w < rows ? slice[w] : 0u;
                old[q] = v[q] ? out[w] : 0u;
            }
#pragma unroll
            for (int q = 0; q < kWriteBatch; ++q)
                if (v[q]) out[w0 + q * kPrunedThreads + threadIdx.x] =
                    old[q] | v[q];
        }
        return;
    }
    // a coarse block: hashes [i0, i1), from the run that holds i0 (the
    // last whose start is at most i0); the fine bits too of a run whose
    // column has no slices
    const long long i0 = (long long)(blockIdx.x - nfb) * chunk;
    const long long i1 = min(i0 + chunk, N);
    int a = 0, b = nr - 1;
    while (a < b) {
        const int m = (a + b + 1) >> 1;
        if (start[m] <= i0) a = m;
        else b = m - 1;
    }
    const int csh = __clzll((long long)Rc);
    for (int r = a; r < nr && start[r] < i1; ++r) {
        const long long s0 = max(start[r], i0), s1 = min(start[r + 1], i1);
        const int g = (int)rgrp[r];
        unsigned* col = coarse_t + (unsigned long long)(g >> 5) * Rc;
        const unsigned mask = 1u << (g & 31);
        const unsigned long long fb = (unsigned long long)fbsz[r];
        const int fsh = fb ? __clzll((long long)fb) : 0;
        unsigned* fcol = fine_t + (rlane[r] >> 5) * Rf + foff[r];
        const unsigned fmask = 1u << (rlane[r] & 31);
        for (long long i = s0 + threadIdx.x; i < s1;
             i += kPrunedThreads * kPrunedUnroll) {
            unsigned long long x[kPrunedUnroll];
#pragma unroll
            for (int q = 0; q < kPrunedUnroll; ++q) {
                const long long j = i + kPrunedThreads * q;
                x[q] = j < s1 ? __ldg(hashes + j) : 0;
            }
#pragma unroll
            for (int q = 0; q < kPrunedUnroll; ++q) {
                if (i + kPrunedThreads * q >= s1) continue;
                for (int s = 0; s < ch; ++s)
                    atomicOr(col + ganon_ibf_row(x[q], s, Rc, csh), mask);
                if (fb)
                    for (int s = 0; s < fh; ++s)
                        atomicOr(fcol + ganon_ibf_row(x[q], s, fb, fsh),
                                 fmask);
            }
        }
    }
}

// The geometry of a call; false where it cannot be served (h, an empty or
// out-of-range band, a tile past shared memory, more than kMaxTiles
// tiles: the caller cuts the rows into windows first).
bool make_geometry(long long rows, long long W, long long row0, long long c0,
                   long long band, long long cw, long long rpt,
                   unsigned long long bin_size, int h, int shift,
                   Geometry& g) {
    if (h < 1 || h > 5 || W < 1 || rows < 1 || rows >= (1ll << 31)
        || row0 < 0 || c0 < 0 || band < 1 || c0 + band > W
        || c0 + band >= (1ll << 26) || cw < 1 || cw > band || rpt < 1
        || rpt * cw * 4 > kMaxTileBytes)
        return false;
    g.W = W;
    g.row0 = row0;
    g.rows = rows;
    g.c0 = (int)c0;
    g.band = (int)band;
    g.cw = (int)cw;
    g.ncb = (int)((band + cw - 1) / cw);
    g.rpt = (int)rpt;
    const long long T = g.ncb * ((rows + rpt - 1) / rpt);
    if (T > kMaxTiles) return false;
    g.T = (int)T;
    g.rdiv = make_fastdiv(g.rpt);
    g.cdiv = make_fastdiv(g.cw);
    g.bin_size = bin_size;
    g.h = h;
    g.shift = shift;
    return true;
}

// stage (at h = kH) then apply
template <bool kRanked, int kH>
int stage_and_apply(void* bits, const void* key, const void* val,
                    long long start, long long end, int R, const Geometry& g,
                    const void* params, void* status,
                    unsigned long long epoch, const void* carry_in,
                    void* carry_out, void* loc, void* items,
                    cudaStream_t s) {
    const long long B = (end - start + kTile - 1) / kTile;
    const int stage_smem =
        (kH <= kSortedH ? 3 : 2) * kTile * kH * (int)sizeof(unsigned);
    // the tile, then the runs' positions and first items
    const int apply_smem =
        (g.rpt * g.cw + 2 * (int)B + 1) * (int)sizeof(unsigned);
    if (apply_smem > kMaxTileBytes) return (int)cudaErrorInvalidValue;
    int err = (int)cudaFuncSetAttribute(
        stage_kernel<kRanked, kH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage_smem);
    if (!err)
        err = (int)cudaFuncSetAttribute(
            apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            apply_smem);
    if (err) return err;
    stage_kernel<kRanked, kH><<<(unsigned)B, kThreads, stage_smem, s>>>(
        (unsigned*)bits, (const int*)key, (const unsigned long long*)val,
        start, end, R, g, (const int*)params, (unsigned long long*)status, epoch,
        (const long long*)carry_in, (long long*)carry_out, (int*)loc,
        (unsigned*)items);
    apply_kernel<<<(unsigned)g.T, kApplyThreads, apply_smem, s>>>(
        (unsigned*)bits, (const unsigned*)items, (const int*)loc, (int)B, g);
    return (int)cudaGetLastError();
}

template <bool kRanked>
int stage_and_apply_h(void* bits, const void* key, const void* val,
                      long long start, long long end, int R,
                      const Geometry& g, const void* params, void* status,
                      unsigned long long epoch, const void* carry_in,
                      void* carry_out, void* loc, void* items,
                      cudaStream_t s) {
    switch (g.h) {
#define GANON_H(H)                                                       \
    case H:                                                              \
        return stage_and_apply<kRanked, H>(bits, key, val, start, end, R, \
                                           g, params, status, epoch,     \
                                           carry_in, carry_out, loc,     \
                                           items, s);
        GANON_H(1) GANON_H(2) GANON_H(3) GANON_H(4) GANON_H(5)
#undef GANON_H
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Scratch of both entries, for calls of n pairs or entries at h hash
// functions and T tiles, B = ceil(n / 4096): loc int32 [(T + 1) * B],
// items int32 [B * 4096 * h]. bits holds rows [row0, row0 + rows) of the
// matrix, W words a row; the bins lie in word columns [c0, c0 + band)
// (a hint: a bit outside is ORed straight into bits, at an atomic's
// cost); a tile is rpt rows by cw of those columns, its rpt * cw words
// and 8 bytes a block of B within a block's shared memory (227 KB).

// The flat library build (K9): N pairs, hashes int64 and bins int32 [N]
// (both 16-byte aligned).
extern "C" int ganon_scatter(void* bits, long long rows, long long W,
                             long long row0, const void* hashes,
                             const void* bins, long long N,
                             unsigned long long bin_size, int h, int shift,
                             long long c0, long long band, long long cw,
                             long long rpt, void* loc, void* items,
                             void* stream) {
    Geometry g;
    if (!make_geometry(rows, W, row0, c0, band, cw, rpt, bin_size, h, shift,
                       g)
        || N * h >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
    return stage_and_apply_h<false>(bits, bins, hashes, 0, N, 0, g, nullptr,
                                    nullptr, 0, nullptr, nullptr, loc, items,
                                    (cudaStream_t)stream);
}

// The ranked (and span) scatter of entries [start, end) of the sorted key
// int32 / val int64 arrays (16-byte aligned; start a multiple of 4):
// params int32 [4, R]; status: int64 [1 + B] chained-scan words and epoch
// as for ganon_ragged (scan.cu); carry_in: the number of first occurrences
// before start (int64, on the card; NULL: 0), carry_out gets it for end
// (NULL: not written).
extern "C" int ganon_scatter_ranked(
        void* bits, long long rows, long long W, long long row0,
        const void* key, const void* val, long long start, long long end,
        const void* params, int R, unsigned long long bin_size, int h,
        int shift, long long c0, long long band, long long cw, long long rpt,
        void* status, unsigned long long epoch, const void* carry_in,
        void* carry_out, void* loc, void* items, void* stream) {
    Geometry g;
    const long long n = end - start;
    if (!make_geometry(rows, W, row0, c0, band, cw, rpt, bin_size, h, shift,
                       g)
        || start < 0 || (start & 3) || n * h >= (1ll << 31)
        || end >= (1ll << 31) || epoch < 1 || epoch >= (1ull << 31))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaGetLastError();
    return stage_and_apply_h<true>(bits, key, val, start, end, R, g, params,
                                   status, epoch, carry_in, carry_out, loc,
                                   items, (cudaStream_t)stream);
}

// The pruned flush (K16): fine_t int32 [Wf, Rf] and coarse_t int32 [Wc,
// Rc] by word column (Rc the coarse bin size), N hashes (int64, u64 bit
// patterns), meta as scatter_pruned_kernel reads it (nr runs, nfb slices,
// each slice at most slice_rows rows; the host's plan keeps every slice
// and every run's fine rows inside its column, every lane below Wf * 32
// and every group below Wc * 32).
extern "C" int ganon_scatter_pruned(void* fine_t, long long Rf, long long Wf,
                                    void* coarse_t, long long Rc,
                                    long long Wc, const void* hashes,
                                    long long N, const void* meta, int nr,
                                    int nfb, long long slice_rows, int fh,
                                    int ch, void* stream) {
    if (fh < 1 || fh > 5 || ch < 1 || ch > 5 || Rf < 1 || Wf < 1 || Rc < 1
        || Wc < 1 || N < 0 || nfb < 0 || (N > 0 && nr < 1)
        || slice_rows < 1 || slice_rows * 4 > kMaxTileBytes)
        return (int)cudaErrorInvalidValue;
    if (N == 0) return (int)cudaGetLastError();
    // with slices, a block an SM (each holds a slice's shared memory);
    // without, the coarse blocks alone, smaller chunks and more of them
    // in flight
    const long long smem = nfb ? slice_rows * 4 : 0;
    const long long least = nfb ? kCoarseChunk : kCoarseChunk / 4;
    const long long cap = (nfb ? 1ll : 4ll) * sm_count();
    long long ncb = (N + least - 1) / least;
    if (ncb > cap) ncb = cap;
    const long long chunk = (N + ncb - 1) / ncb;
    if (nfb + ncb >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const int err = (int)cudaFuncSetAttribute(
        scatter_pruned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
    scatter_pruned_kernel<<<(unsigned)(nfb + ncb), kPrunedThreads,
                            (size_t)smem, (cudaStream_t)stream>>>(
        (unsigned*)fine_t, Rf, (unsigned*)coarse_t, (unsigned long long)Rc,
        (const unsigned long long*)hashes, N, (const long long*)meta, nr,
        nfb, chunk, fh, ch);
    return (int)cudaGetLastError();
}
