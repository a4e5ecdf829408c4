// repack: the interleaved bit-matrix -> the byte-aligned query table.
//
// Replaces the host repack of every filter load: the JAX package's
// ganon_tpu/ops/ibf_query.py:162 pack_table_u8 (+ :218 table_as_u32's
// pad to whole u32 words), a numpy unpackbits / gather / packbits over
// 4096-row chunks that its loaders run on the host
// (ganon_tpu/classify/device.py:746, :1005). It is a host function, not a
// jitted program, and was the last hot loop of the load outside a kernel.
//
// Layout: bits u32 [R, W] (bin b of a row: word b / 32, bit b % 32). The
// kernel writes tbl u32 [R, wc], the table's word columns c0w .. c0w + wc
// - 1 (a column shard, or the whole table); a column at or past the
// plan's n_dst / 32 is zero. The host's plan (ops/ibf_query.py
// repack_plan, repack_geometry) gives each word column its runs (a run:
// consecutive kept destination bits from consecutive bits of one source
// word, here as (source word << 5 | right rotation, destination mask)),
// CSR offsets per column, and the window's column tiles: the window's
// part of 128 word columns, the runs of the columns a tile stores, the
// span of source words its plan tiles name, and how the tile reads them.
//
// What bounds it on the H100: device memory. Each source word the window
// names is read once a row and each output word stored once (db: 349 MB
// in, 2.79 GB out, about 0.94 ms at 3.35 TB/s); the 2.79 GB of stores
// are the floor.
//
// Design. A persistent grid (as many blocks as the SMs hold) walks the
// (column tile, row tile) items in column-tile-major order, each block a
// contiguous share, so a block loads a tile's runs and CSR offsets into
// shared memory once and then streams its row tiles. A row tile's source
// (its rows' words [lo, lo + span), each row segment placed 16-byte
// aligned as it lies in memory; or whole rows, where a row is no wider
// than a segment) is staged in a ring of kStages stages by cp.async, three
// row tiles ahead of the one being built. cp.async (16 bytes a thread, 4
// bytes at a segment's unaligned head and tail) rather than TMA bulk
// copies: rows of 2 or 3 words and a view that starts off 16 bytes put
// the segments at every 4-byte offset, which bulk copies refuse, and a
// thread's copy needs no elected producer or mbarrier phase. A tile whose
// span does not fit a stage (a shuffled layout naming words all over a
// row) reads its words in place through L1, in the same launch. Each
// thread builds an aligned quad of 4 output words (16 bytes of the table)
// in kRows rows: for each word, its column's runs in order of source
// word, each source word loaded once a row, then a funnel-shift rotation
// and an AND-OR a run and a row (no test of 32 destination bits). A warp
// covers 32 quads, 512 contiguous bytes of a row (or whole rows of a
// narrower window), stored with st.global.cs: the table does not fit L2.
// Where the window's width or start is off the 16-byte grid, each row
// keeps its quads on the grid (a thread's rows share their place on it),
// and the row's head and tail words are stored 4 bytes at a time. Every
// word is stored once: no fill, nothing atomic. Offsets are 64-bit (db's
// table passes 2^31 bytes).
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kStages = 4;
constexpr int kDirect = 0, kSegments = 1, kSlab = 2;
constexpr int kMaxSmem = 232448;

struct Tile {
    int xa, xb, xd, ra, rb, lo, span, mode;
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// words [g, g + 4) of the source, counted from the 16-byte boundary below
// bits (g a multiple of 4; off0 = bits' word offset past that boundary),
// into dst: one 16-byte copy where all four lie in [a, e), else those
// that do, a word each
__device__ __forceinline__ void copy_chunk(unsigned* dst,
                                           const unsigned* bits, int off0,
                                           long long g, long long a,
                                           long long e) {
    if (g >= a && g + 4 <= e) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         shared_addr(dst)),
                     "l"(bits + (g - off0)));
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (g + j >= a && g + j < e)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                             shared_addr(dst + j)),
                         "l"(bits + (g + j - off0)));
}

__device__ __forceinline__ void commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_copies() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a row tile's source words into stage st: rows [r0, r0 + nrows)
__device__ __forceinline__ void stage_rows(unsigned* st, const unsigned* bits,
                                           int off0, long long W,
                                           long long r0, int nrows,
                                           const Tile& t) {
    if (t.mode == kSlab) {  // whole rows, one run of memory
        const long long a = off0 + r0 * W, e = a + nrows * W;
        const int chunks = (int)(((e + 3) >> 2) - (a >> 2));
        for (int c = threadIdx.x; c < chunks; c += kThreads)
            copy_chunk(st + 4 * c, bits, off0, (a & ~3LL) + 4LL * c, a, e);
    } else {  // each row's segment at a pitch of whole 16-byte chunks
        const int pitch = (t.span + 6) & ~3, per = pitch >> 2;
        for (int i = threadIdx.x; i < nrows * per; i += kThreads) {
            const int rr = i / per, c = i - rr * per;
            const long long a = off0 + (r0 + rr) * W + t.lo;
            copy_chunk(st + rr * pitch + 4 * c, bits, off0,
                       (a & ~3LL) + 4LL * c, a, a + t.span);
        }
    }
}

__device__ __forceinline__ unsigned load_word(const unsigned* stage,
                                              int at) {
    return stage[at];
}

__device__ __forceinline__ unsigned load_word(const unsigned* bits,
                                              long long at) {
    return __ldg(bits + at);
}

// the run at position p of a tile's runs (a 16-run block's order XORed by
// the block's index, so threads a run block apart meet other banks)
__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 4) & 15); }

// this thread's quad in kRows rows: word j from runs [pb[j], pe[j]) of
// desc, source word w of row k at src[base[k] + w]
template <typename Off>
__device__ __forceinline__ void build_quad(const unsigned* __restrict__ src,
                                           const Off (&base)[kRows],
                                           const int2* __restrict__ desc,
                                           const int (&pb)[4],
                                           const int (&pe)[4],
                                           unsigned (&acc)[4][kRows]) {
    int cur = -1;
    unsigned v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) acc[j][k] = 0;
        for (int p = pb[j]; p < pe[j]; ++p) {
            const int2 d = desc[swz(p)];
            const int w = d.x >> 5;
            if (w != cur) {  // a source word once a row
                cur = w;
#pragma unroll
                for (int k = 0; k < kRows; ++k)
                    v[k] = load_word(src, base[k] + w);
            }
            const unsigned rot = d.x & 31, mask = (unsigned)d.y;
#pragma unroll
            for (int k = 0; k < kRows; ++k)
                acc[j][k] |= __funnelshift_r(v[k], v[k], rot) & mask;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 2)
repack_kernel(const unsigned* __restrict__ bits, long long R, long long W,
              int off0, const int2* __restrict__ runs,
              const int* __restrict__ col_runs, long long n_cols,
              const int4* __restrict__ tiles, long long c0w, long long wc,
              int cq, int nrb, int stage_words, int desc_cap,
              long long n_rt, long long items, unsigned* __restrict__ tbl) {
    extern __shared__ __align__(16) unsigned smem[];
    unsigned* ring = smem;
    int2* desc = reinterpret_cast<int2*>(smem + kStages * stage_words);
    int* offs = reinterpret_cast<int*>(desc + desc_cap);
    const int tid = threadIdx.x;
    // this thread's quad slot and row batch, and its rows' place on the
    // 16-byte grid (a quad starts h words into a row: (r * wc + h) % 4
    // == 0 for each of its rows, nrb * wc being a multiple of 4)
    const int s = tid % cq, b = tid / cq;
    const bool worker = b < nrb;
    const int h = (int)((-(long long)b * wc) & 3);
    const long long rt_rows = (long long)nrb * kRows;
    const long long i1 = items * (blockIdx.x + 1) / gridDim.x;
    for (long long i = items * blockIdx.x / gridDim.x; i < i1;) {
        const int t_i = (int)(i / n_rt);
        const long long rt0 = i - t_i * n_rt;
        const long long n = (i1 < (t_i + 1) * n_rt ? i1 : (t_i + 1) * n_rt) - i;
        i += n;
        const int4 t0 = tiles[2 * t_i], t1 = tiles[2 * t_i + 1];
        const Tile t{t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
        __syncthreads();  // the last tile's runs and stages are read
        for (int p = tid; p < t.rb - t.ra; p += kThreads) {
            int2 d = runs[t.ra + p];
            d.x -= t.lo << 5;
            desc[swz(p)] = d;
        }
        for (int c = tid; c <= t.xd - t.xa; c += kThreads) {
            const long long g = c0w + t.xa + c;
            offs[c] = col_runs[g < n_cols ? g : n_cols] - t.ra;
        }
        __syncthreads();
        // the quad this thread owns in the tile: the quads whose first
        // window column lies in [xa, xb); the first tile's head quad
        // starts before the window
        const int qa = (t.xa == 0 && h > 0) ? -1 : (t.xa - h + 3) >> 2;
        const int q = qa + s;
        const bool live = worker && q < ((t.xb - h + 3) >> 2);
        const int x0 = h + 4 * q;
        int pb[4], pe[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int x = x0 + j;
            const bool ok = live && x >= 0 && x < wc;
            pb[j] = ok ? offs[x - t.xa] : 0;
            pe[j] = ok ? offs[x - t.xa + 1] : 0;
        }
        const bool whole = live && x0 >= 0 && x0 + 4 <= wc;
        // one row tile: build and store (staged: from stage st)
        auto item = [&](long long rt, const unsigned* st) {
            const long long r0 = rt * rt_rows;
            const int nrows = (int)(R - r0 < rt_rows ? R - r0 : rt_rows);
            unsigned acc[4][kRows];
            if (t.mode == kDirect) {
                long long base[kRows];
#pragma unroll
                for (int k = 0; k < kRows; ++k) {
                    const long long r = r0 + b + k * nrb;
                    base[k] = (r < R ? r : R - 1) * W + t.lo;
                }
                build_quad(bits, base, desc, pb, pe, acc);
            } else {
                int base[kRows];
                const int pitch = (t.span + 6) & ~3;
                const long long a0 = off0 + r0 * W;
#pragma unroll
                for (int k = 0; k < kRows; ++k) {
                    const int rr = b + k * nrb;
                    base[k] = rr >= nrows ? 0
                              : t.mode == kSegments
                                  ? rr * pitch
                                        + (int)((a0 + rr * W + t.lo) & 3)
                                  : (int)(a0 & 3) + rr * (int)W + t.lo;
                }
                build_quad(st, base, desc, pb, pe, acc);
            }
            if (!live) return;
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const int rr = b + k * nrb;
                if (rr >= nrows) break;
                unsigned* o = tbl + (r0 + rr) * wc + x0;
                if (whole) {
                    __stcs(reinterpret_cast<uint4*>(o),
                           make_uint4(acc[0][k], acc[1][k], acc[2][k],
                                      acc[3][k]));
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (x0 + j >= 0 && x0 + j < wc)
                            __stcs(o + j, acc[j][k]);
                }
            }
        };
        if (t.mode == kDirect) {
            for (long long it = 0; it < n; ++it) item(rt0 + it, nullptr);
            continue;
        }
        // the ring: row tiles it + 1 .. it + kStages - 1 in flight while
        // row tile it is built
        auto stage = [&](long long it) {
            const long long r0 = (rt0 + it) * rt_rows;
            stage_rows(ring + (it % kStages) * stage_words, bits, off0, W, r0,
                       (int)(R - r0 < rt_rows ? R - r0 : rt_rows), t);
        };
#pragma unroll
        for (int it = 0; it < kStages - 1; ++it) {
            if (it < n) stage(it);
            commit();
        }
        for (long long it = 0; it < n; ++it) {
            wait_copies<kStages - 2>();  // row tile it's copies, this thread's
            __syncthreads();  // everyone's; and row tile it - 1 is built
            if (it + kStages - 1 < n) stage(it + kStages - 1);
            commit();
            item(rt0 + it, ring + (it % kStages) * stage_words);
        }
        wait_copies<0>();
    }
}

}  // namespace

// bits: u32 [R, W]; runs: int2 [n_runs]; col_runs: int32 [n_dst / 32 +
// 1]; tiles: int4 [2 * n_tiles]; the rest from ops/ibf_query.py
// repack_geometry for word columns [c0w, c0w + wc); tbl: u32 [R, wc],
// 16-byte aligned. n_dst not a multiple of 32, a negative size or
// offset, a geometry the block cannot hold, or a misaligned pointer:
// cudaErrorInvalidValue, before any launch.
extern "C" int ganon_repack(const void* bits, long long R, long long W,
                            const void* runs, const void* col_runs,
                            long long n_dst, const void* tiles, int n_tiles,
                            long long c0w, long long wc, int cq, int nrb,
                            int stage_words, int desc_cap, int col_cap,
                            void* tbl, void* stream) {
    if (R < 0 || W < 1 || n_dst < 0 || n_dst % 32 || c0w < 0 || wc < 0
        || n_tiles < 1 || cq < 1 || nrb < 1 || cq * nrb > kThreads
        || (wc % 4 && nrb % 4) || stage_words < 4 || stage_words % 4
        || desc_cap < 1 || col_cap < 2
        || ((unsigned long long)bits & 3) || ((unsigned long long)runs & 7)
        || ((unsigned long long)col_runs & 3)
        || ((unsigned long long)tiles & 15) || ((unsigned long long)tbl & 15))
        return (int)cudaErrorInvalidValue;
    if (R == 0 || wc == 0) return (int)cudaGetLastError();
    // the runs' slots rounded to whole 16-run blocks (the swizzle's)
    const int desc_slots = (desc_cap + 15) & ~15;
    const long long smem = 4LL * kStages * stage_words + 8LL * desc_slots
                           + 4LL * col_cap;
    if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        repack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, repack_kernel,
                                                        kThreads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long rt_rows = (long long)nrb * kRows;
    const long long n_rt = (R + rt_rows - 1) / rt_rows;
    const long long items = n_tiles * n_rt;
    long long blocks = (long long)sm_count() * per_sm;
    if (blocks > items) blocks = items;
    repack_kernel<<<(unsigned)blocks, kThreads, (size_t)smem,
                    (cudaStream_t)stream>>>(
        (const unsigned*)bits, R, W,
        (int)(((unsigned long long)bits >> 2) & 3), (const int2*)runs,
        (const int*)col_runs, n_dst / 32, (const int4*)tiles, c0w, wc, cq, nrb,
        stage_words, desc_slots, n_rt, items, (unsigned*)tbl);
    return (int)cudaGetLastError();
}

// blocks of the repack kernel an SM holds at smem bytes of dynamic shared
// memory (0 where the query fails)
extern "C" int ganon_repack_blocks_per_sm(int smem) {
    int per_sm = 0;
    if (cudaFuncSetAttribute(repack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, repack_kernel, kThreads, (size_t)smem)
               != cudaSuccess)
        return 0;
    return per_sm;
}
