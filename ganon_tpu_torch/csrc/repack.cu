// repack: the interleaved bit-matrix -> the byte-aligned query table.
//
// Replaces the host repack of every filter load: the JAX package's
// ganon_tpu/ops/ibf_query.py:162 pack_table_u8 (+ :218 table_as_u32's
// pad to whole u32 words), a numpy unpackbits / gather / packbits over
// 4096-row chunks that its loaders run on the host
// (ganon_tpu/classify/device.py:746, :1005). It is a host function, not a
// jitted program, and was the last hot loop of the load outside a kernel.
//
// Layout: bits u32 [R, W] (bin b of a row: word b / 32, bit b % 32);
// src_of_dst int32 [n_dst] (ops/ibf_query.py repack_plan; n_dst = W8p * 8,
// a multiple of 32): the source bin of each destination bit of a row of
// the padded table, -1 for a padding bit. The kernel writes tbl u32
// [R, wc], the table's words c0w .. c0w + wc - 1 (a column shard, or the
// whole table); a destination bit at or past n_dst is zero.
//
// What bounds it on the H100: device memory. Each source row is read
// from device memory once and each output word stored once (db: 349 MB
// in, 2.79 GB out, about 0.94 ms at 3.35 TB/s).
//
// Design: a thread owns one output word column and keeps that column's
// 32 source bins in registers (eight 16-byte loads, once a run of rows);
// it walks kRows rows. A block covers cw = min(wc, 256) neighbouring
// columns and 256 / cw rows a step, so a narrow table (a forest or raptor
// sub of 64 targets: 16 words; a mesh shard) keeps the block's threads
// busy. For each row a thread reads the source words its bins name
// through the read-only cache (a warp's threads name words of one row, or
// of a few neighbouring rows of a narrow table, so a row reaches L1 once;
// a 2188-word row, 8.7 KB, needs no staging buffer sized to it) and
// stores one u32, zeros included, so the caller does no fill and nothing
// is atomic. A warp stores 128 neighbouring bytes of the table (32 words
// of a row, or whole rows of a narrow one). Offsets are 64-bit (db's
// table passes 2^31
// bytes); the (row run, column tile) items go on blockIdx.x, grid-strided,
// never on gridDim.y (capped at 65,535).
#include <cuda_runtime.h>

#include "sm_count.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;
constexpr int kBlocksPerSm = 16;

__global__ void __launch_bounds__(kThreads)
repack_kernel(const unsigned* __restrict__ bits, long long R, long long W,
              const int4* __restrict__ src, long long n_dst_words,
              long long c0w, long long wc, int cw, int rps,
              long long col_tiles, long long items,
              unsigned* __restrict__ tbl) {
    // this thread's column in a tile and row in a step; threads past the
    // last whole step idle (no barrier below: a thread may leave)
    const int ro = threadIdx.x / cw;
    if (ro >= rps) return;
    const long long span = (long long)kRows * rps;  // rows an item
    for (long long item = blockIdx.x; item < items; item += gridDim.x) {
        const long long tile = item % col_tiles;
        const long long rb = (item / col_tiles) * span;
        const long long c = tile * cw + threadIdx.x % cw;
        if (c >= wc) continue;
        const long long gw = c0w + c;
        int s[32];
        if (gw < n_dst_words) {
            const int4* p = src + gw * 8;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                const int4 v = __ldg(p + q);
                s[4 * q] = v.x;
                s[4 * q + 1] = v.y;
                s[4 * q + 2] = v.z;
                s[4 * q + 3] = v.w;
            }
        } else {  // past the padded table: zero words
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = -1;
        }
        const long long r1 = rb + span < R ? rb + span : R;
        const long long r0 = rb + ro;
        const unsigned* row = bits + r0 * W;
        unsigned* out = tbl + r0 * wc + c;
        for (long long r = r0; r < r1;
             r += rps, row += rps * W, out += rps * wc) {
            unsigned v = 0;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                if (s[i] >= 0)
                    v |= ((__ldg(row + (s[i] >> 5)) >> (s[i] & 31)) & 1u)
                         << i;
            }
            *out = v;
        }
    }
}

}  // namespace

// bits: u32 [R, W]; src_of_dst: int32 [n_dst], 16-byte aligned, every
// entry -1 or a bin below W * 32 (the wrapper checks the plan); c0w, wc:
// the output's first word column of the padded table and its words a row;
// tbl: u32 [R, wc]. n_dst not a multiple of 32, a negative offset or an
// unaligned pointer: cudaErrorInvalidValue, before any launch.
extern "C" int ganon_repack(const void* bits, long long R, long long W,
                            const void* src_of_dst, long long n_dst,
                            long long c0w, long long wc, void* tbl,
                            void* stream) {
    if (R < 0 || W < 1 || n_dst < 0 || n_dst % 32 || c0w < 0 || wc < 0
        || ((unsigned long long)src_of_dst & 15)
        || ((unsigned long long)bits & 3) || ((unsigned long long)tbl & 3))
        return (int)cudaErrorInvalidValue;
    if (R == 0 || wc == 0) return (int)cudaGetLastError();
    const int cw = wc < kThreads ? (int)wc : kThreads;
    const int rps = kThreads / cw;
    const long long col_tiles = (wc + cw - 1) / cw;
    const long long span = (long long)kRows * rps;
    const long long items = col_tiles * ((R + span - 1) / span);
    long long blocks = items;
    const long long cap = (long long)sm_count() * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
    repack_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)bits, R, W, (const int4*)src_of_dst, n_dst / 32,
        c0w, wc, cw, rps, col_tiles, items, (unsigned*)tbl);
    return (int)cudaGetLastError();
}
