// scan.cuh: the block scan and the chained scan's look-back, shared by
// the single-pass scans of scan.cu (ragged, pairs) and extract.cu.
//
// A chained scan (decoupled look-back, Merrill and Garland, 2016): a block
// draws its tile from an atomic counter (status[0]), publishes its
// aggregate as a status word (status[1 + tile]), takes its exclusive
// prefix from its predecessors' words with chained_prefix, and publishes
// its inclusive prefix. The block that draws the last tile sets the
// counter back to 0 (draw_tile), so the next call on the stream starts
// at 0 with no clear. A status word is epoch << 33 | flag << 31 | value:
// a word whose epoch is not the call's reads as not yet published, so the
// words of earlier calls in the buffer need no clear either. Why a buffer
// may be shared by every scan on a stream: see scan.cu's header.
#pragma once

#include <cuda_runtime.h>

namespace ganon_scan {

constexpr int kEpochShift = 33;
constexpr unsigned long long kFlagAggregate = 1ull << 31;
constexpr unsigned long long kFlagInclusive = 2ull << 31;
constexpr unsigned long long kValueMask = kFlagAggregate - 1;

// Exclusive prefix of v over the block; *total gets the block's sum.
// warp_sums: 32 words of shared memory.
__device__ __forceinline__ long long block_scan(long long v,
                                                long long* warp_sums,
                                                long long* total) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    long long x = v;
    for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(0xFFFFFFFFu, x, off);
        if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
        long long s = lane < nwarps ? warp_sums[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
            const long long y = __shfl_up_sync(0xFFFFFFFFu, s, off);
            if (lane >= off) s += y;
        }
        warp_sums[lane] = s;
    }
    __syncthreads();
    const long long excl = x - v + (wid ? warp_sums[wid - 1] : 0);
    *total = warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums is reused by the next call
    return excl;
}

// Thread 0 draws the block's tile into *s_tile (the caller syncs): tiles
// are handed out in the order blocks start, so a block's predecessors are
// running or done, and the drawer of the last tile resets the counter.
__device__ __forceinline__ void draw_tile(unsigned long long* status,
                                          unsigned* s_tile) {
    if (threadIdx.x == 0) {
        unsigned* counter = (unsigned*)status;
        *s_tile = atomicAdd(counter, 1u);
        // every tile is drawn: the next call on the stream starts at 0
        if (*s_tile == gridDim.x - 1) atomicExch(counter, 0u);
    }
}

// draw_tile for a block that publishes what it stored before the ticket
// (the caller syncs before and after): thread 0's acq_rel atomic orders
// the block's stores, made before the barrier, ahead of its ticket, and
// the drawer's later reads after the tickets drawn before it, so the
// drawer of the last ticket sees every block's stores.
__device__ __forceinline__ void draw_ticket_release(
        unsigned long long* status, unsigned* s_ticket) {
    if (threadIdx.x == 0) {
        unsigned* counter = (unsigned*)status;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                     : "=r"(*s_ticket) : "l"(counter) : "memory");
        if (*s_ticket == gridDim.x - 1) atomicExch(counter, 0u);
    }
}

// The exclusive prefix of block `tile` (> 0) of a chained scan whose
// blocks publish kFlagAggregate | their sum, then kFlagInclusive | their
// inclusive prefix, tagged with `epoch`: one warp (every lane gets the
// result) reads its predecessors' words 32 at a time, nearest first,
// waiting on a word not yet published; the nearest inclusive word ends
// the walk. A block's predecessors drew their tiles first and publish
// without waiting, so the walk always ends. A segmented scan has the
// first tile of each segment publish kFlagInclusive | its own sum at
// once: the walk of a later tile of the segment ends there.
__device__ __forceinline__ long long chained_prefix(
        const volatile unsigned long long* status, long long tile,
        unsigned long long epoch) {
    const int lane = threadIdx.x & 31;
    long long excl = 0;
    for (long long p = tile - 1;; p -= 32) {
        const long long q = p - lane;
        unsigned long long s = kFlagInclusive;  // before block 0: 0
        if (q >= 0) {
            while (((s = status[q]) >> kEpochShift) != epoch) __nanosleep(32);
        }
        const unsigned incl =
            __ballot_sync(0xFFFFFFFFu, (s & kFlagInclusive) != 0);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        long long x = lane <= stop ? (long long)(s & kValueMask) : 0;
        for (int off = 16; off; off >>= 1)
            x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
        excl += x;
        if (incl) return excl;
    }
}

// The block's exclusive prefix in a (segmented) chained scan: warp 0
// publishes the block's `total` (at once as inclusive when `first`, the
// first tile of its segment), walks back with chained_prefix otherwise,
// and publishes the inclusive prefix; every thread gets the result
// through *s_excl. `st` is the status words after the counter.
__device__ __forceinline__ long long chain_publish(
        volatile unsigned long long* st, long long tile, bool first,
        long long total, unsigned long long epoch, long long* s_excl) {
    if (threadIdx.x < 32) {
        const unsigned long long tag = epoch << kEpochShift;
        long long excl = 0;
        if (!first) {
            if (threadIdx.x == 0)
                st[tile] = tag | kFlagAggregate | (unsigned long long)total;
            excl = chained_prefix(st, tile, epoch);
        }
        if (threadIdx.x == 0) {
            st[tile] = tag | kFlagInclusive
                       | (unsigned long long)(excl + total);
            *s_excl = excl;
        }
    }
    __syncthreads();
    return *s_excl;
}

}  // namespace ganon_scan
