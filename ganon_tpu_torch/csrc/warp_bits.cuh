// Warp-level row loads and bit counts shared by the gate, fine and bins
// kernels.
//
// The kernels give a read (or a (read, group) pair) to one warp and walk
// its hashes in rounds of 32, lane i on hash m0 + i: each lane loads the
// words of its hash's table rows, and the warp counts, for every bit k of
// those words, the lanes that have it set. The count of bit k of word r
// lands in cnt[r] of lane k, so 32 * NW counters live in NW registers a
// lane, with no shared memory and no atomics.

#pragma once

#include <cstdint>

#include "ibf_hash.cuh"

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kMaxHashFns = 5;

// v[0..NW) = the NW u32 words at p, of which `avail` exist (zeros past
// them). `vec` (warp-uniform): p is aligned to min(NW, 4) words, so whole
// tiles load as 16-, 8- or 4-byte vectors.
template <int NW>
__device__ __forceinline__ void load_words(const unsigned* __restrict__ p,
                                           long long avail, bool vec,
                                           unsigned (&v)[NW]) {
    if (vec && avail >= NW) {
        if constexpr (NW >= 4) {
#pragma unroll
            for (int c = 0; c < NW / 4; ++c) {
                const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + c);
                v[4 * c] = q.x;
                v[4 * c + 1] = q.y;
                v[4 * c + 2] = q.z;
                v[4 * c + 3] = q.w;
            }
        } else if constexpr (NW == 2) {
            const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
            v[0] = q.x;
            v[1] = q.y;
        } else {
            v[0] = __ldg(p);
        }
    } else {
#pragma unroll
        for (int r = 0; r < NW; ++r) v[r] = r < avail ? __ldg(p + r) : 0u;
    }
}

// Adds to lane k's cnt[r] the number of the warp's lanes whose v[r] has
// bit k set, for the words that hold any of the first `nbits` bits
// (warp-uniform; a bit past them lands in a lane the caller ignores).
// Each word is a 32 x 32 bit matrix, row i in lane i; five shuffle stages
// transpose it (stage j swaps the j x j blocks off the diagonal between
// lanes i and i ^ j), so lane k ends with column k and counts it with one
// popcount. (One ballot a bit took 4x the card time at the gate's shape.)
// A stage takes the partner's word whole and rotates it so that the
// half-blocks it gives land in the half-blocks this lane does not keep
// (j up in the lower lane, j down in the upper): the shuffle, a funnel
// shift and one three-input logic op.
template <int NW>
__device__ __forceinline__ void warp_count(const unsigned (&v)[NW], int nbits,
                                           int lane, int (&cnt)[NW]) {
#pragma unroll
    for (int r = 0; r < NW; ++r) {
        if (nbits > 32 * r) {  // uniform
            unsigned x = v[r];
#pragma unroll
            for (int j = 16; j > 0; j >>= 1) {
                // the bits of each j-block's first half
                const unsigned m = j == 16  ? 0x0000FFFFu
                                   : j == 8 ? 0x00FF00FFu
                                   : j == 4 ? 0x0F0F0F0Fu
                                   : j == 2 ? 0x33333333u
                                            : 0x55555555u;
                const bool up = lane & j;
                const unsigned keep = up ? ~m : m;
                const unsigned y = __shfl_xor_sync(kFullMask, x, j);
                const unsigned z = __funnelshift_l(y, y, up ? 32 - j : j);
                x = (x & keep) | (z & ~keep);
            }
            cnt[r] += __popc(x);
        }
    }
}

// Adds to cnt (lane k's cnt[r]: bit 32 r + k of the tile) the read's first
// nvalid hashes (at hrow) whose h rows
//   ganon_ibf_row(x, s, bin_size, shift) + off,  s < h,
// all have the bit set in the NW-word tile at word w0 of the table's rows
// (W32 words each). nbits: the tile's bits that count (warp-uniform).
template <int NW>
__device__ __forceinline__ void count_rows(
    const unsigned* __restrict__ tbl, long long W32, bool vec, long long w0,
    const long long* __restrict__ hrow, int nvalid,
    unsigned long long bin_size, int shift, unsigned long long off, int h,
    int nbits, int lane, int (&cnt)[NW]) {
    for (int m0 = 0; m0 < nvalid; m0 += 32) {
        unsigned v[NW];
        if (m0 + lane < nvalid) {
            const unsigned long long x = (unsigned long long)hrow[m0 + lane];
            const unsigned* row =
                tbl + (ganon_ibf_row(x, 0, bin_size, shift) + off) * W32;
            load_words<NW>(row + w0, W32 - w0, vec, v);
            for (int s = 1; s < h; ++s) {
                row = tbl + (ganon_ibf_row(x, s, bin_size, shift) + off) * W32;
                unsigned u[NW];
                load_words<NW>(row + w0, W32 - w0, vec, u);
#pragma unroll
                for (int r = 0; r < NW; ++r) v[r] &= u[r];
            }
        } else {
#pragma unroll
            for (int r = 0; r < NW; ++r) v[r] = 0u;
        }
        warp_count<NW>(v, nbits, lane, cnt);
    }
}

// Whether whole NW-word tiles of a table with rows of W32 words at tbl
// can be read as vectors (load_words' `vec`).
template <int NW>
inline bool rows_vectorizable(const void* tbl, long long W32) {
    constexpr int vw = NW < 4 ? NW : 4;
    return W32 % vw == 0 && reinterpret_cast<uintptr_t>(tbl) % (4 * vw) == 0;
}
