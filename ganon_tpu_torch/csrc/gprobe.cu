// gather_probe: the random row-gather rate into a small table.
//
// Replaces the repository's only Pallas kernel,
// scripts/pallas_gather_probe.py:28 pallas_count (pl.pallas_call at :56):
// tbl u8 [R, 32] (R = 131,072: 4 MB) viewed as u32 [R / 16, 128], rows
// int32 [N]; out int32 [1, 128], where each probe r adds the popcounts
// of row r's eight u32 words to lanes 8 (r & 15) .. 8 (r & 15) + 7, in
// int32 arithmetic that wraps, as the Pallas kernel's adds do. The TPU
// probe asked how fast a kernel can load dynamic rows from VMEM; the
// same question here is the card's rate of random 32-byte row loads from
// a table that stays in the 50 MB L2, which is what the count kernels'
// bound rests on.
//
// What bounds it on the H100: the gather. Each probe reads one 32-byte
// sector at a random row, served from L2 once the 4 MB table is there,
// and its row index (4 bytes, read once).
//
// The lane sums are a matrix product: out [16 groups x 8 words] =
// onehot(r & 15)^T [16 x N] @ popc [N x 8]. One-hot entries are 0/1 and
// popcounts at most 32, so both are 8-bit, and each 32 probes (a warp's
// step) are one mma.sync m16n8k32 with u8 inputs and an s32 accumulator
// (no .satfinite: the integer sums wrap). In the PTX fragment layout of
// that shape, lane (g, t) = (lane / 4, lane % 4) holds
//   A: one-hot rows g and g + 8 at probes 4t..4t+3 and 16+4t..16+4t+3
//      (4 registers of 4 bytes),
//   B: the popcounts of word g of the same 8 probes' rows (2 registers),
//   C: lanes 8g + 2t, 8g + 2t + 1, 8 (g + 8) + 2t, 8 (g + 8) + 2t + 1.
// So a lane loads its 8 probes' row indices as two 16-byte loads (the 8
// lanes sharing t read the same 16 bytes), gathers word g of each of
// their rows (the 8 lanes sharing t read one row's 32-byte sector
// together), and packs 8 popcounts and 4 one-hot words; the C tile stays
// in registers over all of the warp's steps. A probe past N takes row 0
// and a group byte (0x7X) that matches no group, so its one-hot column is
// zero and it adds nothing.
//
// Grid: at most one block of 32 warps an SM (the wrapper passes the SM
// count, the rows of the partials it allocates), a warp a step,
// grid-stride. A block adds its warps' C tiles in shared memory and
// stores one 128-int partial; the last block to finish adds the
// partials and stores out once. Its ticket comes from the chained scans'
// tile counter (kernels.scan_status, word 0) by scan.cuh
// draw_ticket_release, whose acq_rel atomic orders the block's partial
// before it and the last block's reads after it, and whose last drawer
// sets the counter back to 0, so the wrapper clears nothing. No atomic
// touches the sums and nothing is filled: one launch a call.
#include <cstdint>

#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

constexpr int kWarps = 32;  // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 128;
constexpr unsigned kPastN = 0x70u;  // a group byte that matches no group

// One step of a lane: the row indices of probes 4t..4t+3 (lo) and
// 16+4t..16+4t+3 (hi) of the step's 32, word g of each of their rows, and
// the bytes ORed into their groups (kPastN for a probe past N).
struct Step {
    uint4 lo, hi;
    unsigned w[8];
    unsigned pad_lo, pad_hi;
};

// The row indices of a step whose first probe is `base` (p0 = base + 4t);
// kVec: rows is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ void load_rows(Step& st,
                                          const int* __restrict__ rows,
                                          long long N, long long base,
                                          long long p0) {
    st.pad_lo = st.pad_hi = 0;
    if (base + 32 <= N) {
        if (kVec) {
            st.lo = __ldg(reinterpret_cast<const uint4*>(rows + p0));
            st.hi = __ldg(reinterpret_cast<const uint4*>(rows + p0 + 16));
        } else {
            st.lo = make_uint4(__ldg(rows + p0), __ldg(rows + p0 + 1),
                               __ldg(rows + p0 + 2), __ldg(rows + p0 + 3));
            st.hi = make_uint4(__ldg(rows + p0 + 16), __ldg(rows + p0 + 17),
                               __ldg(rows + p0 + 18), __ldg(rows + p0 + 19));
        }
        return;
    }
    // the step that holds N, or one past it
    unsigned v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const long long p = p0 + (i & 3) + (i >> 2) * 16;
        v[i] = p < N ? (unsigned)__ldg(rows + p) : 0u;
        if (p >= N) {
            if (i < 4) st.pad_lo |= kPastN << (8 * i);
            else st.pad_hi |= kPastN << (8 * (i - 4));
        }
    }
    st.lo = make_uint4(v[0], v[1], v[2], v[3]);
    st.hi = make_uint4(v[4], v[5], v[6], v[7]);
}

// Word g of each of the step's 8 rows (32 bytes a row: 8 words).
__device__ __forceinline__ void gather(Step& st,
                                       const unsigned* __restrict__ tbl,
                                       int g) {
    const unsigned r[8] = {st.lo.x, st.lo.y, st.lo.z, st.lo.w,
                           st.hi.x, st.hi.y, st.hi.z, st.hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
        st.w[i] = __ldg(tbl + 8 * (unsigned long long)r[i] + g);
}

// The group bytes (r & 15) of 4 row indices as one word.
__device__ __forceinline__ unsigned groups4(uint4 r) {
    return __byte_perm(__byte_perm(r.x, r.y, 0x0040),
                       __byte_perm(r.z, r.w, 0x0040), 0x5410)
           & 0x0F0F0F0Fu;
}

// Byte i is 1 where byte i of q equals that of gg, else 0 (every byte of
// q and gg at most 0x7F, so no add carries into the next byte).
__device__ __forceinline__ unsigned onehot4(unsigned q, unsigned gg) {
    return (~((q ^ gg) + 0x7F7F7F7Fu) >> 7) & 0x01010101u;
}

__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c,
                                          unsigned d) {
    return a | (b << 8) | (c << 16) | (d << 24);
}

// c += onehot^T @ popc over the step's 32 probes (one tensor-core tile).
__device__ __forceinline__ void mma_step(const Step& st, unsigned gg,
                                         unsigned gg8, int (&c)[4]) {
    const unsigned qlo = groups4(st.lo) | st.pad_lo;
    const unsigned qhi = groups4(st.hi) | st.pad_hi;
    const unsigned a0 = onehot4(qlo, gg), a1 = onehot4(qlo, gg8);
    const unsigned a2 = onehot4(qhi, gg), a3 = onehot4(qhi, gg8);
    const unsigned b0 = pack4(__popc(st.w[0]), __popc(st.w[1]),
                              __popc(st.w[2]), __popc(st.w[3]));
    const unsigned b1 = pack4(__popc(st.w[4]), __popc(st.w[5]),
                              __popc(st.w[6]), __popc(st.w[7]));
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gather_probe_kernel(const unsigned* __restrict__ tbl,
                    const int* __restrict__ rows, long long N,
                    int* __restrict__ partials,
                    unsigned long long* status, int* __restrict__ out) {
    __shared__ int4 tiles[kWarps][kLanes / 4];
    __shared__ unsigned s_ticket;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const unsigned gg = 0x01010101u * g, gg8 = 0x01010101u * (g + 8);
    const long long nsteps = (N + 31) >> 5;
    const long long W = (long long)gridDim.x * kWarps;
    int c[4] = {0, 0, 0, 0};
    for (long long s = (long long)blockIdx.x * kWarps + warp; s < nsteps;
         s += W) {
        Step st;
        load_rows<kVec>(st, rows, N, s * 32, s * 32 + 4 * t);
        gather(st, tbl, g);
        mma_step(st, gg, gg8, c);
    }
    // the block's sum of its warps' tiles: lanes 8g + 2t (+1) and
    // 64 + 8g + 2t (+1) of this warp
    int2* mine = reinterpret_cast<int2*>(tiles[warp]);
    mine[4 * g + t] = make_int2(c[0], c[1]);
    mine[32 + 4 * g + t] = make_int2(c[2], c[3]);
    __syncthreads();
    if (threadIdx.x < kLanes) {
        const int* col = reinterpret_cast<const int*>(tiles) + threadIdx.x;
        unsigned sum = 0;  // int32 adds that wrap
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += (unsigned)col[w * kLanes];
        partials[(long long)blockIdx.x * kLanes + threadIdx.x] = (int)sum;
    }
    __syncthreads();  // the block's partial before thread 0's release
    ganon_scan::draw_ticket_release(status, &s_ticket);
    __syncthreads();
    if (s_ticket != gridDim.x - 1) return;
    // the last block: every other partial is stored; warp w adds the
    // partials of blocks w, w + kWarps, ..., lane l their lanes 4l..4l+3
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll 4
    for (int b = warp; b < (int)gridDim.x; b += kWarps) {
        const int4 v = __ldcg(reinterpret_cast<const int4*>(partials)
                              + (long long)b * (kLanes / 4) + lane);
        acc.x += (unsigned)v.x;
        acc.y += (unsigned)v.y;
        acc.z += (unsigned)v.z;
        acc.w += (unsigned)v.w;
    }
    tiles[warp][lane] = make_int4((int)acc.x, (int)acc.y, (int)acc.z,
                                  (int)acc.w);
    __syncthreads();
    if (threadIdx.x < kLanes / 4) {
        uint4 sum = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int4 v = tiles[w][threadIdx.x];
            sum.x += (unsigned)v.x;
            sum.y += (unsigned)v.y;
            sum.z += (unsigned)v.z;
            sum.w += (unsigned)v.w;
        }
        reinterpret_cast<int4*>(out)[threadIdx.x] =
            make_int4((int)sum.x, (int)sum.y, (int)sum.z, (int)sum.w);
    }
}

}  // namespace

// tbl: u8 [R, 32] (4-byte aligned); rows: int32 [N]; partials: int32
// [max_blocks, 128] scratch; status: the stream's chained-scan status
// words (kernels.scan_status: only the counter is used); out: int32
// [1, 128], 16-byte aligned. max_blocks: the SM count. N = 0 launches
// one block, which stores zeros.
extern "C" int ganon_gather_probe(const void* tbl, long long R,
                                  const void* rows, long long N,
                                  void* partials, int max_blocks,
                                  void* status, void* out, void* stream) {
    if (R <= 0 || N < 0 || max_blocks < 1
        || reinterpret_cast<uintptr_t>(tbl) % 4
        || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    const long long steps = (N + 31) / 32;
    long long blocks = (steps + kWarps - 1) / kWarps;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    auto* launch = reinterpret_cast<uintptr_t>(rows) % 16
                       ? gather_probe_kernel<false>
                       : gather_probe_kernel<true>;
    launch<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)tbl, (const int*)rows, N, (int*)partials,
        (unsigned long long*)status, (int*)out);
    return (int)cudaGetLastError();
}
