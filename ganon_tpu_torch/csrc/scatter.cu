// scatter: (minimizer, technical bin) pairs -> bits ORed into the IBF.
//
// Replaces the JAX device program ganon_tpu/index/ibf.py:231
// _scatter_chunk_jit.step (K9, driven by ibf.py:291 scatter_hashes_device):
// every pair sets bit (bin & 31) of word row_s * W + (bin >> 5) for each
// hash function s, with row_s from the shared IBF hash family.
//
// What bounds it on the H100: scattered 4-byte read-modify-writes into a
// bit-matrix of hundreds of MB, h per pair; atomic throughput in L2 and
// device memory, not arithmetic.
//
// Design: one thread per pair, atomicOr into the u32 word. OR is
// idempotent and commutative, so duplicates need no sort and no dedup —
// the JAX program sorted and deduplicated (ops/bigsort.py columnsort)
// only because XLA scatters by ADD. The matrix is updated in place.
//
// Pruned mode (K16: ganon_tpu/index/pruned.py:283 _pruned_scatter_jit
// .step, driven by :337 _device_scatter_table): the pruned forest's fine
// table has a bin size per group, so each pair names a parameter set p
// (grp[i], or set 0 when grp is NULL) of [P] arrays (bin_size, shift =
// clz64(bin_size), row_off) and a bit column; it sets bit `bit` of row
// ganon_ibf_row(x, s, bin_size[p], shift[p]) + row_off[p] for each hash
// function s. The fine table passes one set per group and the lane in the
// group; the coarse table one set of all its rows and the group as the
// bit. Rows are u32 words of the little-endian byte table (row bytes
// padded to x4), so bit c of a row is bit c & 31 of word c >> 5. One
// thread per pair, atomicOr: no sort, no dedup.
//
// Ranked mode (K10: ganon_tpu/index/device_build.py:185 scatter_sorted with
// :237 _entry_coords and :279 _scatter_span): the build's sorted entries
// (file key, value) carry their first-occurrence flag and their rank among
// the group's distinct entries (dedup.cu). A distinct entry of file f at
// rank r has index idx = r - key_start[f] + offset[f] in its target's
// file-concatenated order and lands in technical bin bin_base[f] + idx /
// max(nhb[f], 1) (the reference's index-range split, GanonBuild.cpp:
// 619-653); duplicates are skipped, since OR is idempotent. params holds
// int32 [4, R]: bin_base, nhb, offset, key_start per file. The JAX u8
// lane-major plane and its row-range chunks were TPU tiling workarounds;
// here the bit-matrix lives on the card whole and each entry ORs h bits.
//
// Span mode (K17: ganon_tpu/index/device_build.py:308-367
// make_scatter_mesh, whose shard bodies run :279 _scatter_span): bits is
// one shard's row range of the row-major matrix, the word span [w0, w0 +
// R_rows * W). A bit whose word falls outside the span is dropped, before
// the span as well as past it (JAX clamps the negative offsets onto its
// drop sentinel at :288-289, since its scatter wraps them); the rest are
// rebased by w0 and ORed. The whole matrix is the span w0 = 0, R_rows =
// bin_size, so the one kernel serves both modes.
#include <cuda_runtime.h>

#include <cstdint>

#include "ibf_hash.cuh"

namespace {

__global__ void scatter_kernel(unsigned* __restrict__ bits, long long W,
                               const long long* __restrict__ hashes,
                               const int* __restrict__ bins, long long N,
                               unsigned long long bin_size, int h, int shift) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= N) return;
    const unsigned long long x = (unsigned long long)hashes[i];
    const int bin = bins[i];
    const unsigned mask = 1u << (bin & 31);
    const long long word = bin >> 5;
    for (int s = 0; s < h; ++s) {
        const unsigned long long row = ganon_ibf_row(x, s, bin_size, shift);
        atomicOr(bits + (long long)row * W + word, mask);
    }
}

__global__ void scatter_pruned_kernel(unsigned* __restrict__ bits, long long W,
                                      const long long* __restrict__ hashes,
                                      const int* __restrict__ grp,
                                      const int* __restrict__ bit, long long N,
                                      const long long* __restrict__ bin_size,
                                      const int* __restrict__ shift,
                                      const long long* __restrict__ row_off,
                                      int h) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= N) return;
    const int p = grp ? grp[i] : 0;
    const unsigned long long x = (unsigned long long)hashes[i];
    const unsigned long long bsz = (unsigned long long)bin_size[p];
    const int sh = shift[p];
    const long long off = row_off[p];
    const int c = bit[i];
    const unsigned mask = 1u << (c & 31);
    const long long word = c >> 5;
    for (int s = 0; s < h; ++s) {
        const long long row = (long long)ganon_ibf_row(x, s, bsz, sh) + off;
        atomicOr(bits + row * W + word, mask);
    }
}

__global__ void scatter_ranked_kernel(unsigned* __restrict__ bits, long long W,
                                      const int* __restrict__ key,
                                      const long long* __restrict__ val,
                                      const int* __restrict__ uniq,
                                      const int* __restrict__ rank,
                                      long long N,
                                      const int* __restrict__ params, int R,
                                      unsigned long long bin_size, int h,
                                      int shift, long long w0,
                                      long long span) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= N || !uniq[i]) return;
    const int f = key[i];
    const long long idx = (long long)rank[i] - params[3 * R + f] + params[2 * R + f];
    const long long bin = params[f] + idx / max(params[R + f], 1);
    const unsigned long long x = (unsigned long long)val[i];
    const unsigned mask = 1u << (bin & 31);
    const long long word = bin >> 5;
    for (int s = 0; s < h; ++s) {
        const unsigned long long row = ganon_ibf_row(x, s, bin_size, shift);
        const long long at = (long long)row * W + word - w0;
        if (at >= 0 && at < span) atomicOr(bits + at, mask);
    }
}

}  // namespace

extern "C" int ganon_scatter_ranked(void* bits, long long R_rows, long long W,
                                    const void* key, const void* val,
                                    const void* uniq, const void* rank,
                                    long long N, const void* params, int R,
                                    unsigned long long bin_size, int h,
                                    int shift, long long w0, void* stream) {
    if (h < 1 || h > 5 || w0 < 0) return (int)cudaErrorInvalidValue;
    if (N <= 0) return (int)cudaGetLastError();
    const int threads = 256;
    const long long blocks = (N + threads - 1) / threads;
    scatter_ranked_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (unsigned*)bits, W, (const int*)key, (const long long*)val,
        (const int*)uniq, (const int*)rank, N, (const int*)params, R,
        bin_size, h, shift, w0, R_rows * W);
    return (int)cudaGetLastError();
}

extern "C" int ganon_scatter_pruned(void* bits, long long R, long long W,
                                    const void* hashes, const void* grp,
                                    const void* bit, long long N,
                                    const void* bin_size, const void* shift,
                                    const void* row_off, int h, void* stream) {
    (void)R;
    if (h < 1 || h > 5) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (N + threads - 1) / threads;
    scatter_pruned_kernel<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (unsigned*)bits, W, (const long long*)hashes, (const int*)grp,
        (const int*)bit, N, (const long long*)bin_size, (const int*)shift,
        (const long long*)row_off, h);
    return (int)cudaGetLastError();
}

extern "C" int ganon_scatter(void* bits, long long R, long long W,
                             const void* hashes, const void* bins, long long N,
                             unsigned long long bin_size, int h, int shift,
                             void* stream) {
    (void)R;
    const int threads = 256;
    const long long blocks = (N + threads - 1) / threads;
    scatter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (unsigned*)bits, W, (const long long*)hashes, (const int*)bins, N,
        bin_size, h, shift);
    return (int)cudaGetLastError();
}
