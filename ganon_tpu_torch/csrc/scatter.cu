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

}  // namespace

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
