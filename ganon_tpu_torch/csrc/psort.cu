// probe_sort: each read's compacted hashes reordered by their first hash
// function's table row.
//
// Replaces the sort_probes branch of the JAX device program
// ganon_tpu/classify/device.py:375-410 classify_batch_packed (a branch of
// K5): lax.sort of every read's hashes keyed by ibf_row_indices(...)[...,
// 0], the mask riding along, before the packed count. The count sums over
// the hash axis, so the order changes which rows the gather touches
// next to each other and never the counts.
//
// Order: the read's first min(n, M) hashes (the ones count reads) by the
// key (row0 << 16) | slot, ascending, then the slots past them in slot
// order; keys are unique, so any sort gives this order and the plain
// version's torch.sort(stable=True) gives the same. JAX's unstable sort
// interleaves the masked slots and may order equal rows otherwise; the
// counts, and so the result buffer, are the same.
//
// What bounds it on the H100: neither. A read moves 16 bytes per hash
// (M of them, 8 in and 8 out) and a bitonic network does M log^2 M
// compares in shared memory, a few microseconds of launch per batch.
//
// Design: one block per read. Its keys (row0 computed here with the
// table's fastrange, ibf_hash.cuh) fill a power-of-two array in shared
// memory, padded with the largest key; a bitonic network sorts it; each
// output slot takes the hash at the slot its key carries in the low 16
// bits. M is at most kMaxM (32 KB of keys).
#include <cuda_runtime.h>

#include "ibf_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 4096;
constexpr unsigned long long kPast = 1ULL << 62;  // keys of slots past n

__global__ void __launch_bounds__(kThreads)
probe_sort_kernel(const long long* __restrict__ hashes, int M, int N,
                  const int* __restrict__ n_hashes,
                  unsigned long long bin_size, int shift,
                  long long* __restrict__ out) {
    __shared__ unsigned long long keys[kMaxM];
    const long long b = blockIdx.x;
    const long long* row = hashes + b * M;
    const int n = min(max(n_hashes[b], 0), M);
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
        unsigned long long key = ~0ULL;
        if (i < n)
            key = (ganon_ibf_row((unsigned long long)row[i], 0, bin_size,
                                 shift) << 16) | (unsigned long long)i;
        else if (i < M)
            key = kPast | (unsigned long long)i;
        keys[i] = key;
    }
    __syncthreads();
    for (int k = 2; k <= N; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < N; i += blockDim.x) {
                const int ixj = i ^ j;
                if (ixj > i) {
                    const unsigned long long a = keys[i], c = keys[ixj];
                    if ((a > c) == ((i & k) == 0)) {
                        keys[i] = c;
                        keys[ixj] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
    for (int i = threadIdx.x; i < M; i += blockDim.x)
        out[b * M + i] = row[keys[i] & 0xFFFF];
}

}  // namespace

extern "C" int ganon_probe_sort(const void* hashes, long long B, int M,
                                const void* n_hashes,
                                unsigned long long bin_size, int shift,
                                void* out, void* stream) {
    // row0 < bin_size must leave the key's top two bits clear
    if (M < 1 || M > kMaxM || bin_size == 0 || bin_size >> 46)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    int N = 1;
    while (N < M) N <<= 1;
    probe_sort_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const long long*)hashes, M, N, (const int*)n_hashes, bin_size, shift,
        (long long*)out);
    return (int)cudaGetLastError();
}
