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
// (M of them, 8 in and 8 out); a bitonic network of N = 2^ceil(log2 M)
// keys takes log2 N (log2 N + 1) / 2 compare-exchange stages (21 at the
// main path's M = 56, N = 64), a few microseconds of issue for 8192 reads
// and less than the launch.
//
// Design. The keys of a read live in registers, key r of lane l at
// position base + 32 r + l (a warp's tile of 32 K keys, K of them a lane,
// padded with the largest key past M): each lane loads its slots' hashes
// with coalesced 8-byte loads (whatever n, so they do not wait for it)
// and computes row0 with the table's fastrange (ibf_hash.cuh). A stage
// of distance j < 32 exchanges keys between lanes l and l ^ j by
// __shfl_xor_sync; a stage of j >= 32 is a compare in the lane's own
// registers (keys r and r ^ j / 32); every stage's distance is a
// compile-time constant, so the keys never leave registers. Each output
// slot takes the hash at the slot its key carries in the low 16 bits (a
// load that hits the lines just read).
// While N <= 256 (M <= 256) a warp sorts a read, kWarps reads a block,
// with no shared memory and no block barrier. Past it (up to kMaxM) a
// block of N / 256 warps sorts a read: each warp sorts its tile of 256
// keys in registers (neighbouring tiles in opposite directions), and only
// the stages of distance 256 and more, which cross tiles, go through
// shared memory with a __syncthreads each, the keys back in registers for
// the stages below 256 of every merge.
#include <cuda_runtime.h>

#include "ibf_hash.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kWarps = 8;           // reads a block on the warp route
constexpr int kWarpKeys = 8;        // keys a lane: the warp route to 256
constexpr int kTileKeys = 32 * kWarpKeys;
constexpr int kMaxM = 4096;
constexpr u64 kPast = 1ULL << 62;   // keys of slots past n
constexpr unsigned kFull = 0xFFFFFFFFu;

// The key of slot i of a read of n hashes in M slots (the largest past M);
// the hash is loaded whatever n, so the load does not wait for n's.
__device__ __forceinline__ u64 probe_key(const long long* __restrict__ row,
                                         int i, const int* __restrict__ np,
                                         int M, u64 bin_size, int shift) {
    if (i >= M) return ~0ULL;
    const u64 h = (u64)__ldg(row + i);
    const int n = min(max(__ldg(np), 0), M);
    return i < n ? (ganon_ibf_row(h, 0, bin_size, shift) << 16) | (u64)i
                 : kPast | (u64)i;
}

// Stage (k, J) of the bitonic network on a warp's K keys a lane: the key at
// position i = base + 32 r + lane meets the one at i ^ J; the lower of the
// two takes the smaller where i & k is 0 (an ascending run), the larger
// elsewhere.
template <int K, int J>
__device__ __forceinline__ void stage(u64 (&key)[K], int base, int lane,
                                      int k) {
    if constexpr (J >= 32) {
        constexpr int d = J / 32;
#pragma unroll
        for (int r = 0; r < K; ++r) {
            if (r & d) continue;
            const bool up = ((base + 32 * r + lane) & k) == 0;
            const u64 a = key[r], c = key[r | d];
            if ((a > c) == up) {
                key[r] = c;
                key[r | d] = a;
            }
        }
    } else {
        const bool lower = (lane & J) == 0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
            // the lower of an ascending pair (or the upper of a
            // descending one) keeps the smaller key
            const bool up = ((base + 32 * r + lane) & k) == 0;
            const bool keep_min = lower == up;
            const u64 p = __shfl_xor_sync(kFull, key[r], J);
            if ((p < key[r]) == keep_min) key[r] = p;
        }
    }
}

// The stages J, J / 2, ..., 1 of merge k.
template <int K, int J>
__device__ __forceinline__ void stages(u64 (&key)[K], int base, int lane,
                                       int k) {
    stage<K, J>(key, base, lane, k);
    if constexpr (J > 1) stages<K, J / 2>(key, base, lane, k);
}

// The merges KK, 2 KK, ..., 32 K of a warp's tile: sorted ascending where
// position base has bit 32 K clear, descending where it is set.
template <int K, int KK = 2>
__device__ __forceinline__ void sort_tile(u64 (&key)[K], int base, int lane) {
    stages<K, KK / 2>(key, base, lane, KK);
    if constexpr (KK < 32 * K) sort_tile<K, KK * 2>(key, base, lane);
}

// A warp a read: N = 32 K keys, kWarps reads a block.
template <int K>
__global__ void __launch_bounds__(32 * kWarps)
probe_sort_warp_kernel(const long long* __restrict__ hashes, long long B,
                       int M, const int* __restrict__ n_hashes, u64 bin_size,
                       int shift, long long* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp
    const long long* row = hashes + b * M;
    u64 key[K];
#pragma unroll
    for (int r = 0; r < K; ++r)
        key[r] = probe_key(row, 32 * r + lane, n_hashes + b, M, bin_size,
                           shift);
    sort_tile<K>(key, 0, lane);
#pragma unroll
    for (int r = 0; r < K; ++r) {
        const int i = 32 * r + lane;
        if (i < M) out[b * M + i] = row[key[r] & 0xFFFF];
    }
}

// A block of N / kTileKeys warps a read (N > kTileKeys): tiles sorted in
// registers, the stages that cross tiles in shared memory.
__global__ void __launch_bounds__(kMaxM / kWarpKeys)
probe_sort_block_kernel(const long long* __restrict__ hashes, int M, int N,
                        const int* __restrict__ n_hashes, u64 bin_size,
                        int shift, long long* __restrict__ out) {
    __shared__ u64 keys[kMaxM];
    const int lane = threadIdx.x & 31;
    const int base = (threadIdx.x >> 5) * kTileKeys;
    const long long b = blockIdx.x;
    const long long* row = hashes + b * M;
    u64 key[kWarpKeys];
#pragma unroll
    for (int r = 0; r < kWarpKeys; ++r)
        key[r] = probe_key(row, base + 32 * r + lane, n_hashes + b, M,
                           bin_size, shift);
    sort_tile<kWarpKeys>(key, base, lane);
    for (int k = 2 * kTileKeys; k <= N; k <<= 1) {
#pragma unroll
        for (int r = 0; r < kWarpKeys; ++r)
            keys[base + 32 * r + lane] = key[r];
        __syncthreads();
        for (int j = k >> 1; j >= kTileKeys; j >>= 1) {
            for (int p = threadIdx.x; p < N / 2; p += blockDim.x) {
                const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
                const u64 a = keys[i], c = keys[i | j];
                if ((a > c) == ((i & k) == 0)) {
                    keys[i] = c;
                    keys[i | j] = a;
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int r = 0; r < kWarpKeys; ++r)
            key[r] = keys[base + 32 * r + lane];
        stages<kWarpKeys, kTileKeys / 2>(key, base, lane, k);
    }
#pragma unroll
    for (int r = 0; r < kWarpKeys; ++r) {
        const int i = base + 32 * r + lane;
        if (i < M) out[b * M + i] = row[key[r] & 0xFFFF];
    }
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
    cudaStream_t st = (cudaStream_t)stream;
    const long long* h = (const long long*)hashes;
    const int* nh = (const int*)n_hashes;
    long long* o = (long long*)out;
    int N = 32;
    while (N < M) N <<= 1;
    if (N > kTileKeys) {
        if (B > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        probe_sort_block_kernel<<<(unsigned)B, N / kWarpKeys, 0, st>>>(
            h, M, N, nh, bin_size, shift, o);
        return (int)cudaGetLastError();
    }
    const long long blocks = (B + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    const unsigned g = (unsigned)blocks, t = 32 * kWarps;
    switch (N / 32) {
        case 1:
            probe_sort_warp_kernel<1><<<g, t, 0, st>>>(h, B, M, nh, bin_size,
                                                       shift, o);
            break;
        case 2:
            probe_sort_warp_kernel<2><<<g, t, 0, st>>>(h, B, M, nh, bin_size,
                                                       shift, o);
            break;
        case 4:
            probe_sort_warp_kernel<4><<<g, t, 0, st>>>(h, B, M, nh, bin_size,
                                                       shift, o);
            break;
        default:
            probe_sort_warp_kernel<8><<<g, t, 0, st>>>(h, B, M, nh, bin_size,
                                                       shift, o);
    }
    return (int)cudaGetLastError();
}
