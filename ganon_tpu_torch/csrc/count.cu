// count: compacted minimizers -> per-target hit counts, clamped.
//
// Replaces the JAX device programs
//   ganon_tpu/ops/ibf_query.py:65 ibf_row_indices (+ :52 _mulhi64)  (K4),
//   ganon_tpu/ops/ibf_query.py:320 bulk_target_counts_u8, :277 _u32,
//     :355 _segment_matmul (via :397 bulk_target_counts_packed), and the
//     clamp of ganon_tpu/classify/device.py:120 classify_counts_fused /
//     :87 filter_counts_u8                                            (K5).
//
// counts[b, t] = min(n[b], sum over the read's first min(n[b], M) hashes
// of popcount(AND_s tbl[row_s(hash), bytes of target t])).
//
// What bounds it on the H100: device memory. Each valid hash gathers h
// table rows of W8 bytes from a table far larger than L2 (a 1024-target
// filter packs to 1 KB rows), so a batch moves about
// B x hashes x h x W8 bytes; arithmetic per byte is an AND and a popcount.
//
// Design: one block per read. The block hashes its minimizers into
// shared memory (u64 multiply and __umul64hi on the card, no limbs), then
// walks the table row in tiles of TILE_WORDS u32 words: consecutive
// threads read consecutive words of the same row, so every gather is a
// coalesced row segment. Per-byte counts of the tile stay in shared
// memory (4 bytes per table byte: a whole row would pass the 227 KB
// limit near 58k targets, hence the tiles). Targets are contiguous byte
// ranges in ascending order, so after each tile the threads sum the byte
// ranges of the targets that intersect it (found by binary search) and
// add into the read's output row; the last tile of a target clamps it.
// The block owns its output row, so no atomics are needed; the segment
// sum the TPU ran as a one-hot matmul is a short loop here.
//
// Forest mode (K11, ganon_tpu/classify/device.py:432
// classify_batch_packed_forest): the output row is ``counts + b * ldc +
// col0``, so each sub-IBF of a forest counts straight into its own column
// range of one shared [B, ldc] matrix (a flat filter passes ldc = T,
// col0 = 0). The caller zeroes the matrix: tiles add into the row.
#include <cuda_runtime.h>

#include <cstdint>

#include "ibf_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 2048;  // 8 KB of table bytes per tile
constexpr int kHashChunk = 128;   // hashes whose rows sit in shared memory
constexpr int kMaxH = 5;

__global__ void __launch_bounds__(kThreads)
count_kernel(const unsigned* __restrict__ tbl, long long W32,
             const int* __restrict__ byte_starts,
             const int* __restrict__ byte_ends, int T,
             const long long* __restrict__ hashes, int M,
             const int* __restrict__ n_hashes, unsigned long long bin_size,
             int h, int shift, int* __restrict__ counts, long long ldc,
             int col0) {
    __shared__ int cnt[kTileWords * 4];
    __shared__ unsigned long long rows[kHashChunk * kMaxH];
    __shared__ int t_first;

    const long long b = blockIdx.x;
    const int n = n_hashes[b];
    const int nvalid = min(n, M);
    const long long* hrow = hashes + b * M;
    int* orow = counts + b * ldc + col0;

    for (long long w0 = 0; w0 < W32; w0 += kTileWords) {
        const int tw = (int)min((long long)kTileWords, W32 - w0);
        for (int j = threadIdx.x; j < tw * 4; j += blockDim.x) cnt[j] = 0;
        for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
            const int mn = min(kHashChunk, nvalid - m0);
            __syncthreads();  // readers of the previous chunk's rows are done
            for (int q = threadIdx.x; q < mn * h; q += blockDim.x) {
                const int m = q / h, s = q - m * h;
                rows[q] = ganon_ibf_row(
                    (unsigned long long)hrow[m0 + m], s, bin_size, shift);
            }
            __syncthreads();
            // each thread owns its words' four byte counters: no races
            for (int j = threadIdx.x; j < tw; j += blockDim.x) {
                int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
                for (int m = 0; m < mn; ++m) {
                    const unsigned long long* r = rows + m * h;
                    unsigned v = tbl[(long long)r[0] * W32 + w0 + j];
                    for (int s = 1; s < h; ++s)
                        v &= tbl[(long long)r[s] * W32 + w0 + j];
                    c0 += __popc(v & 0x000000FFu);
                    c1 += __popc(v & 0x0000FF00u);
                    c2 += __popc(v & 0x00FF0000u);
                    c3 += __popc(v & 0xFF000000u);
                }
                cnt[4 * j] += c0;
                cnt[4 * j + 1] += c1;
                cnt[4 * j + 2] += c2;
                cnt[4 * j + 3] += c3;
            }
        }
        const long long lo = w0 * 4, hi = lo + (long long)tw * 4;
        if (threadIdx.x == 0) {  // first target whose range ends past lo
            int a = 0, z = T;
            while (a < z) {
                const int mid = (a + z) >> 1;
                if (byte_ends[mid] > lo) z = mid; else a = mid + 1;
            }
            t_first = a;
        }
        __syncthreads();
        for (int t = t_first + threadIdx.x; t < T; t += blockDim.x) {
            const long long s0 = byte_starts[t], e0 = byte_ends[t];
            if (s0 >= hi) break;  // ranges ascend: no later target intersects
            const long long x0 = s0 > lo ? s0 : lo;
            const long long x1 = e0 < hi ? e0 : hi;
            int acc = 0;
            for (long long x = x0; x < x1; ++x) acc += cnt[x - lo];
            int v = orow[t] + acc;
            if (e0 <= hi) v = min(v, n);  // the target's last tile
            orow[t] = v;
        }
        __syncthreads();  // before the next tile clears cnt
    }
}

}  // namespace

extern "C" int ganon_count(const void* tbl, long long R, long long W8,
                           const void* byte_starts, const void* byte_ends,
                           int T, const void* hashes, long long B, int M,
                           const void* n_hashes, unsigned long long bin_size,
                           int h, int shift, void* counts, long long ldc,
                           int col0, void* stream) {
    (void)R;
    if (h < 1 || h > kMaxH || W8 % 4 || col0 < 0 || col0 + (long long)T > ldc)
        return (int)cudaErrorInvalidValue;
    count_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)tbl, W8 / 4, (const int*)byte_starts,
        (const int*)byte_ends, T, (const long long*)hashes, M,
        (const int*)n_hashes, bin_size, h, shift, (int*)counts, ldc, col0);
    return (int)cudaGetLastError();
}
