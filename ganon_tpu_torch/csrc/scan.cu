// scan: the ragged match stream and the pruned forest's pair compaction.
//
// Replaces two branches of the JAX device programs:
//   ganon_tpu/classify/device.py:280-309 _pack_result with match_cap > 0
//     (K7's ragged layout, used by every classify_batch_packed* program;
//     unpacked on the host by :656 unpack_batch_result_ragged)  (ragged),
//   ganon_tpu/classify/device.py:1199-1237 classify_batch_packed_pruned
//     with pair_cap > 0 (K14's (read, slot) pair compaction)   (pairs).
//
// ragged: select.cu's dense pack16 buffer
//   [B*K] (count << 16 | target) | [B*K] winners (has_win) | [B] n_matches |
//   [B] max_count | [B] n_hashes | [B] overflow | [B] x n_extra | tail
// becomes
//   [C] stream | [C] winners (has_win) | [B] w1 | [B] w2 | [B] x n_extra |
//   tail,
// where the stream holds the valid entries (k < n_matches) row by row,
// those past C dropped (the host sees sum(min(n_matches, K)) > C and
// re-dispatches), w1 = max_count << 16 | n_matches and w2 =
// min(n_hashes, 0x1FFFF) << 1 | overflow; the extra rows (the pruned
// group words) and the tail (tallies and the 3 scalars) are copied.
//
// pairs: slot_ok [B, S] read-major is the pair stream; a live slot's
// position is its exclusive prefix count over the batch; the slot stays
// live for the fine stage when its position is below the cap P, and a
// read whose pairs end past P (inclusive prefix of its slot count > P)
// with any slot live gets its overflow flag set, as JAX's
// `overflow | ((read_end > P) & (n_slots > 0))`. A pair past the cap so
// adds zero to its slot's counts, as JAX's dropped scatter does.
//
// What bounds it on the H100: neither. Both move a few bytes per read
// (B x K entries of which most are empty; B x S flags); the scan over
// the batch is a chain of dependent steps, so launch latency and one
// block's pass over the batch decide the time.
//
// Design: one block of 1024 threads walks the batch in chunks of 1024
// reads, a thread per read: warp shuffles and one shared array scan the
// chunk, and the carry passes to the next chunk. pairs finishes inside
// that block; ragged writes each read's offset and a second, grid-wide
// kernel scatters the entries and copies the rest (the output is zeroed
// by the caller, so dropped and unused stream slots read 0).
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;

// Exclusive prefix of v over the block; *total gets the block's sum.
__device__ long long block_scan(long long v, long long* warp_sums,
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

__global__ void __launch_bounds__(kScanThreads)
ragged_scan_kernel(const int* __restrict__ nm, long long B, int K,
                   long long* __restrict__ offs) {
    __shared__ long long warp_sums[32];
    long long carry = 0;
    for (long long b0 = 0; b0 < B; b0 += blockDim.x) {
        const long long b = b0 + threadIdx.x;
        const long long v = b < B ? min(max(nm[b], 0), K) : 0;
        long long total;
        const long long excl = block_scan(v, warp_sums, &total);
        if (b < B) offs[b] = carry + excl;
        carry += total;
    }
}

__global__ void ragged_fill_kernel(const int* __restrict__ dense,
                                   long long B, int K, int has_win,
                                   int n_extra, long long tail, long long C,
                                   const long long* __restrict__ offs,
                                   int* __restrict__ out) {
    const long long BK = B * K;
    const int* m = dense;
    const int* win = dense + BK;
    const int* nm = dense + BK * (1 + has_win);
    const int* maxc = nm + B;
    const int* nh = nm + 2 * B;
    const int* ovf = nm + 3 * B;
    const int* extra = nm + 4 * B;
    const int* tail_src = nm + (4 + n_extra) * B;
    int* w1 = out + C * (1 + has_win);
    int* w2 = w1 + B;
    int* extra_dst = w1 + 2 * B;
    int* tail_dst = w1 + (2 + n_extra) * B;
    const long long step = (long long)gridDim.x * blockDim.x;
    const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long i = i0; i < BK; i += step) {
        const long long b = i / K;
        const int j = (int)(i - b * K);
        if (j >= nm[b]) continue;
        const long long p = offs[b] + j;
        if (p >= C) continue;
        out[p] = m[i];
        if (has_win) out[C + p] = win[i];
    }
    for (long long b = i0; b < B; b += step) {
        w1[b] = (int)(((unsigned)maxc[b] << 16) | (unsigned)nm[b]);
        w2[b] = (int)(((unsigned)min(nh[b], 0x1FFFF) << 1)
                      | (unsigned)(ovf[b] & 1));
    }
    for (long long i = i0; i < n_extra * B; i += step) extra_dst[i] = extra[i];
    for (long long i = i0; i < tail; i += step) tail_dst[i] = tail_src[i];
}

__global__ void __launch_bounds__(kScanThreads)
pairs_kernel(const unsigned char* __restrict__ slot_ok, long long B, int S,
             long long P, unsigned char* __restrict__ live,
             unsigned char* __restrict__ overflow) {
    __shared__ long long warp_sums[32];
    long long carry = 0;
    for (long long b0 = 0; b0 < B; b0 += blockDim.x) {
        const long long b = b0 + threadIdx.x;
        int cnt = 0;
        if (b < B)
            for (int s = 0; s < S; ++s) cnt += slot_ok[b * S + s] != 0;
        long long total;
        const long long base = carry + block_scan(cnt, warp_sums, &total);
        if (b < B) {
            long long pos = base;
            for (int s = 0; s < S; ++s) {
                const bool ok = slot_ok[b * S + s] != 0;
                live[b * S + s] = ok && pos < P;
                pos += ok;
            }
            if (cnt > 0 && base + cnt > P) overflow[b] = 1;
        }
        carry += total;
    }
}

}  // namespace

extern "C" int ganon_ragged(const void* dense, long long B, int K,
                            int has_win, int n_extra, long long tail,
                            long long C, void* offs, void* out,
                            void* stream) {
    if (K < 1 || C < 1 || n_extra < 0 || tail < 0)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const long long BK = B * K;
    const int* nm = (const int*)dense + BK * (1 + (has_win != 0));
    ragged_scan_kernel<<<1, kScanThreads, 0, st>>>(nm, B, K,
                                                   (long long*)offs);
    long long work = BK > tail ? BK : tail;
    long long blocks = (work + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    if (blocks < 1) blocks = 1;
    ragged_fill_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        (const int*)dense, B, K, has_win != 0, n_extra, tail, C,
        (const long long*)offs, (int*)out);
    return (int)cudaGetLastError();
}

extern "C" int ganon_pairs(const void* slot_ok, long long B, int S,
                           long long P, void* live, void* overflow,
                           void* stream) {
    if (S < 1 || P < 0) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    pairs_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)slot_ok, B, S, P, (unsigned char*)live,
        (unsigned char*)overflow);
    return (int)cudaGetLastError();
}
