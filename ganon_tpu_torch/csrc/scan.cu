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
// the batch is a chain of dependent steps, so launch latency and the
// scan's serial depth decide the time.
//
// ragged's design: one launch over a grid of blocks as a single-pass
// chained scan (decoupled look-back, Merrill and Garland, 2016). A block
// draws its run of 256 reads from an atomic counter, scans their
// min(max(n_matches, 0), K) in the block, publishes its aggregate as a
// status word, and takes its exclusive prefix from its predecessors'
// words (one warp reads 32 of them at a time; an inclusive prefix ends
// the walk). Each thread then copies its read's valid entries and
// winners (contiguous in both buffers) to consecutive stream slots: a
// read holds a few, so one thread's loop is short where a warp's would
// wait on 32 reads in turn. It writes the read's w1, w2 and extra rows,
// the block copies a stripe of the tail, and the block of the batch's
// last read zeroes the stream slots from min(total, C) to C, and the
// winners block's. So every output word is written once and the caller
// need not clear it. (The earlier design here, one block walking the
// batch, then a fill kernel, on a zeroed output, took 0.086 ms a call
// at 8192 pairs and K 32 against torch.cumsum's 0.046; NVIDIA H100 80GB
// HBM3, 700.00 W.)
// The status words (the tile counter, then a word a block) live in a
// buffer the caller keeps for each (device, stream) pair and that only
// this kernel writes. The buffer is zero when it is made; every call
// tags its words with an epoch the caller has never passed before for
// that buffer, so a word of an earlier call reads as not yet published,
// and the block that draws the last tile sets the counter back to 0, so
// no clear is needed between calls. Calls on one stream run in order,
// so no call's words are overwritten while it runs; calls for several
// mesh shards on views of one card share the card's stream and so run
// in order as well; a call on another stream has a buffer of its own.
//
// pairs's design: one block of 1024 threads walks the batch in chunks of
// 1024 reads, a thread per read: warp shuffles and one shared array scan
// the chunk, and the carry passes to the next chunk.
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kRaggedReads = 256;  // reads (and threads) a ragged block

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

// A status word: epoch << 33 | flag << 31 | value, published when its
// epoch is the call's.
constexpr int kEpochShift = 33;
constexpr unsigned long long kFlagAggregate = 1ull << 31;
constexpr unsigned long long kFlagInclusive = 2ull << 31;
constexpr unsigned long long kValueMask = kFlagAggregate - 1;

// The exclusive prefix of block `tile` (> 0) of a chained scan whose
// blocks publish kFlagAggregate | their sum, then kFlagInclusive | their
// inclusive prefix, tagged with `epoch`: one warp (every lane gets the
// result) reads its predecessors' words 32 at a time, nearest first,
// waiting on a word not yet published; the nearest inclusive word ends
// the walk. A block's predecessors drew their tiles first and publish
// without waiting, so the walk always ends.
__device__ long long chained_prefix(const volatile unsigned long long* status,
                                    long long tile, unsigned long long epoch) {
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

__global__ void __launch_bounds__(kRaggedReads)
ragged_kernel(const int* __restrict__ dense, long long B, int K, int has_win,
              int n_extra, long long tail, long long C,
              unsigned long long* status, unsigned long long epoch,
              int* __restrict__ out) {
    __shared__ long long warp_sums[32];
    __shared__ unsigned s_tile;
    __shared__ long long s_excl;
    const int t = threadIdx.x;
    if (t == 0) {
        unsigned* counter = (unsigned*)status;
        s_tile = atomicAdd(counter, 1u);
        // every tile is drawn: the next call on the stream starts at 0
        if (s_tile == gridDim.x - 1) atomicExch(counter, 0u);
    }
    __syncthreads();
    const long long tile = s_tile;
    const long long b0 = tile * kRaggedReads;
    const int nb = (int)min((long long)kRaggedReads, B - b0);
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

    const long long b = b0 + t;
    const int c = t < nb ? min(max(nm[b], 0), K) : 0;
    long long total;
    const long long local = block_scan(c, warp_sums, &total);
    volatile unsigned long long* st = status + 1;
    const unsigned long long tag = epoch << kEpochShift;
    if (t < 32) {
        long long excl = 0;
        if (tile > 0) {
            if (t == 0)
                st[tile] = tag | kFlagAggregate | (unsigned long long)total;
            excl = chained_prefix(st, tile, epoch);
        }
        if (t == 0) {
            st[tile] = tag | kFlagInclusive
                       | (unsigned long long)(excl + total);
            s_excl = excl;
        }
    }
    __syncthreads();
    const long long excl = s_excl;
    if (t < nb) {
        w1[b] = (int)(((unsigned)maxc[b] << 16) | (unsigned)nm[b]);
        w2[b] = (int)(((unsigned)min(nh[b], 0x1FFFF) << 1)
                      | (unsigned)(ovf[b] & 1));
        for (int e = 0; e < n_extra; ++e)
            extra_dst[e * B + b] = extra[e * B + b];
        // the read's valid run (and its winners) to consecutive slots: a
        // read holds few valid entries, so its own thread copies them
        const long long row = b * K, p0 = excl + local;
        const int n_copy = (int)max(min((long long)c, C - p0), 0ll);
#pragma unroll 4
        for (int j = 0; j < n_copy; ++j) {
            out[p0 + j] = m[row + j];
            if (has_win) out[C + p0 + j] = win[row + j];
        }
    }
    for (long long i = tile * kRaggedReads + t; i < tail;
         i += (long long)gridDim.x * kRaggedReads)
        tail_dst[i] = tail_src[i];
    if (b0 + nb == B) {  // the batch's last read: unused slots read 0
        for (long long p = min(excl + total, C) + t; p < C; p += kRaggedReads) {
            out[p] = 0;
            if (has_win) out[C + p] = 0;
        }
    }
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

// status: int64 [1 + ceil(B / 256)] (the tile counter, 0 between calls,
// then a word a block), zero when made and then written only by this
// kernel; epoch:
// in 1 .. 2^31 - 1, never passed before with this buffer; B * K below
// 2^31.
extern "C" int ganon_ragged(const void* dense, long long B, int K,
                            int has_win, int n_extra, long long tail,
                            long long C, void* status,
                            unsigned long long epoch, void* out,
                            void* stream) {
    if (K < 1 || C < 1 || n_extra < 0 || tail < 0 || epoch < 1
        || epoch >= (1ull << 31) || B * K >= (1ll << 31))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const long long blocks = (B + kRaggedReads - 1) / kRaggedReads;
    ragged_kernel<<<(unsigned)blocks, kRaggedReads, 0, (cudaStream_t)stream>>>(
        (const int*)dense, B, K, has_win != 0, n_extra, tail, C,
        (unsigned long long*)status, epoch, (int*)out);
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
