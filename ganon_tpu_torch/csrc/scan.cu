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
// Both are one launch over a grid of blocks as a single-pass chained
// scan (scan.cuh: decoupled look-back, Merrill and Garland, 2016). A
// block draws its run of 256 reads from the tile counter, scans their
// counts in the block, publishes its aggregate as a status word, and
// takes its exclusive prefix from its predecessors' words with
// chained_prefix (one warp reads 32 of them at a time; an inclusive
// prefix ends the walk).
//
// ragged's block scans its reads' min(max(n_matches, 0), K). Each thread
// then copies its read's valid entries and winners (contiguous in both
// buffers) to consecutive stream slots: a read holds a few, so one
// thread's loop is short where a warp's would wait on 32 reads in turn.
// It writes the read's w1, w2 and extra rows, the block copies a stripe
// of the tail, and the block of the batch's last read zeroes the stream
// slots from min(total, C) to C, and the winners block's. So every
// output word is written once and the caller need not clear it. (The
// earlier design, one block walking the batch, then a fill kernel, on a
// zeroed output, took 0.086 ms a call at 8192 pairs and K 32 against
// torch.cumsum's 0.046; NVIDIA H100 80GB HBM3, 700.00 W.)
//
// pairs's block counts each read's live slots (S <= 8: the row's bytes
// as one 1-, 2-, 4- or 8-byte load where S and the alignment allow, and
// its nonzero bytes counted with a mask and a popcount), scans the
// counts, and writes each read's live row the same way, with the read's
// overflow byte: the input's, ORed with the spill. It reads its inputs
// and writes its two outputs once, so a call is one device operation
// (the earlier design, one block of 1024 threads walking the batch in
// chunks on a copy of the overflow flags, took 0.045 ms a call at 8192
// reads, S 2, against torch.cumsum's 0.035; NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// The status words (the tile counter, then a word a block) live in a
// buffer the caller keeps for each (device, stream) pair
// (kernels.scan_status), which ragged, pairs and extract.cu's segmented
// scan share and nothing else writes. The buffer is zero when it is made
// and grows to the largest grid asked for; every call tags its words
// with an epoch never passed before for that buffer, so a word of an
// earlier call, of whichever kernel, reads as not yet published, and the
// block that draws the last tile sets the counter back to 0, so no clear
// is needed between calls. Calls on one stream run in order, so no
// call's words are overwritten while it runs, whichever kernel made
// them; calls for several mesh shards on views of one card share the
// card's stream and so run in order as well; a call on another stream
// has a buffer of its own.
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace ganon_scan;

constexpr int kRaggedReads = 256;  // reads (and threads) a ragged block
constexpr int kPairsReads = 256;   // reads (and threads) a pairs block

__global__ void __launch_bounds__(kRaggedReads)
ragged_kernel(const int* __restrict__ dense, long long B, int K, int has_win,
              int n_extra, long long tail, long long C,
              unsigned long long* status, unsigned long long epoch,
              int* __restrict__ out) {
    __shared__ long long warp_sums[32];
    __shared__ unsigned s_tile;
    __shared__ long long s_excl;
    const int t = threadIdx.x;
    draw_tile(status, &s_tile);
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
    const long long excl =
        chain_publish(status + 1, tile, tile == 0, total, epoch, &s_excl);
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

// 0x80 in each byte of x that is nonzero, 0 in the others
__device__ __forceinline__ unsigned long long nonzero_bytes(
        unsigned long long x) {
    const unsigned long long lo7 = 0x7F7F7F7F7F7F7F7FULL;
    return (((x & lo7) + lo7) | x) & ~lo7;
}

// A read's S <= 8 slot bytes as one little-endian word: one load of 1,
// 2, 4 or 8 bytes when `wide` (S is one of those and the rows aligned),
// else S byte loads.
__device__ __forceinline__ unsigned long long load_slots(
        const unsigned char* p, int S, bool wide) {
    if (wide) {
        switch (S) {
            case 1: return *p;
            case 2: return *(const unsigned short*)p;
            case 4: return *(const unsigned*)p;
            default: return *(const unsigned long long*)p;
        }
    }
    unsigned long long x = 0;
    for (int s = 0; s < S; ++s) x |= (unsigned long long)p[s] << (8 * s);
    return x;
}

__device__ __forceinline__ void store_slots(unsigned char* p, int S,
                                            bool wide, unsigned long long x) {
    if (wide) {
        switch (S) {
            case 1: *p = (unsigned char)x; return;
            case 2: *(unsigned short*)p = (unsigned short)x; return;
            case 4: *(unsigned*)p = (unsigned)x; return;
            default: *(unsigned long long*)p = x; return;
        }
    }
    for (int s = 0; s < S; ++s) p[s] = (unsigned char)(x >> (8 * s));
}

__global__ void __launch_bounds__(kPairsReads)
pairs_kernel(const unsigned char* __restrict__ slot_ok, long long B, int S,
             bool wide, long long P, const unsigned char* __restrict__ ovf_in,
             unsigned long long* status, unsigned long long epoch,
             unsigned char* __restrict__ live,
             unsigned char* __restrict__ ovf_out) {
    __shared__ long long warp_sums[32];
    __shared__ unsigned s_tile;
    __shared__ long long s_excl;
    draw_tile(status, &s_tile);
    __syncthreads();
    const long long tile = s_tile;
    const long long b = tile * kPairsReads + threadIdx.x;
    const bool mine = b < B;
    // the read's live slots: a word's nonzero bytes (S <= 8), else bytes
    unsigned long long okm = 0;
    int cnt = 0;
    if (mine) {
        if (S <= 8) {
            okm = nonzero_bytes(load_slots(slot_ok + b * S, S, wide));
            cnt = __popcll(okm);
        } else {
            for (int s = 0; s < S; ++s) cnt += slot_ok[b * S + s] != 0;
        }
    }
    long long total;
    const long long local = block_scan(cnt, warp_sums, &total);
    const long long base =
        chain_publish(status + 1, tile, tile == 0, total, epoch, &s_excl)
        + local;
    if (!mine) return;
    // the read's first `room` live slots stay live (positions below P)
    const long long room = P - base;
    if (S <= 8) {
        unsigned long long lv = 0;
        long long j = 0;
        for (int s = 0; s < S; ++s) {
            const unsigned long long ok = (okm >> (8 * s + 7)) & 1;
            lv |= (ok & (unsigned long long)(j < room)) << (8 * s);
            j += (long long)ok;
        }
        store_slots(live + b * S, S, wide, lv);
    } else {
        long long j = 0;
        for (int s = 0; s < S; ++s) {
            const bool ok = slot_ok[b * S + s] != 0;
            live[b * S + s] = ok && j < room;
            j += ok;
        }
    }
    ovf_out[b] = ovf_in[b] != 0 || (cnt > 0 && base + cnt > P);
}

}  // namespace

// status: int64 [1 + ceil(B / 256)] (the tile counter, 0 between calls,
// then a word a block), zero when made and then written only by the
// chained scans (scan.cuh); epoch in 1 .. 2^31 - 1, never passed before
// with this buffer; B * K below 2^31.
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

// status and epoch as for ganon_ragged, [1 + ceil(B / 256)] words;
// live and ovf_out are written whole (ovf_in is only read).
extern "C" int ganon_pairs(const void* slot_ok, long long B, int S,
                           long long P, const void* ovf_in, void* status,
                           unsigned long long epoch, void* live,
                           void* ovf_out, void* stream) {
    if (S < 1 || P < 0 || epoch < 1 || epoch >= (1ull << 31))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    const bool wide = (S == 1 || S == 2 || S == 4 || S == 8)
                      && (size_t)slot_ok % S == 0 && (size_t)live % S == 0;
    const long long blocks = (B + kPairsReads - 1) / kPairsReads;
    pairs_kernel<<<(unsigned)blocks, kPairsReads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)slot_ok, B, S, wide, P,
        (const unsigned char*)ovf_in, (unsigned long long*)status, epoch,
        (unsigned char*)live, (unsigned char*)ovf_out);
    return (int)cudaGetLastError();
}
