// extract: 2-bit packed reads -> canonical minimizers, compacted per read.
//
// Replaces the JAX device programs
//   ganon_tpu/classify/device.py:235 _unpack_batch_input, :162 unpack_codes_2bit (K1),
//   ganon_tpu/ops/minimizers.py:245 minimizers_masked_jax via
//     ganon_tpu/classify/device.py:57 extract_hashes (K2),
//   ganon_tpu/ops/ibf_query.py:411 compact_hashes (K3),
// in single-end mode with a capacity of every window position, the
// build's ganon_tpu/index/builder.py:156 _extract_packed (K8), and in
// single-end mode the ops library's ganon_tpu/ops/minimizers.py:134
// minimizers_jax (K18a).
//
// Semantics (seqan3 minimiser view): canonical k-mer = min(fwd ^ seed,
// rc ^ seed) with seed = adjust_seed(k); a window of w-k+1 k-mers emits
// its minimum when the window's LEFTMOST argmin position changes (ties
// keep the older position, as minimizers.py:239-241 takes the left side
// on <=). Mate 2 follows mate 1 in the output; a read whose mate 1 is
// shorter than w yields nothing; mate 2 counts when len2 >= w. n counts
// every emission, those past mc too, and overflow = n > mc; the slots
// past min(n, mc) are zeroed unless the caller asks not to (zero_tail 0:
// the build, which reads only the first n of each row).
//
// What bounds it on the H100: integer operations. A window position
// costs some 40 INT32 operations here (a k-mer value from a 64-bit
// funnel load: bit reverse, pair swap, complement, two XORs and a 64-bit
// min; the argmin's prefix and suffix minima and their merge; the emit
// flag), against a few bytes of input and one int64 an emission out; the
// card issues 64 INT32 lanes an SM a clock (16.7 T/s at 1.98 GHz). The
// zero tail, where it is written, is bytes: [B, mc] int64.
//
// Design: many threads on one sequence, in tiles of 512 windows of one
// mate of one read (a build piece, a long-read segment), every lane on
// the same path.
// - A block draws its tile from the tile counter (scan.cuh). Tiles are
//   numbered read by read, mate 1's before mate 2's, in order along the
//   mate, so every shape takes one route: a 150 bp mate is one tile, a
//   2048-base build piece 4, a 2^20-base ultra-long read 2048 (so 64 such
//   reads fill the card 8 times over).
// - The block loads the tile's packed bytes, with a halo of w - 1 bases
//   and one window before it, coalesced into shared memory (zero outside
//   the mate). Each thread then computes the canonical values of its
//   positions straight from the packed codes, with no serial roll: the 2k
//   bits at position p, read with one 64-bit funnel shift, are the
//   reverse complement's complement, and, their 2-bit groups reversed,
//   the forward value.
// - The leftmost argmin of every window by van Herk/Gil-Werman: the
//   positions are cut into segments of ww = w - k + 1; one thread a
//   segment writes its prefix and suffix argmins (ww compares each, the
//   same count for every lane, ties to the left); a window's argmin is
//   the better of its start's suffix argmin and its end's prefix argmin,
//   two loads and one compare whatever w is.
// - Window i emits when i == 0 or its argmin differs from window i - 1's
//   (the tile computes the window before its first for that). A thread
//   takes 4 consecutive windows; a block scan of their emit counts gives
//   each emission its place in a shared buffer, in window order.
// - The tile's first slot in its read's output: a segmented chained scan
//   over the tiles (scan.cuh). The read's first tile publishes its count
//   as inclusive at once; the others publish their aggregate and look
//   back with chained_prefix, which ends at the read's first tile at the
//   latest. Mate 2's tiles so start at mate 1's count.
// - The block writes its emissions as one contiguous run of slots
//   (consecutive threads, consecutive slots); the read's last tile writes
//   n and overflow.
// - The zero tail (unless zero_tail is 0): the slots from min(n, mc) to
//   mc of read r are cut into one stripe a tile of the read, and tile j
//   of read r + 1 (for the last read, one of Tr more tiles at the end of
//   the grid) zeroes stripe j with 16-byte stores, once read r's last
//   tile has published n in its inclusive word. A tile waits only on a
//   tile drawn before it, and no block carries a read's whole tail: with
//   the tail in the read's last tile, 64 ultra-long reads took 1.54 ms
//   against 0.61 ms without it (NVIDIA H100 80GB HBM3, 700.00 W).
// Shared memory a block: 8 bytes a position (values), 4 (two argmins),
// 8 a window (emissions) and the packed bytes: 10.6 KB at k 19, w 31.
// The earlier design here, one thread a read rolling the k-mers and
// rescanning its window when the minimum slid out, took 3.270 ms at the
// build's 16,384 pieces of 2048 bases and 0.358 ms at 8192 pairs of
// 150 bp (NVIDIA H100 80GB HBM3, 700.00 W): the lanes of a warp waited on
// whichever lane rescanned, and 64 ultra-long reads ran on 64 threads.
//
// Wide windows (ganon_extract_wide): a tile keeps a window's positions in
// shared memory, so past w - k + 1 of about 18,000 (k 19: w >= 18,104) a
// block would need more than the card's 227 KB. Those windows take that
// earlier walk instead, which keeps only the current minimum in
// registers and so has no bound on w: the k-mers rolled from the packed
// codes, the window rescanned from the codes when its minimum slides out
// (a few times a read on random sequence, w - k + 1 k-mers each), each
// emission written straight to its slot. One warp a read: its lanes walk
// the read together (the same state in each) and split each rescan into
// 32 runs whose minima meet by shuffles. One thread a read, as the walk
// first ran, made a warp wait through every rescan of its 32 reads in
// turn: 40.5 ms for 48 pairs of 20-40 kbp mates at w 18,104, where the
// plain version takes 7.0 (NVIDIA H100 80GB HBM3, 700.00 W). No status
// words: a read's slots are its warp's alone. The caller picks the route
// by shape before the launch (ops/ibf_query.py extract); nobody runs it
// at speed (the default w is 31).
#include <cuda_runtime.h>

#include "scan.cuh"

namespace {

using namespace ganon_scan;

constexpr int kThreads = 128;
constexpr int kPer = 4;                     // windows a thread
constexpr int kWindows = kThreads * kPer;   // windows a tile, 32 | kWindows

struct Params {
    unsigned long long kmask;  // low 2k bits
    unsigned long long seed;   // adjust_seed(k)
    int k, w, ww;
    int np_max;                // positions a tile: kWindows + ww
    int n_words;               // packed 64-bit words a tile
};

// Shared-memory layout of a tile (in 8-byte words, then bytes).
__host__ __device__ inline long long smem_bytes(int np_max, int n_words) {
    return 8ll * np_max + 8ll * kWindows + 8ll * n_words
           + ((4ll * np_max + 7) / 8) * 8;
}

__device__ __forceinline__ int load_le32(const unsigned char* p) {
    return (int)((unsigned)p[0] | ((unsigned)p[1] << 8) |
                 ((unsigned)p[2] << 16) | ((unsigned)p[3] << 24));
}

// The canonical value of the k-mer whose first base is base d of the
// packed words (2 bits a base, the first base in the low bits).
__device__ __forceinline__ unsigned long long kmer_value(
        const unsigned long long* words, int d, const Params& p) {
    const int wi = d >> 5, sh = (d & 31) << 1;
    const unsigned long long lo = words[wi], hi = words[wi + 1];
    const unsigned long long x = sh ? (lo >> sh) | (hi << (64 - sh)) : lo;
    // base i of the k-mer is 2-bit group i of x: the reverse complement
    // holds 3 - base i at group i, the forward value base i at k - 1 - i
    const unsigned long long rc = ~x & p.kmask;
    unsigned long long f = __brevll(x);
    f = ((f >> 1) & 0x5555555555555555ULL)
        | ((f & 0x5555555555555555ULL) << 1);
    const unsigned long long fwd = f >> (64 - 2 * p.k);
    const unsigned long long a = fwd ^ p.seed, b = rc ^ p.seed;
    return a < b ? a : b;
}

// out[s0 .. s1) = 0 by the block: 16-byte stores, 4 in flight a thread,
// between one 8-byte store at each end where the run is not 16-aligned.
__device__ __forceinline__ void zero_slots(long long* out, long long s0,
                                          long long s1) {
    if (s0 >= s1) return;
    const int t = threadIdx.x;
    long long a = s0 + (((size_t)(out + s0) & 15) ? 1 : 0);
    if (t == 0 && a > s0) out[s0] = 0;
    const long long nv = a < s1 ? (s1 - a) / 2 : 0;
    longlong2* v = (longlong2*)(out + a);
    const longlong2 z = make_longlong2(0, 0);
#pragma unroll 4
    for (long long i = t; i < nv; i += kThreads) v[i] = z;
    if (t == 0 && a + 2 * nv < s1) out[s1 - 1] = 0;
}

__global__ void __launch_bounds__(kThreads)
extract_kernel(const unsigned char* __restrict__ inbuf, long long B,
               long long row_bytes, int L1, int L2, int T1, int T2, int mc,
               Params p, int zero_tail, unsigned long long* status,
               unsigned long long epoch, long long* __restrict__ hashes,
               int* __restrict__ n_out, unsigned char* __restrict__ overflow) {
    extern __shared__ unsigned long long smem[];
    unsigned long long* vals = smem;                   // [np_max]
    unsigned long long* ebuf = vals + p.np_max;        // [kWindows]
    unsigned long long* words = ebuf + kWindows;       // [n_words]
    unsigned short* pre = (unsigned short*)(words + p.n_words);  // [np_max]
    unsigned short* suf = pre + p.np_max;                        // [np_max]
    __shared__ long long warp_sums[32];
    __shared__ unsigned s_tile;
    __shared__ long long s_excl, s_n;
    const int t = threadIdx.x;
    draw_tile(status, &s_tile);
    __syncthreads();
    const long long tile = s_tile;
    const int Tr = T1 + T2;
    if (tile < B * Tr) {  // a tile of windows (else only a zero stripe)
        const long long row = tile / Tr;
        const int j = (int)(tile - row * Tr);
        const bool mate2 = j >= T1;
        const int chunk = mate2 ? j - T1 : j;
        const unsigned char* rowp = inbuf + row * row_bytes;
        const int lens_at = L1 / 4 + L2 / 4;
        const int len1 = load_le32(rowp + lens_at);
        const int Lm = mate2 ? L2 : L1;
        const int len =
            min(mate2 ? load_le32(rowp + lens_at + 4) : len1, Lm);
        const unsigned char* codes = rowp + (mate2 ? L1 / 4 : 0);
        const int nwin = (len1 >= p.w && len >= p.w) ? len - p.w + 1 : 0;
        const int a = chunk * kWindows;          // the tile's first window
        const int nw = max(min(nwin - a, kWindows), 0);  // its windows
        const int ww = p.ww;

        // rel position r is absolute position a - 1 + r, whose first base
        // is base r + 31 of the shared words (they start at base a - 32)
        if (nw > 0) {
            const int np = nw + ww;  // positions of windows rel 0 .. nw
            const int nbytes = ((np + 30) / 32 + 2) * 8;
            unsigned char* wb = (unsigned char*)words;
            const long long g0 = a / 4 - 8;
            for (int i = t; i < nbytes; i += kThreads) {
                const long long g = g0 + i;
                wb[i] = (g >= 0 && g < Lm / 4) ? codes[g] : 0;
            }
            __syncthreads();
            for (int r = t; r < np; r += kThreads)
                vals[r] = kmer_value(words, r + 31, p);
            __syncthreads();
            // van Herk/Gil-Werman: prefix and suffix argmins of each
            // segment
            const int nseg = (np + ww - 1) / ww;
            for (int s = t; s < nseg; s += kThreads) {
                const int s0 = s * ww, s1 = min(s0 + ww, np);
                unsigned long long best = vals[s0];
                int bp = s0;
                pre[s0] = (unsigned short)s0;
                for (int r = s0 + 1; r < s1; ++r) {
                    const unsigned long long v = vals[r];
                    if (v < best) { best = v; bp = r; }
                    pre[r] = (unsigned short)bp;
                }
                best = vals[s1 - 1];
                bp = s1 - 1;
                suf[s1 - 1] = (unsigned short)bp;
                for (int r = s1 - 2; r >= s0; --r) {
                    const unsigned long long v = vals[r];
                    if (v <= best) { best = v; bp = r; }
                    suf[r] = (unsigned short)bp;
                }
            }
            __syncthreads();
        }
        // windows rel r0 .. r0 + kPer - 1 (absolute a + r - 1), and the
        // window before them
        const int r0 = 1 + kPer * t;
        int am[kPer + 1];
        unsigned flags = 0;
        int c = 0;
        if (r0 <= nw) {
#pragma unroll
            for (int q = 0; q <= kPer; ++q) {
                const int r = min(r0 - 1 + q, nw);
                const int x = suf[r], y = pre[r + ww - 1];
                am[q] = vals[x] <= vals[y] ? x : y;
            }
#pragma unroll
            for (int q = 0; q < kPer; ++q) {
                const int r = r0 + q;
                const bool e = r <= nw && (a + r == 1 || am[q + 1] != am[q]);
                flags |= (unsigned)e << q;
            }
            c = __popc(flags);
        }
        long long total;
        const long long local = block_scan(c, warp_sums, &total);
        if (flags) {
            int o = (int)local;
#pragma unroll
            for (int q = 0; q < kPer; ++q)
                if (flags >> q & 1) ebuf[o++] = vals[am[q + 1]];
        }
        const bool first = j == 0;
        const long long excl =
            chain_publish(status + 1, tile, first, total, epoch, &s_excl);
        long long* out = hashes + row * (long long)mc;
        const long long n_store = min(total, (long long)mc - excl);
        for (long long i = t; i < n_store; i += kThreads)
            out[excl + i] = (long long)ebuf[i];
        if (j == Tr - 1) {  // the read's last tile
            const long long n = excl + total;
            if (t == 0) {
                n_out[row] = (int)n;
                overflow[row] = n > mc;
            }
        }
    }
    // The zero tail of read tile / Tr - 1, a stripe of it a tile, by the
    // tiles of the next read (and the grid's last Tr tiles for the last
    // read): they drew their tiles after that read's last tile, so they
    // may wait for its inclusive word, which holds its n.
    if (zero_tail && tile >= Tr) {
        const long long r = tile / Tr - 1;
        const int jz = (int)(tile - (r + 1) * Tr);
        if (t == 0) {
            const volatile unsigned long long* st = status + 1;
            unsigned long long sw;
            while (((sw = st[r * Tr + Tr - 1]) >> kEpochShift) != epoch
                   || !(sw & kFlagInclusive))
                __nanosleep(32);
            s_n = (long long)(sw & kValueMask);
        }
        __syncthreads();
        const long long s0 = min(s_n, (long long)mc);
        const long long stripe = (mc - s0 + Tr - 1) / Tr;
        const long long z0 = min(s0 + jz * stripe, (long long)mc);
        zero_slots(hashes + r * (long long)mc, z0,
                   min(z0 + stripe, (long long)mc));
    }
}

bool tile_params(int L1, int L2, int k, int w, Params* p, int* T1, int* T2) {
    if (k < 1 || k > 32 || w < k || L1 < 0 || L2 < 0) return false;
    p->k = k;
    p->w = w;
    p->ww = w - k + 1;
    p->kmask = k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
    p->seed = 0x8F3F73B5CF1C9ADEULL >> (64 - 2 * k);
    p->np_max = kWindows + p->ww;
    p->n_words = (p->np_max + 30) / 32 + 2;
    if (p->np_max > 65535) return false;  // argmins are u16
    const int m1 = max(L1 - w + 1, 0), m2 = max(L2 - w + 1, 0);
    *T1 = max((m1 + kWindows - 1) / kWindows, 1);
    *T2 = L2 ? (m2 + kWindows - 1) / kWindows : 0;
    return true;
}

}  // namespace

extern "C" int ganon_set_device(int device) { return (int)cudaSetDevice(device); }

// Blocks of the extract kernel an SM holds at (k, w), or -1.
extern "C" int ganon_extract_blocks_per_sm(int k, int w) {
    Params p;
    int T1, T2;
    if (!tile_params(0, 0, k, w, &p, &T1, &T2)) return -1;
    const long long smem = smem_bytes(p.np_max, p.n_words);
    if (cudaFuncSetAttribute(extract_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
        return -1;
    int blocks = -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, extract_kernel, kThreads, (size_t)smem) != cudaSuccess)
        return -1;
    return blocks;
}

// status: int64 [1 + (B + zero_tail) * tiles a read] words of the chained
// scans' buffer (scan.cuh; tiles a read: ceil((L1 - w + 1) / 512), at
// least 1, plus ceil((L2 - w + 1) / 512)); epoch in 1 .. 2^31 - 1, never
// passed before with that buffer. hashes: int64 [B, mc], written only in its
// first min(n, mc) slots a row unless zero_tail.
extern "C" int ganon_extract(const void* inbuf, long long B, long long row_bytes,
                             int L1, int L2, int k, int w, int mc,
                             int zero_tail, void* status,
                             unsigned long long epoch, void* hashes,
                             void* n_hashes, void* overflow, void* stream) {
    Params p;
    int T1, T2;
    if (!tile_params(L1, L2, k, w, &p, &T1, &T2) || mc < 1 || epoch < 1
        || epoch >= (1ull << 31))
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    // a zero tail adds Tr tiles: stripes of the last read's tail
    const long long tiles = (B + (zero_tail ? 1 : 0)) * (T1 + T2);
    if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const long long smem = smem_bytes(p.np_max, p.n_words);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            extract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    extract_kernel<<<(unsigned)tiles, kThreads, (size_t)smem,
                     (cudaStream_t)stream>>>(
        (const unsigned char*)inbuf, B, row_bytes, L1, L2, T1, T2, mc, p,
        zero_tail, (unsigned long long*)status, epoch, (long long*)hashes,
        (int*)n_hashes, (unsigned char*)overflow);
    return (int)cudaGetLastError();
}

// --- wide windows: one warp a read -----------------------------------------

namespace {

__device__ __forceinline__ int base_at(const unsigned char* codes, int j) {
    return (codes[j >> 2] >> ((j & 3) << 1)) & 3;
}

struct Roll {
    unsigned long long kmask;  // low 2k bits
    unsigned long long seed;   // adjust_seed(k)
    int k;
    int rc_shift;              // 2 (k - 1)

    __device__ __forceinline__ void push(unsigned long long& fwd,
                                         unsigned long long& rc, int c) const {
        fwd = ((fwd << 2) | (unsigned long long)c) & kmask;
        rc = (rc >> 2) | ((unsigned long long)(3 - c) << rc_shift);
    }

    __device__ __forceinline__ unsigned long long canon(
        unsigned long long fwd, unsigned long long rc) const {
        const unsigned long long a = fwd ^ seed, b = rc ^ seed;
        return a < b ? a : b;
    }
};

// Leftmost minimum over the canonical values of k-mers [p0, p0 + ww), by
// the whole warp: each lane rolls its own contiguous run of positions,
// then the lanes' minima meet by shuffles (the lower position on ties).
// Every lane returns the same (minv, minp).
__device__ void rescan(const unsigned char* codes, int p0, int ww,
                       const Roll& r, unsigned long long& minv, int& minp) {
    const int lane = threadIdx.x & 31;
    const int per = (ww + 31) >> 5;
    const int q0 = min(lane * per, ww), q1 = min(q0 + per, ww);
    unsigned long long fwd = 0, rc = 0, v = ~0ULL;
    int pos = 0x7FFFFFFF;  // an empty run loses every comparison
    if (q0 < q1) {
        for (int j = 0; j < r.k - 1; ++j)
            r.push(fwd, rc, base_at(codes, p0 + q0 + j));
        for (int q = q0; q < q1; ++q) {
            r.push(fwd, rc, base_at(codes, p0 + q + r.k - 1));
            const unsigned long long c = r.canon(fwd, rc);
            if (pos == 0x7FFFFFFF || c < v) {
                v = c;
                pos = p0 + q;
            }
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long ov = __shfl_xor_sync(0xFFFFFFFFu, v, o);
        const int op = __shfl_xor_sync(0xFFFFFFFFu, pos, o);
        if (ov < v || (ov == v && op < pos)) {
            v = ov;
            pos = op;
        }
    }
    minv = v;
    minp = pos;
}

// One mate's emissions into out[slot...] (kept while slot < mc); returns
// the slot count after this mate. Every lane of the warp runs it with the
// same state; lane 0 writes.
__device__ long long mate_minimizers(const unsigned char* codes, int len,
                                     int w, const Roll& r, long long* out,
                                     long long slot, int mc) {
    if (len < w) return slot;
    const int ww = w - r.k + 1;
    const int nwin = len - w + 1;
    unsigned long long fwd = 0, rc = 0, minv = 0;
    int minp = -1;  // no minimum yet: window 0 scans its whole span
    // the k - 1 bases before the k-mer that enters window 0 (at ww - 1)
    for (int j = 0; j < r.k - 1; ++j)
        r.push(fwd, rc, base_at(codes, ww - 1 + j));
    for (int i = 0; i < nwin; ++i) {
        const int p = i + ww - 1;  // the k-mer entering window i
        r.push(fwd, rc, base_at(codes, p + r.k - 1));
        const unsigned long long v = r.canon(fwd, rc);
        bool emit = i == 0;
        if (minp < i) {  // the minimum slid out (or none yet)
            if (ww == 1) {
                minv = v;
                minp = p;
            } else {
                rescan(codes, i, ww, r, minv, minp);
            }
            emit = true;
        } else if (v < minv) {  // a strictly smaller value enters
            minv = v;
            minp = p;
            emit = true;
        }
        if (emit) {
            if (slot < mc && (threadIdx.x & 31) == 0)
                out[slot] = (long long)minv;
            ++slot;
        }
    }
    return slot;
}

constexpr int kWideWarps = 4;  // reads a block of the wide route

__global__ void __launch_bounds__(32 * kWideWarps)
extract_wide_kernel(const unsigned char* __restrict__ inbuf, long long B,
                    long long row_bytes, int L1, int L2, int w, int mc,
                    Roll r, long long* __restrict__ hashes,
                    int* __restrict__ n_out,
                    unsigned char* __restrict__ overflow) {
    const long long b =
        blockIdx.x * (long long)kWideWarps + (threadIdx.x >> 5);
    if (b >= B) return;  // the whole warp
    const unsigned char* row = inbuf + b * row_bytes;
    const int lens_at = L1 / 4 + L2 / 4;
    const int len1 = load_le32(row + lens_at);
    const int len2 = L2 ? load_le32(row + lens_at + 4) : 0;
    long long* out = hashes + b * (long long)mc;
    long long n = 0;
    if (len1 >= w) {
        n = mate_minimizers(row, min(len1, L1), w, r, out, 0, mc);
        if (L2)
            n = mate_minimizers(row + L1 / 4, min(len2, L2), w, r, out, n,
                                mc);
    }
    if ((threadIdx.x & 31) == 0) {
        n_out[b] = (int)n;
        overflow[b] = n > mc;
    }
}

}  // namespace

// The wide-window route: ganon_extract's outputs for any w >= k, without
// the status words. It writes only the first min(n, mc) slots of a row:
// the caller zeroes the hashes first where it wants the zero tail.
extern "C" int ganon_extract_wide(const void* inbuf, long long B,
                                  long long row_bytes, int L1, int L2, int k,
                                  int w, int mc, void* hashes,
                                  void* n_hashes, void* overflow,
                                  void* stream) {
    if (k < 1 || k > 32 || w < k || L1 < 0 || L2 < 0 || mc < 1)
        return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    Roll r;
    r.k = k;
    r.kmask = k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
    r.seed = 0x8F3F73B5CF1C9ADEULL >> (64 - 2 * k);
    r.rc_shift = 2 * (k - 1);
    const long long blocks = (B + kWideWarps - 1) / kWideWarps;
    extract_wide_kernel<<<(unsigned)blocks, 32 * kWideWarps, 0,
                          (cudaStream_t)stream>>>(
        (const unsigned char*)inbuf, B, row_bytes, L1, L2, w, mc, r,
        (long long*)hashes, (int*)n_hashes, (unsigned char*)overflow);
    return (int)cudaGetLastError();
}
