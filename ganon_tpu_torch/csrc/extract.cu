// extract: 2-bit packed reads -> canonical minimizers, compacted per read.
//
// Replaces the JAX device programs
//   ganon_tpu/classify/device.py:235 _unpack_batch_input, :162 unpack_codes_2bit (K1),
//   ganon_tpu/ops/minimizers.py:245 minimizers_masked_jax via
//     ganon_tpu/classify/device.py:57 extract_hashes (K2),
//   ganon_tpu/ops/ibf_query.py:411 compact_hashes (K3),
// and, in single-end mode with a capacity of every window position, the
// build's ganon_tpu/index/builder.py:156 _extract_packed (K8).
//
// Semantics (seqan3 minimiser view): canonical k-mer = min(fwd ^ seed,
// rc ^ seed) with seed = adjust_seed(k); a window of w-k+1 k-mers emits
// its minimum when the window's LEFTMOST argmin position changes (ties
// keep the older position, as minimizers.py:239-241 takes the left side
// on <=). Mate 2 follows mate 1 in the output; a read whose mate 1 is
// shorter than w yields nothing; mate 2 counts when len2 >= w.
//
// What bounds it on the H100: nothing in memory. Input is 38 bytes per
// 150 bp mate and output a few dozen u64 per read, so the kernel is
// latency bound on the sequential scan per read (the TPU program
// vectorised it with O(log w) doubling passes over [B, L] u64 arrays).
//
// Design: one thread per read walks mate 1 then mate 2 once, rolling the
// forward and reverse-complement k-mer values in registers. It keeps only
// the current minimum (value, position); when the minimum slides out of
// the window it recomputes the window's w bases from the packed codes
// (about once per w-k+1 windows on random sequence), so no per-thread
// ring buffer and no bound on w. Emissions go straight to their
// compacted slot, which removes the JAX sort-based stable partition.
// The build passes many short pieces so every SM has threads to run.
#include <cuda_runtime.h>

#include <cstdint>

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

// Leftmost minimum over the canonical values of k-mers [p0, p0 + ww).
__device__ void rescan(const unsigned char* codes, int p0, int ww,
                       const Roll& r, unsigned long long& minv, int& minp) {
    unsigned long long fwd = 0, rc = 0;
    for (int j = 0; j < r.k - 1; ++j) r.push(fwd, rc, base_at(codes, p0 + j));
    minp = -1;
    for (int q = 0; q < ww; ++q) {
        r.push(fwd, rc, base_at(codes, p0 + q + r.k - 1));
        const unsigned long long v = r.canon(fwd, rc);
        if (minp < 0 || v < minv) {
            minv = v;
            minp = p0 + q;
        }
    }
}

// One mate's emissions into out[slot...] (kept while slot < mc); returns
// the slot count after this mate.
__device__ int mate_minimizers(const unsigned char* codes, int len, int w,
                               const Roll& r, long long* out, int slot,
                               int mc) {
    if (len < w) return slot;
    const int ww = w - r.k + 1;
    const int nwin = len - w + 1;
    unsigned long long fwd = 0, rc = 0, minv = 0;
    int minp = -1;
    for (int j = 0; j < r.k - 1; ++j) r.push(fwd, rc, base_at(codes, j));
    for (int p = 0; p < ww - 1; ++p) {
        r.push(fwd, rc, base_at(codes, p + r.k - 1));
        const unsigned long long v = r.canon(fwd, rc);
        if (minp < 0 || v < minv) {
            minv = v;
            minp = p;
        }
    }
    for (int i = 0; i < nwin; ++i) {
        const int p = i + ww - 1;  // k-mer entering window i
        r.push(fwd, rc, base_at(codes, p + r.k - 1));
        const unsigned long long v = r.canon(fwd, rc);
        bool emit = i == 0;
        if (minp < i) {  // the minimum slid out (or none yet when ww == 1)
            if (ww == 1) {
                minv = v;
                minp = p;
            } else {
                rescan(codes, i, ww, r, minv, minp);
            }
            emit = true;
        } else if (v < minv) {  // strictly smaller enters
            minv = v;
            minp = p;
            emit = true;
        }
        if (emit) {
            if (slot < mc) out[slot] = (long long)minv;
            ++slot;
        }
    }
    return slot;
}

__device__ __forceinline__ int load_le32(const unsigned char* p) {
    return (int)((unsigned)p[0] | ((unsigned)p[1] << 8) |
                 ((unsigned)p[2] << 16) | ((unsigned)p[3] << 24));
}

__global__ void extract_kernel(const unsigned char* __restrict__ inbuf,
                               long long B, long long row_bytes, int L1,
                               int L2, int w, int mc, Roll r,
                               long long* __restrict__ hashes,
                               int* __restrict__ n_out,
                               unsigned char* __restrict__ overflow) {
    const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (b >= B) return;
    const unsigned char* row = inbuf + b * row_bytes;
    const int lens_at = L1 / 4 + L2 / 4;
    const int len1 = load_le32(row + lens_at);
    const int len2 = L2 ? load_le32(row + lens_at + 4) : 0;
    long long* out = hashes + b * mc;
    int n = 0;
    if (len1 >= w) {
        n = mate_minimizers(row, min(len1, L1), w, r, out, 0, mc);
        if (L2) n = mate_minimizers(row + L1 / 4, min(len2, L2), w, r, out, n, mc);
    }
    for (int s = min(n, mc); s < mc; ++s) out[s] = 0;
    n_out[b] = n;
    overflow[b] = n > mc;
}

}  // namespace

extern "C" int ganon_set_device(int device) { return (int)cudaSetDevice(device); }

extern "C" int ganon_extract(const void* inbuf, long long B, long long row_bytes,
                             int L1, int L2, int k, int w, int mc,
                             void* hashes, void* n_hashes, void* overflow,
                             void* stream) {
    Roll r;
    r.k = k;
    r.kmask = k == 32 ? ~0ULL : ((1ULL << (2 * k)) - 1);
    r.seed = 0x8F3F73B5CF1C9ADEULL >> (64 - 2 * k);
    r.rc_shift = 2 * (k - 1);
    const int threads = 128;
    const long long blocks = (B + threads - 1) / threads;
    extract_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const unsigned char*)inbuf, B, row_bytes, L1, L2, w, mc, r,
        (long long*)hashes, (int*)n_hashes, (unsigned char*)overflow);
    return (int)cudaGetLastError();
}
