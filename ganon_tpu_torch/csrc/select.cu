// select: per-target counts -> thresholds, top-K matches, tallies, packed.
//
// Replaces the JAX device programs
//   ganon_tpu/classify/device.py:801 threshold_topk            (K6),
//   ganon_tpu/classify/device.py:255 _pack_result, dense pack16 (K7),
// and, with the winners payload, the select step of
//   ganon_tpu/classify/device.py:542 classify_batch_packed_multi (K13).
//
// Per read (reference GanonClassify.cpp:719-758, in double as the JAX
// package computes it): cutoff = max(1, ceil(n * rel_cutoff)); the read is
// valid when 0 < n <= hashes_limit; kept = count >= cutoff; the rel-filter
// threshold is max - ceil((max - min) * rel_filter) with min =
// min(n, smallest kept count); final = kept & count >= threshold. The top
// K entries order by the key (count << 16) | (0xFFFF - target): final
// targets by descending count, ties on the lower index, then non-final
// targets by ascending index (their count reads 0), exactly the order of
// both JAX tiers (full sort, and iterative argmax at k <= 8, T >= 4096).
//
// Output, one int32 buffer (unpack_batch_result's dense layout):
//   [B*K] (count << 16 | target) | [B*K] winners (when uwin is given) |
//   [B] n_matches | [B] max_count |
//   [B] n_hashes | [B] overflow | [T] disc_t | [T] matches_t (optional) |
//   3 scalars (seqs_classified, kmers_from_classified, kmers_matches).
//
// What bounds it on the H100: reading the [B, T] counts (4 bytes per
// target per read) once per pass; a read has 1-2 matches at default
// cutoffs, so passes are few.
//
// Design: one block per read. Pass 1 reduces max/min of the kept counts,
// pass 2 counts final matches and adds the per-target tallies with
// atomics (the output is zeroed by the caller). The top entries come by
// min(K, n_matches) block-wide argmax passes, each taking the largest key
// below the previous one (keys are unique, so nothing is modified), and
// the remaining slots take the lowest-index non-final targets through a
// block prefix count. The read's row stays in L1/L2 between passes.
//
// Winners (multi-filter levels): uwin [B, T] holds the filter that won
// each union column (merge.cu); every entry of the top block, the
// zero-count padding entries included, carries uwin[b, target] in the
// winners block. JAX sorts the winners along as a payload of unique keys
// (device.py:886-893; the argmax tier takes them at the argmax,
// :874-884), so each entry's winner is that of its own target.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename Op>
__device__ unsigned block_reduce(unsigned v, Op op, unsigned* scratch) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch is free
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = scratch[0];
    for (int i = 1; i < kWarps; ++i) v = op(v, scratch[i]);
    return v;
}

struct MaxOp {
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a > b ? a : b; }
};
struct MinOp {
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a < b ? a : b; }
};
struct AddOp {
    __device__ unsigned operator()(unsigned a, unsigned b) const { return a + b; }
};

__global__ void __launch_bounds__(kThreads)
select_kernel(const int* __restrict__ counts, long long B, int T,
              const int* __restrict__ n_hashes,
              const unsigned char* __restrict__ overflow, double rel_cutoff,
              double rel_filter, long long hashes_limit, int K, int emit_mt,
              const int* __restrict__ uwin, int* __restrict__ out) {
    __shared__ unsigned scratch[kWarps];
    const long long b = blockIdx.x;
    const int* row = counts + b * T;
    const int n = n_hashes[b];
    const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
    const bool valid = n > 0 && (long long)n <= hashes_limit;

    // pass 1: max and min of the kept counts (counts are >= 0)
    unsigned mx = 0, mn = INT_MAX;
    if (valid) {
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c >= cutoff) {
                mx = max(mx, (unsigned)c);
                mn = min(mn, (unsigned)c);
            }
        }
    }
    mx = block_reduce(mx, MaxOp(), scratch);
    mn = block_reduce(mn, MinOp(), scratch);
    const int max_count = (int)mx;
    const int min_count = min(n, (int)mn);
    const int thr = (int)((double)max_count -
                          ceil((double)(max_count - min_count) * rel_filter));

    // the side arrays follow the matches (and the winners)
    const long long BK = B * (long long)K * (uwin ? 2 : 1);
    int* tallies = out + BK + 4 * B;  // disc_t, then matches_t
    // pass 2: final matches and per-target tallies
    unsigned nm = 0;
    if (valid) {
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c < cutoff) continue;
            if (c >= thr) {
                ++nm;
                if (emit_mt) atomicAdd(tallies + T + t, 1);
            } else {
                atomicAdd(tallies + t, 1);
            }
        }
    }
    nm = block_reduce(nm, AddOp(), scratch);
    const int n_matches = (int)nm;

    // top entries: the final targets by descending key
    int* mrow = out + b * K;
    int* wrow = uwin ? out + B * (long long)K + b * K : nullptr;
    const int* urow = uwin ? uwin + b * T : nullptr;
    const int kf = min(K, n_matches);
    unsigned long long prev = 1ULL << 32;  // above every 32-bit key
    for (int j = 0; j < kf; ++j) {
        unsigned best = 0;
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c >= cutoff && c >= thr) {  // valid holds: n_matches > 0
                const unsigned key = ((unsigned)c << 16) | (0xFFFFu - (unsigned)t);
                if ((unsigned long long)key < prev && key > best) best = key;
            }
        }
        best = block_reduce(best, MaxOp(), scratch);
        prev = best;
        if (threadIdx.x == 0) {
            const int t = (int)(0xFFFFu - (best & 0xFFFFu));
            mrow[j] = (int)((best & 0xFFFF0000u) | (unsigned)t);
            if (wrow) wrow[j] = urow[t];
        }
    }
    // remaining slots: non-final targets in ascending index order
    const int need = K - kf;
    int base = 0;
    for (int c0 = 0; c0 < T && base < need; c0 += blockDim.x) {
        const int t = c0 + threadIdx.x;
        bool nonfinal = false;
        if (t < T) {
            const int c = row[t];
            nonfinal = !(valid && c >= cutoff && c >= thr);
        }
        // block exclusive prefix count of nonfinal over this chunk
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, nonfinal);
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        const int in_warp = __popc(ballot & ((1u << lane) - 1u));
        __syncthreads();
        if (lane == 0) scratch[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, total = 0;
        for (int i = 0; i < kWarps; ++i) {
            if (i < warp) before += scratch[i];
            total += scratch[i];
        }
        const int rank = base + before + in_warp;
        if (nonfinal && rank < need) {
            mrow[kf + rank] = t;  // count 0 << 16
            if (wrow) wrow[kf + rank] = urow[t];
        }
        base += total;
    }

    if (threadIdx.x == 0) {
        out[BK + b] = n_matches;
        out[BK + B + b] = max_count;
        out[BK + 2 * B + b] = n;
        out[BK + 3 * B + b] = overflow[b];
        if (n_matches > 0) {
            int* scalars = tallies + (emit_mt ? 2 : 1) * (long long)T;
            atomicAdd(scalars, 1);
            atomicAdd(scalars + 1, n);
            atomicAdd(scalars + 2, max_count);
        }
    }
}

}  // namespace

extern "C" int ganon_select(const void* counts, long long B, int T,
                            const void* n_hashes, const void* overflow,
                            double rel_cutoff, double rel_filter,
                            long long hashes_limit, int K, int emit_matches_t,
                            const void* uwin, void* packed, void* stream) {
    select_kernel<<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)counts, B, T, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, (const int*)uwin, (int*)packed);
    return (int)cudaGetLastError();
}
