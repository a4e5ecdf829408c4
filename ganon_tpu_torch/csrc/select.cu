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
//
// 32-bit mode (K6/K7's 32-bit branch: ganon_tpu/classify/device.py:801
// threshold_topk with sort16=False, lax.top_k over the int32 counts, and
// :255 _pack_result without pack16; the layout --longreads and filters of
// more than 65,535 targets need): the key is the 64-bit
// (count << 32) | (0xFFFFFFFF - target), so the order stays descending
// count, then ascending id (lax.top_k takes the lower index on ties), and
// the top block becomes two blocks, [B*K] counts | [B*K] target ids,
// before the same side arrays. No winners and no lanes: JAX pairs
// neither with 32 bits (device.py:902, :1147).
//
// Lanes mode (K14: ganon_tpu/classify/device.py:1309 threshold_topk_ids
// with tallies=False, the lane ids, group tallies and group words of
// :1119 classify_batch_packed_pruned, :1255-1306): the columns are the
// pruned forest's C = S * gs lanes (slot s = c / gs, lane j = c % gs of
// the group gsel[b, s]). A lane is live when its slot is and j is below
// the group's target count; dead lanes never count as kept, and after the
// final lanes and the live non-final lanes (ascending) the top block is
// filled with the sentinel lane C (count 0). Tallies go to the global
// target gsel * gs + j of the [T] arrays, and ceil(S/2) group words per
// read (gsel[2i] | gsel[2i+1] << 16, 0xFFFF for a dead or missing slot)
// follow the [B] overflow block, one [B] row per word.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 32;

// V is unsigned or unsigned long long (the 32-bit mode's argmax keys)
template <typename V, typename Op>
__device__ V block_reduce(V v, Op op, unsigned long long* scratch) {
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // scratch is free
    if (lane == 0) scratch[warp] = v;
    __syncthreads();
    v = (V)scratch[0];
    for (int i = 1; i < kWarps; ++i) v = op(v, (V)scratch[i]);
    return v;
}

struct MaxOp {
    template <typename V>
    __device__ V operator()(V a, V b) const { return a > b ? a : b; }
};
struct MinOp {
    template <typename V>
    __device__ V operator()(V a, V b) const { return a < b ? a : b; }
};
struct AddOp {
    template <typename V>
    __device__ V operator()(V a, V b) const { return a + b; }
};

// The pruned forest's lanes (NULL gsel: flat mode, every column is live).
struct Lanes {
    const int* gsel;                 // [B, S] chosen groups
    const unsigned char* slot_ok;    // [B, S]
    const int* grp_ntargets;         // [G]
    int S, gs, n_extra;
    int T;                           // tally width: the forest's targets
};

// Wide: the 32-bit mode (64-bit keys, counts and ids in two blocks)
template <bool Wide>
__global__ void __launch_bounds__(kThreads)
select_kernel(const int* __restrict__ counts, long long B, int T,
              const int* __restrict__ n_hashes,
              const unsigned char* __restrict__ overflow, double rel_cutoff,
              double rel_filter, long long hashes_limit, int K, int emit_mt,
              const int* __restrict__ uwin, int* __restrict__ out,
              Lanes ln) {
    using Key = typename std::conditional<Wide, unsigned long long,
                                          unsigned>::type;
    constexpr int kIdBits = Wide ? 32 : 16;
    constexpr Key kIdMask = Wide ? 0xFFFFFFFFull : 0xFFFFu;
    __shared__ unsigned long long scratch[kWarps];
    __shared__ int s_grp[kMaxS];  // the slot's group, -1 when dead
    __shared__ int s_nt[kMaxS];   // live lanes of the slot
    const long long b = blockIdx.x;
    const int* row = counts + b * T;
    const int n = n_hashes[b];
    const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
    const bool valid = n > 0 && (long long)n <= hashes_limit;
    const bool lanes = ln.gsel != nullptr;
    if (lanes) {
        if (threadIdx.x < ln.S) {
            const long long i = b * ln.S + threadIdx.x;
            const bool ok = ln.slot_ok[i] != 0;
            s_grp[threadIdx.x] = ok ? ln.gsel[i] : -1;
            s_nt[threadIdx.x] = ok ? ln.grp_ntargets[ln.gsel[i]] : 0;
        }
        __syncthreads();
    }
    auto live = [&](int t) -> bool {
        if (!lanes) return true;
        const int s = t / ln.gs;
        return t - s * ln.gs < s_nt[s];
    };

    // pass 1: max and min of the kept counts (counts are >= 0)
    unsigned mx = 0, mn = INT_MAX;
    if (valid) {
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c >= cutoff && live(t)) {
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

    // the side arrays follow the matches (and the winners); in lanes mode
    // the group words follow the side arrays
    const long long BK = B * (long long)K * (uwin || Wide ? 2 : 1);
    const int TT = lanes ? ln.T : T;  // tally width
    int* tallies = out + BK + (4 + (lanes ? ln.n_extra : 0)) * B;
    // pass 2: final matches and per-target tallies
    unsigned nm = 0;
    if (valid) {
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c < cutoff || !live(t)) continue;
            int tt = t;  // the tally's target
            if (lanes) {
                const int s = t / ln.gs;
                tt = s_grp[s] * ln.gs + (t - s * ln.gs);
            }
            if (c >= thr) {
                ++nm;
                if (emit_mt) atomicAdd(tallies + TT + tt, 1);
            } else {
                atomicAdd(tallies + tt, 1);
            }
        }
    }
    nm = block_reduce(nm, AddOp(), scratch);
    const int n_matches = (int)nm;

    // top entries: the final targets by descending key. mrow holds the
    // packed words (16-bit) or the counts (32-bit, ids in irow)
    int* mrow = out + b * K;
    int* irow = Wide ? out + B * (long long)K + b * K : nullptr;
    int* wrow = uwin ? out + B * (long long)K + b * K : nullptr;
    const int* urow = uwin ? uwin + b * T : nullptr;
    const int kf = min(K, n_matches);
    unsigned long long prev = ~0ULL;  // above every key (counts < 2^31)
    for (int j = 0; j < kf; ++j) {
        Key best = 0;
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int c = row[t];
            if (c >= cutoff && c >= thr && live(t)) {  // valid: n_matches > 0
                const Key key = ((Key)c << kIdBits) | (kIdMask - (Key)t);
                if ((unsigned long long)key < prev && key > best) best = key;
            }
        }
        best = block_reduce(best, MaxOp(), scratch);
        prev = best;
        if (threadIdx.x == 0) {
            const int t = (int)(kIdMask - (best & kIdMask));
            if constexpr (Wide) {
                mrow[j] = (int)(best >> 32);
                irow[j] = t;
            } else {
                mrow[j] = (int)(((unsigned)best & 0xFFFF0000u) | (unsigned)t);
                if (wrow) wrow[j] = urow[t];
            }
        }
    }
    // remaining slots: (live) non-final targets in ascending index order
    const int need = K - kf;
    int base = 0;
    for (int c0 = 0; c0 < T && base < need; c0 += blockDim.x) {
        const int t = c0 + threadIdx.x;
        bool nonfinal = false;
        if (t < T && live(t)) {
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
            if (i < warp) before += (int)scratch[i];
            total += (int)scratch[i];
        }
        const int rank = base + before + in_warp;
        if (nonfinal && rank < need) {
            if constexpr (Wide) {
                mrow[kf + rank] = 0;
                irow[kf + rank] = t;
            } else {
                mrow[kf + rank] = t;  // count 0 << 16
                if (wrow) wrow[kf + rank] = urow[t];
            }
        }
        base += total;
    }
    // lanes mode: the dead lanes, all reading the sentinel lane C (= T)
    if (lanes)
        for (int i = kf + base + threadIdx.x; i < K; i += blockDim.x) mrow[i] = T;

    if (lanes && threadIdx.x < ln.n_extra) {
        const int i = threadIdx.x;
        const int lo = s_grp[2 * i], hi = 2 * i + 1 < ln.S ? s_grp[2 * i + 1] : -1;
        const unsigned w = (lo >= 0 ? (unsigned)lo : 0xFFFFu) |
                           ((hi >= 0 ? (unsigned)hi : 0xFFFFu) << 16);
        out[BK + (4 + i) * B + b] = (int)w;
    }
    if (threadIdx.x == 0) {
        out[BK + b] = n_matches;
        out[BK + B + b] = max_count;
        out[BK + 2 * B + b] = n;
        out[BK + 3 * B + b] = overflow[b];
        if (n_matches > 0) {
            int* scalars = tallies + (emit_mt ? 2 : 1) * (long long)TT;
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
    select_kernel<false><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)counts, B, T, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, (const int*)uwin, (int*)packed,
        Lanes{nullptr, nullptr, nullptr, 0, 1, 0, T});
    return (int)cudaGetLastError();
}

// 32-bit mode: [B*K] counts | [B*K] target ids | the same side arrays.
extern "C" int ganon_select32(const void* counts, long long B, int T,
                              const void* n_hashes, const void* overflow,
                              double rel_cutoff, double rel_filter,
                              long long hashes_limit, int K,
                              int emit_matches_t, void* packed, void* stream) {
    if (K < 1 || K > T) return (int)cudaErrorInvalidValue;
    select_kernel<true><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)counts, B, T, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, nullptr, (int*)packed,
        Lanes{nullptr, nullptr, nullptr, 0, 1, 0, T});
    return (int)cudaGetLastError();
}

// Lanes mode: counts [B, C = S * gs] from fine.cu, the gate's gsel and
// slot_ok [B, S], the forest's grp_ntargets [G] and T targets.
extern "C" int ganon_select_lanes(const void* counts, long long B, int C,
                                  const void* n_hashes, const void* overflow,
                                  double rel_cutoff, double rel_filter,
                                  long long hashes_limit, int K,
                                  int emit_matches_t, const void* gsel,
                                  const void* slot_ok,
                                  const void* grp_ntargets, int S, int gs,
                                  int T, void* packed, void* stream) {
    if (S < 1 || S > kMaxS || gs < 1 || C != S * gs || K > C || K < 1)
        return (int)cudaErrorInvalidValue;
    select_kernel<false><<<(unsigned)B, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)counts, B, C, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, nullptr, (int*)packed,
        Lanes{(const int*)gsel, (const unsigned char*)slot_ok,
              (const int*)grp_ntargets, S, gs, (S + 1) / 2, T});
    return (int)cudaGetLastError();
}
