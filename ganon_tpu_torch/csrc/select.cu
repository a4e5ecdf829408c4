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
// What bounds it on the H100: reading the [B, T] counts once (4 bytes per
// target per read); a read has 1-2 matches at default cutoffs, so what it
// keeps is small. Where most targets are kept (rel_cutoff 0), the
// per-target tally atomics, every block adding into the same [T] counters.
//
// Design: a block takes one read at a time, and the read's row comes from
// device memory once while what it keeps fits a list in shared memory.
// Where the tallies fit 12 KB of shared memory, a block takes up to 4
// reads (blockIdx.x, + gridDim.x, ...) and their tallies and the three
// scalars add up there and reach the output once at its end: a quarter
// of the atomics on the [T] counters that every block shares. Wider
// tallies take one read a block and device atomics as they come.
// - One pass over the row, with 16-byte loads where the row is aligned to
//   them (scalar loads at its ends; a row of fewer 16-byte vectors than
//   the block has threads, one count a thread): the max and min of the
//   kept counts (count >= cutoff, live), and every kept entry's key
//   appended to a list of up to 2048 by a warp-ballot compaction (one
//   shared atomic a warp). The keys are unique, so the list's order does
//   not matter to the result; the warps shuffle their 16-byte loads so a
//   ballot covers 32 consecutive targets, and the tally atomics from the
//   list then meet runs of neighbouring counters as a pass over the row
//   does (4 cache lines a warp's atomics, not 1, made it 2.5x slower when
//   most targets are kept). An invalid read (n == 0 or n > hashes_limit)
//   reads no row.
// - From the list, once the threshold is known: the final/tally split and
//   its atomics, the final entries' keys (compacted again by ballot), so
//   n_matches. The top min(K, n_matches) entries by key: each final's
//   rank is the count of larger keys (up to 256 finals), or min(K, n)
//   block-wide argmax passes over the finals (more of them).
// - The remaining slots take the lowest-index live non-final targets
//   without the row: with the finals' live positions f_0 < f_1 < ... (a
//   live position is the index among live targets, the target itself in
//   flat mode), slot q takes live position q + #{i : f_i - i <= q}, a
//   binary search; past the live targets, the lanes mode's sentinel.
// - A read that keeps more than the list holds (rel_cutoff 0 on a wide
//   filter keeps most of its targets) takes the earlier passes over the
//   row in the same kernel: finals and tallies, one block-wide argmax pass
//   per top entry, and the non-final fill through a block prefix count.
// The earlier kernel made those passes for every read: 5-7 reads of a
// 280 KB row at T = 70,000, which some 1,000 resident blocks push out of
// the 50 MB L2 (3.347 ms against one read's 0.685, NVIDIA H100 80GB HBM3,
// 700.00 W).
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
constexpr int kListCap = 2048;  // kept entries a read holds in shared memory
constexpr int kRankMax = 256;   // finals ranked by counting; past it, argmax
constexpr int kSharedTallyBytes = 12 * 1024;  // tallies a block sums itself
constexpr int kReadsPerBlock = 4;             // reads a block then takes

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

// Wide: the 32-bit mode (64-bit keys, counts and ids in two blocks). The
// 16-bit modes keep to 32 registers a thread, so 8 blocks fit an SM (at
// 38 registers, 6: select at T = 1024 took 0.048 ms on the card against
// 0.039); the 32-bit mode's 33 KB of keys hold it to 6 blocks anyway.
template <bool Wide>
__global__ void __launch_bounds__(kThreads, Wide ? 6 : 8)
select_kernel(const int* __restrict__ counts, long long B, int T,
              const int* __restrict__ n_hashes,
              const unsigned char* __restrict__ overflow, double rel_cutoff,
              double rel_filter, long long hashes_limit, int K, int emit_mt,
              const int* __restrict__ uwin, int* __restrict__ out,
              Lanes ln, int shared_tallies) {
    using Key = typename std::conditional<Wide, unsigned long long,
                                          unsigned>::type;
    constexpr int kIdBits = Wide ? 32 : 16;
    constexpr Key kIdMask = Wide ? 0xFFFFFFFFull : 0xFFFFu;
    __shared__ unsigned long long scratch[kWarps];
    __shared__ int s_grp[kMaxS];     // the slot's group, -1 when dead
    __shared__ int s_nt[kMaxS];      // live lanes of the slot
    __shared__ int s_pre[kMaxS + 1]; // live lanes before the slot
    __shared__ Key l_key[kListCap];  // the kept entries' keys
    __shared__ Key f_key[kListCap];  // the final entries' keys
    int* l_off = reinterpret_cast<int*>(l_key);  // later: the fill's offsets
    __shared__ int s_len, s_nf;
    __shared__ int s_scalars[3];
    extern __shared__ int s_tallies[];  // [TT] (+ [TT]) with shared_tallies
    const bool lanes = ln.gsel != nullptr;
    const int lane = threadIdx.x & 31;
    const unsigned lt_mask = (1u << lane) - 1u;
    // the side arrays follow the matches (and the winners); in lanes mode
    // the group words follow the side arrays
    const long long BK = B * (long long)K * (uwin || Wide ? 2 : 1);
    const int TT = lanes ? ln.T : T;  // tally width
    int* g_tallies = out + BK + (4 + (lanes ? ln.n_extra : 0)) * B;
    const int n_tally = (emit_mt ? 2 : 1) * TT;
    // the block's tallies and scalars add up over its reads in shared
    // memory and reach the output once (where the tallies fit)
    int* tallies = shared_tallies ? s_tallies : g_tallies;
    if (shared_tallies)
        for (int i = threadIdx.x; i < n_tally; i += kThreads) s_tallies[i] = 0;
    if (threadIdx.x < 3) s_scalars[threadIdx.x] = 0;
    for (long long b = blockIdx.x; b < B; b += gridDim.x) {
        const int* row = counts + b * T;
        const int n = n_hashes[b];
        const int cutoff = (int)fmax(ceil((double)n * rel_cutoff), 1.0);
        const bool valid = n > 0 && (long long)n <= hashes_limit;
        if (lanes && threadIdx.x < ln.S) {
            const long long i = b * ln.S + threadIdx.x;
            const bool ok = ln.slot_ok[i] != 0;
            s_grp[threadIdx.x] = ok ? ln.gsel[i] : -1;
            s_nt[threadIdx.x] = ok ? ln.grp_ntargets[ln.gsel[i]] : 0;
        }
        if (threadIdx.x == 0) s_len = s_nf = 0;
        __syncthreads();
        if (lanes && threadIdx.x == 0) {
            s_pre[0] = 0;
            for (int s = 0; s < ln.S; ++s) s_pre[s + 1] = s_pre[s] + s_nt[s];
        }
        auto live = [&](int t) -> bool {
            if (!lanes) return true;
            const int s = t / ln.gs;
            return t - s * ln.gs < s_nt[s];
        };

        auto key_of = [&](int t, int c) -> Key {
            return ((Key)c << kIdBits) | (kIdMask - (Key)t);
        };

        // the one pass: max and min of the kept counts (counts are >= 0), the
        // kept entries into the list. Every lane of a warp calls keep() the
        // same number of times (the ballots).
        unsigned mx = 0, mn = INT_MAX;
        auto keep = [&](int t, int c, bool in) {
            const bool k = in && c >= cutoff && live(t);
            if (k) {
                mx = max(mx, (unsigned)c);
                mn = min(mn, (unsigned)c);
            }
            const unsigned bal = __ballot_sync(0xFFFFFFFFu, k);
            if (!bal) return;
            int base = 0;
            if (lane == 0) base = atomicAdd(&s_len, __popc(bal));
            base = __shfl_sync(0xFFFFFFFFu, base, 0);
            const int i = base + __popc(bal & lt_mask);
            if (k && i < kListCap) l_key[i] = key_of(t, c);
        };
        // scalar loads up to the first 16-byte boundary and after the last
        const int head =
            min(T, (int)(((16 - ((size_t)row & 15)) & 15) >> 2));
        const int nv = (T - head) >> 2;
        if (valid && nv < kThreads) {
            // a row of fewer vectors than threads (lanes' 128 counts): one
            // count a thread, so every warp works and a ballot still covers
            // 32 consecutive targets (one warp taking the 32 vectors in 4
            // steps held lanes at 0.049 ms on the card, against 0.039)
            for (int t0 = 0; t0 < T; t0 += kThreads) {
                const int t = t0 + threadIdx.x;
                keep(t, t < T ? row[t] : 0, t < T);
            }
        } else if (valid) {
            const int tail0 = head + 4 * nv;
            keep(threadIdx.x, threadIdx.x < head ? row[threadIdx.x] : 0,
                 threadIdx.x < head);
            // a warp loads 128 consecutive counts, then passes them on so
            // that step q hands lane l target 32 q + l of them: the list (and
            // so the tally atomics) keeps runs of consecutive targets
            const int4* vrow = reinterpret_cast<const int4*>(row + head);
            for (int v0 = 0; v0 < nv; v0 += kThreads) {
                const int v = v0 + threadIdx.x;
                const int4 x =
                    v < nv ? __ldg(vrow + v) : make_int4(0, 0, 0, 0);
                const int wv = v - lane;  // the warp's first vector
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int src = 8 * q + (lane >> 2);
                    const int a = __shfl_sync(0xFFFFFFFFu, x.x, src);
                    const int b = __shfl_sync(0xFFFFFFFFu, x.y, src);
                    const int c = __shfl_sync(0xFFFFFFFFu, x.z, src);
                    const int d = __shfl_sync(0xFFFFFFFFu, x.w, src);
                    const int j = lane & 3;
                    keep(head + 4 * wv + 32 * q + lane,
                         j == 0 ? a : j == 1 ? b : j == 2 ? c : d,
                         wv + src < nv);
                }
            }
            const int tt = tail0 + threadIdx.x;
            keep(tt, tt < T ? row[tt] : 0, tt < T);
        }
        mx = block_reduce(mx, MaxOp(), scratch);
        mn = block_reduce(mn, MinOp(), scratch);
        const int max_count = (int)mx;
        const int min_count = min(n, (int)mn);
        const int thr = (int)((double)max_count
                              - ceil((double)(max_count - min_count)
                                     * rel_filter));
        const int len = s_len;  // block_reduce's barriers follow every append

        auto tally_target = [&](int t) -> int {
            if (!lanes) return t;
            const int s = t / ln.gs;
            return s_grp[s] * ln.gs + (t - s * ln.gs);
        };
        // top entries: mrow holds the packed words (16-bit) or the counts
        // (32-bit, ids in irow)
        int* mrow = out + b * K;
        int* irow = Wide ? out + B * (long long)K + b * K : nullptr;
        int* wrow = uwin ? out + B * (long long)K + b * K : nullptr;
        const int* urow = uwin ? uwin + b * T : nullptr;
        auto put_top = [&](int j, Key key) {
            const int t = (int)(kIdMask - (key & kIdMask));
            if constexpr (Wide) {
                mrow[j] = (int)(key >> 32);
                irow[j] = t;
            } else {
                mrow[j] = (int)(((unsigned)key & 0xFFFF0000u) | (unsigned)t);
                if (wrow) wrow[j] = urow[t];
            }
        };
        auto put_nonfinal = [&](int j, int t) {  // count 0
            if constexpr (Wide) {
                mrow[j] = 0;
                irow[j] = t;
            } else {
                mrow[j] = t;
                if (wrow) wrow[j] = urow[t];
            }
        };

        int n_matches;
        if (len <= kListCap) {
            // finals and tallies from the list; the finals' keys compacted
            for (int i0 = 0; i0 < len; i0 += kThreads) {
                const int i = i0 + threadIdx.x;
                bool fin = false;
                Key key = 0;
                if (i < len) {
                    key = l_key[i];
                    const int tt =
                        tally_target((int)(kIdMask - (key & kIdMask)));
                    fin = (int)(key >> kIdBits) >= thr;
                    if (fin) {
                        if (emit_mt) atomicAdd(tallies + TT + tt, 1);
                    } else {
                        atomicAdd(tallies + tt, 1);
                    }
                }
                const unsigned bal = __ballot_sync(0xFFFFFFFFu, fin);
                if (bal) {
                    int base = 0;
                    if (lane == 0) base = atomicAdd(&s_nf, __popc(bal));
                    base = __shfl_sync(0xFFFFFFFFu, base, 0);
                    if (fin) f_key[base + __popc(bal & lt_mask)] = key;
                }
            }
            __syncthreads();
            n_matches = s_nf;
            const int nm = n_matches, kf = min(K, nm);
            if (nm <= kRankMax) {  // a final's rank: the larger keys
                for (int i = threadIdx.x; i < nm; i += kThreads) {
                    const Key key = f_key[i];
                    int rank = 0;
                    for (int j = 0; j < nm; ++j) rank += f_key[j] > key;
                    if (rank < kf) put_top(rank, key);
                }
            } else {  // argmax passes over the finals, each below the last
                unsigned long long prev = ~0ULL;
                for (int j = 0; j < kf; ++j) {
                    Key best = 0;
                    for (int i = threadIdx.x; i < nm; i += kThreads) {
                        const Key key = f_key[i];
                        if ((unsigned long long)key < prev && key > best)
                            best = key;
                    }
                    best = block_reduce(best, MaxOp(), scratch);
                    prev = best;
                    if (threadIdx.x == 0) put_top(j, best);
                }
            }
            // the remaining slots: live non-final targets, ascending, then
            // (lanes mode) the sentinel lane C (= T)
            const int need = K - kf;
            if (need > 0) {  // so nm < K: the finals' live positions, sorted
                auto live_pos = [&](int t) -> int {
                    if (!lanes) return t;
                    const int s = t / ln.gs;
                    return s_pre[s] + t - s * ln.gs;
                };
                for (int i = threadIdx.x; i < nm; i += kThreads) {
                    const Key key = f_key[i];
                    int pos = 0;  // finals of a lower target (keys unique)
                    for (int j = 0; j < nm; ++j)
                        pos += (f_key[j] & kIdMask) > (key & kIdMask);
                    l_off[pos] =
                        live_pos((int)(kIdMask - (key & kIdMask))) - pos;
                }
                __syncthreads();
                const int n_live = lanes ? s_pre[ln.S] : T;
                for (int q = threadIdx.x; q < need; q += kThreads) {
                    int a = 0, z = nm;  // #{i : f_i - i <= q}
                    while (a < z) {
                        const int mid = (a + z) >> 1;
                        if (l_off[mid] <= q) a = mid + 1; else z = mid;
                    }
                    const int p = q + a;
                    if (p >= n_live) {
                        mrow[kf + q] = T;  // lanes mode only: n_live < K
                        continue;
                    }
                    int t = p;
                    if (lanes) {
                        int s = 0;
                        while (s_pre[s + 1] <= p) ++s;
                        t = s * ln.gs + (p - s_pre[s]);
                    }
                    put_nonfinal(kf + q, t);
                }
            }
        } else {
            // the list overflowed: passes over the row. Final matches and
            // per-target tallies
            unsigned nm = 0;
            for (int t = threadIdx.x; t < T; t += blockDim.x) {
                const int c = row[t];
                if (c < cutoff || !live(t)) continue;
                const int tt = tally_target(t);
                if (c >= thr) {
                    ++nm;
                    if (emit_mt) atomicAdd(tallies + TT + tt, 1);
                } else {
                    atomicAdd(tallies + tt, 1);
                }
            }
            nm = block_reduce(nm, AddOp(), scratch);
            n_matches = (int)nm;
            // the final targets by descending key: min(K, n_matches)
            // block-wide argmax passes, each taking the largest key below the
            // previous one (keys are unique, so nothing is modified)
            const int kf = min(K, n_matches);
            unsigned long long prev = ~0ULL;  // above every key
            for (int j = 0; j < kf; ++j) {
                Key best = 0;
                for (int t = threadIdx.x; t < T; t += blockDim.x) {
                    const int c = row[t];
                    if (c >= cutoff && c >= thr && live(t)) {
                        const Key key = key_of(t, c);
                        if ((unsigned long long)key < prev && key > best)
                            best = key;
                    }
                }
                best = block_reduce(best, MaxOp(), scratch);
                prev = best;
                if (threadIdx.x == 0) put_top(j, best);
            }
            // remaining slots: (live) non-final targets in ascending index
            // order, through a block prefix count
            const int need = K - kf;
            int base = 0;
            for (int c0 = 0; c0 < T && base < need; c0 += blockDim.x) {
                const int t = c0 + threadIdx.x;
                bool nonfinal = false;
                if (t < T && live(t)) {
                    const int c = row[t];
                    nonfinal = !(c >= cutoff && c >= thr);
                }
                // block exclusive prefix count of nonfinal over this chunk
                const unsigned ballot = __ballot_sync(0xFFFFFFFFu, nonfinal);
                const int warp = threadIdx.x >> 5;
                const int in_warp = __popc(ballot & lt_mask);
                __syncthreads();
                if (lane == 0) scratch[warp] = __popc(ballot);
                __syncthreads();
                int before = 0, total = 0;
                for (int i = 0; i < kWarps; ++i) {
                    if (i < warp) before += (int)scratch[i];
                    total += (int)scratch[i];
                }
                const int rank = base + before + in_warp;
                if (nonfinal && rank < need) put_nonfinal(kf + rank, t);
                base += total;
            }
            // lanes mode: the dead lanes, all the sentinel lane C (= T)
            if (lanes)
                for (int i = kf + base + threadIdx.x; i < K; i += blockDim.x)
                    mrow[i] = T;
        }

        if (lanes && threadIdx.x < ln.n_extra) {
            const int i = threadIdx.x;
            const int lo = s_grp[2 * i];
            const int hi = 2 * i + 1 < ln.S ? s_grp[2 * i + 1] : -1;
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
                s_scalars[0] += 1;
                s_scalars[1] += n;
                s_scalars[2] += max_count;
            }
        }
        __syncthreads();  // before the next read reuses the shared state
    }
    if (shared_tallies)
        for (int i = threadIdx.x; i < n_tally; i += kThreads)
            if (s_tallies[i]) atomicAdd(g_tallies + i, s_tallies[i]);
    if (threadIdx.x < 3 && s_scalars[threadIdx.x])
        atomicAdd(g_tallies + n_tally + threadIdx.x, s_scalars[threadIdx.x]);
}

// Launch: where the tallies fit in shared memory, a block takes up to
// kReadsPerBlock reads (blockIdx.x, + gridDim.x, ...) and adds their
// tallies up there, as long as the grid still gives every SM 8 blocks (64
// ultra-long reads took 0.088 ms as 16 blocks of 4, 0.066 as 64 blocks);
// else one read a block, the tallies straight to the output.
template <bool Wide>
int launch_select(const int* counts, long long B, int T, const int* n_hashes,
                  const unsigned char* overflow, double rel_cutoff,
                  double rel_filter, long long hashes_limit, int K,
                  int emit_mt, const int* uwin, int* out, Lanes ln,
                  cudaStream_t stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int TT = ln.gsel ? ln.T : T;
    const long long tally_bytes = 4ll * (emit_mt ? 2 : 1) * TT;
    const int shared = tally_bytes <= kSharedTallyBytes;
    static int sms = 0;  // the card's SMs, asked once
    if (!sms) {
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
    }
    const long long grid =
        shared ? max((B + kReadsPerBlock - 1) / kReadsPerBlock,
                     min(B, 8ll * sms))
               : B;
    select_kernel<Wide><<<(unsigned)grid, kThreads,
                          shared ? (size_t)tally_bytes : 0, stream>>>(
        counts, B, T, n_hashes, overflow, rel_cutoff, rel_filter,
        hashes_limit, K, emit_mt, uwin, out, ln, shared);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ganon_select(const void* counts, long long B, int T,
                            const void* n_hashes, const void* overflow,
                            double rel_cutoff, double rel_filter,
                            long long hashes_limit, int K, int emit_matches_t,
                            const void* uwin, void* packed, void* stream) {
    return launch_select<false>(
        (const int*)counts, B, T, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, (const int*)uwin, (int*)packed,
        Lanes{nullptr, nullptr, nullptr, 0, 1, 0, T}, (cudaStream_t)stream);
}

// 32-bit mode: [B*K] counts | [B*K] target ids | the same side arrays.
extern "C" int ganon_select32(const void* counts, long long B, int T,
                              const void* n_hashes, const void* overflow,
                              double rel_cutoff, double rel_filter,
                              long long hashes_limit, int K,
                              int emit_matches_t, void* packed, void* stream) {
    if (K < 1 || K > T) return (int)cudaErrorInvalidValue;
    return launch_select<true>(
        (const int*)counts, B, T, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, nullptr, (int*)packed,
        Lanes{nullptr, nullptr, nullptr, 0, 1, 0, T}, (cudaStream_t)stream);
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
    return launch_select<false>(
        (const int*)counts, B, C, (const int*)n_hashes,
        (const unsigned char*)overflow, rel_cutoff, rel_filter, hashes_limit,
        K, emit_matches_t, nullptr, (int*)packed,
        Lanes{(const int*)gsel, (const unsigned char*)slot_ok,
              (const int*)grp_ntargets, S, gs, (S + 1) / 2, T},
        (cudaStream_t)stream);
}
