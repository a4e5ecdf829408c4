// fine: compacted minimizers -> per-lane counts of chosen target groups.
//
// Replaces the JAX device programs of the merged-bin pruned forest
//   ganon_tpu/classify/device.py:1088 _pruned_fine_rows and the dense fine
//     stage of :1119 classify_batch_packed_pruned (:1240-1253)     (K14),
//   ganon_tpu/classify/device.py:1394 _pruned_all_counts            (K15).
//
// Every group g has its own fine geometry (bin_size_g, shift_g =
// clz64(bin_size_g), row_off_g); a hash x probes rows
//   ganon_ibf_row(x, i, bin_size_g, shift_g) + row_off_g,  i < h,
// of the flat fine table (group_size/8 bytes per row, padded to whole u32
// words; the padding lanes are never counted). Lane j of the group counts
// the read's first min(n, M) hashes whose h rows all have bit j set, and
// is clamped to n.
//
// Dense mode (gsel given): one item per (read, slot) of the gate's [B, S]
// choice; a dead slot (slot_ok 0) writes zeros (the TPU program's pair
// compaction existed because its shapes were static; here a dead slot
// costs a store). Output [B, S, gs].
// Probe-all mode (gsel NULL): one item per (read, group), written into
// columns g*gs + j < T of a [B, T] matrix; with the gate's survive mask a
// dead group writes zeros (gated counts, the exact fallback), without it
// every group counts (the ungated diagnostic counts).
//
// Shard mode (K17, the shard_map body of ganon_tpu/parallel/
// pruned_shard.py:132-185 BinShardedPrunedForest): probe-all over one
// shard's G local groups, whose geometry arrays are the shard's own (row
// offsets into its own table) and gid[l] the global id of local group l.
// Survival is read from the replicated gate's [B, Gs] mask at the global
// id, and the output goes straight into the global columns gid*gs + j < T
// of the shared [B, T] matrix, so JAX's shard-major permutation
// (pruned_shard.py:112-117) is not needed. A pad group (gid -1, when the
// shards do not divide the groups) writes nothing.
//
// What bounds it on the H100: a live item gathers h narrow rows (8 bytes
// at group_size 64) per hash from a table of tens of MB, so its bytes are
// few and its time is the latency of those gathers and the bit counts.
// Probe-all is bound by its output: [B, T] int32, 268 MB at 8192 x 8192,
// nearly all of it the zeros of dead groups.
//
// Design: one warp a read's chunk of up to 32 items (its S slots, or 32
// of its groups), kWarps chunks a block, no shared memory and no block
// barrier (warp_bits.cuh). Lane k loads item k's group, liveness and
// geometry, so a chunk's flags arrive in one coalesced load. The warp
// then takes the items in order: a pad group is skipped, a dead item's
// zeros are stored 16 bytes a lane, and a live item walks the read's
// hashes in rounds of 32 (its hash slots stay in L1 from one item to the
// next): lane i computes its hash's h rows with the group's fastrange
// (__umul64hi, plus row_off) and loads each row's words of the current
// lane tile (one 8-byte load at group_size 64), ANDed over h. The warp
// counts every output lane of the round at once by a bit transpose of
// shuffles: output lane j0 + 32 r + k is cnt[r] of lane k, NW registers a
// lane for 32 NW lanes (NW <= 8; a wider group walks tiles of 256 lanes).
// The counts, clamped to n, are stored coalesced. (A warp a slot, and two
// rounds of hashes in flight at once, each took more card time at the
// table's shapes: more registers, fewer warps an SM.)
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_bits.cuh"

namespace {

constexpr int kWarps = 8;  // chunks a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxWords = 8;  // output lanes a tile: 256

// o[0..width) = 0 by the warp, 16 bytes a lane where o is aligned
__device__ __forceinline__ void store_zeros(int* __restrict__ o, int width,
                                            int lane) {
    int j = lane;
    if ((reinterpret_cast<uintptr_t>(o) & 15) == 0) {
        const int w4 = width >> 2;
        for (; j < w4; j += 32)
            reinterpret_cast<int4*>(o)[j] = make_int4(0, 0, 0, 0);
        j = 4 * w4 + lane;
    }
    for (; j < width; j += 32) o[j] = 0;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
fine_kernel(const unsigned* __restrict__ ftbl, long long W32, bool vec,
            const long long* __restrict__ hashes, long long B, int M,
            const int* __restrict__ n_hashes,
            const long long* __restrict__ grp_row_off,
            const long long* __restrict__ grp_bin_size,
            const int* __restrict__ grp_shift, int G, int h, int gs,
            const int* __restrict__ gsel,
            const unsigned char* __restrict__ slot_ok, int S,
            const unsigned char* __restrict__ surv, int* __restrict__ out,
            long long T, const int* __restrict__ gid, int Gs, int chunks) {
    constexpr int kTile = 32 * NW;  // output lanes a tile
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    const long long b = w / chunks;
    if (b >= B) return;  // the whole warp
    const int per_read = gsel ? S : G;  // items of a read
    const int k0 = (int)(w - b * chunks) * 32;
    const int nk = min(32, per_read - k0);  // items of this chunk

    // lane k < nk: item k0 + k's global group g (-1: a pad group), its
    // index p in the geometry arrays, whether it counts, and its geometry
    int g = -1, p = 0;
    bool live = false;
    if (lane < nk) {
        if (gsel) {
            const long long it = b * S + k0 + lane;
            p = gsel[it];
            g = 0;  // unused: dense outputs are per slot
            live = slot_ok[it] != 0;
        } else {
            p = k0 + lane;
            g = gid ? gid[p] : p;
            live = g >= 0 && (!surv || surv[b * (gid ? Gs : G) + g] != 0);
        }
    }
    unsigned long long bsz = 0, off = 0;
    int shift = 0;
    if (live) {
        bsz = (unsigned long long)grp_bin_size[p];
        off = (unsigned long long)grp_row_off[p];
        shift = grp_shift[p];
    }
    const unsigned live_mask = __ballot_sync(kFullMask, live);
    const int n = n_hashes[b];
    const int nvalid = max(0, min(n, M));
    const long long* hrow = hashes + b * M;

    for (int k = 0; k < nk; ++k) {
        const int gk = __shfl_sync(kFullMask, g, k);
        if (gk < 0) continue;  // a pad group writes nothing
        int* orow;
        int width;
        if (gsel) {
            orow = out + (b * S + k0 + k) * gs;
            width = gs;
        } else {
            orow = out + b * T + (long long)gk * gs;
            width = (int)min((long long)gs, T - (long long)gk * gs);
        }
        if (!((live_mask >> k) & 1u)) {
            store_zeros(orow, width, lane);
            continue;
        }
        const unsigned long long bk = __shfl_sync(kFullMask, bsz, k);
        const unsigned long long ok = __shfl_sync(kFullMask, off, k);
        const int sk = __shfl_sync(kFullMask, shift, k);
        for (int j0 = 0; j0 < width; j0 += kTile) {
            int cnt[NW];
#pragma unroll
            for (int r = 0; r < NW; ++r) cnt[r] = 0;
            count_rows<NW>(ftbl, W32, vec, j0 >> 5, hrow, nvalid, bk, sk,
                           ok, h, width - j0, lane, cnt);
#pragma unroll
            for (int r = 0; r < NW; ++r) {
                const int j = j0 + 32 * r + lane;
                if (j < width) orow[j] = min(cnt[r], n);
            }
        }
    }
}

template <int NW>
int launch(const void* ftbl, long long W8, const void* hashes, long long B,
           int M, const void* n_hashes, const void* grp_row_off,
           const void* grp_bin_size, const void* grp_shift, int G, int h,
           int gs, const void* gsel, const void* slot_ok, int S,
           const void* surv, void* out, long long T, const void* gid, int Gs,
           cudaStream_t stream) {
    const int chunks = ((gsel ? S : G) + 31) / 32;  // a read's
    const long long blocks = (B * chunks + kWarps - 1) / kWarps;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    fine_kernel<NW><<<(unsigned)blocks, kThreads, 0, stream>>>(
        (const unsigned*)ftbl, W8 / 4, rows_vectorizable<NW>(ftbl, W8 / 4),
        (const long long*)hashes, B, M, (const int*)n_hashes,
        (const long long*)grp_row_off, (const long long*)grp_bin_size,
        (const int*)grp_shift, G, h, gs, (const int*)gsel,
        (const unsigned char*)slot_ok, S, (const unsigned char*)surv,
        (int*)out, T, (const int*)gid, Gs, chunks);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ganon_fine(const void* ftbl, long long R, long long W8,
                          const void* hashes, long long B, int M,
                          const void* n_hashes, const void* grp_row_off,
                          const void* grp_bin_size, const void* grp_shift,
                          int G, int h, int gs, const void* gsel,
                          const void* slot_ok, int S, const void* surv,
                          void* out, long long T, const void* gid, int Gs,
                          void* stream) {
    (void)R;
    if (h < 1 || h > kMaxHashFns || W8 % 4 || gs < 8 || gs % 8 ||
        gs > W8 * 8 || (gsel && (S < 1 || !slot_ok || gid)) ||
        (!gsel && G < 1) || (gid && Gs < 1))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return (int)cudaSuccess;
    const int words = (gs + 31) / 32;  // the smallest tile that holds gs
    const auto run = words <= 1   ? &launch<1>
                     : words <= 2 ? &launch<2>
                     : words <= 4 ? &launch<4>
                                  : &launch<kMaxWords>;
    return run(ftbl, W8, hashes, B, M, n_hashes, grp_row_off, grp_bin_size,
               grp_shift, G, h, gs, gsel, slot_ok, S, surv, out, T, gid, Gs,
               (cudaStream_t)stream);
}
