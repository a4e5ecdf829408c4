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
// words; the padding lanes are never read). Lane j of the group counts
// the read's first min(n, M) hashes whose h rows all have bit j set, and
// is clamped to n.
//
// Dense mode (gsel given): one block per (read, slot) of the gate's
// [B, S] choice; a dead slot (slot_ok 0) writes zeros and returns at once
// (the TPU program's pair compaction existed because its shapes were
// static; here a dead slot simply costs nothing). Output [B, S, gs].
// Probe-all mode (gsel NULL): one block per (read, group), written into
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
// What bounds it on the H100: one narrow gather per hash and hash
// function (8 bytes of a row at group_size 64) from a table of tens of
// MB, mostly L2-resident at the T8192 shape; arithmetic is a hash and a
// bit test.
//
// Design: the block hashes its chunk of minimizers into shared memory
// (the group's dynamic fastrange, __umul64hi), then thread j owns lane j:
// it reads the u32 word holding its bit from each hash's rows (the warp's
// threads read the same words, one transaction), ANDs over h and adds the
// bit. The block owns its output lanes: no atomics.
#include <cuda_runtime.h>

#include <cstdint>

#include "ibf_hash.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kHashChunk = 256;
constexpr int kMaxH = 5;

__global__ void __launch_bounds__(kThreads)
fine_kernel(const unsigned* __restrict__ ftbl, long long W32,
            const long long* __restrict__ hashes, int M,
            const int* __restrict__ n_hashes,
            const long long* __restrict__ grp_row_off,
            const long long* __restrict__ grp_bin_size,
            const int* __restrict__ grp_shift, int G, int h, int gs,
            const int* __restrict__ gsel,
            const unsigned char* __restrict__ slot_ok, int S,
            const unsigned char* __restrict__ surv, int* __restrict__ out,
            long long T, const int* __restrict__ gid, int Gs) {
    __shared__ unsigned long long rows[kHashChunk * kMaxH];

    const long long blk = blockIdx.x;
    long long b;
    int g, p, width;  // global group; its index in the geometry arrays
    bool live;
    int* orow;
    if (gsel) {
        b = blk / S;
        g = p = gsel[blk];
        live = slot_ok[blk] != 0;
        orow = out + blk * gs;
        width = gs;
    } else {
        b = blk / G;
        p = (int)(blk - b * G);
        g = gid ? gid[p] : p;
        if (g < 0) return;  // a pad group: uniform over the block
        live = surv ? surv[b * (gid ? Gs : G) + g] != 0 : true;
        orow = out + b * T + (long long)g * gs;
        width = (int)min((long long)gs, T - (long long)g * gs);
    }
    if (!live) {  // uniform over the block, before any barrier
        for (int j = threadIdx.x; j < width; j += blockDim.x) orow[j] = 0;
        return;
    }
    const int n = n_hashes[b];
    const int nvalid = max(0, min(n, M));
    const long long* hrow = hashes + b * M;
    const unsigned long long bsz = (unsigned long long)grp_bin_size[p];
    const int shift = grp_shift[p];
    const unsigned long long off = (unsigned long long)grp_row_off[p];

    for (int j0 = 0; j0 < width; j0 += blockDim.x) {
        const int j = j0 + threadIdx.x;
        const long long word = j >> 5;
        const unsigned bit = (unsigned)j & 31u;
        int acc = 0;
        for (int m0 = 0; m0 < nvalid; m0 += kHashChunk) {
            const int mn = min(kHashChunk, nvalid - m0);
            __syncthreads();  // the last chunk's rows are read
            for (int q = threadIdx.x; q < mn * h; q += blockDim.x) {
                const int m = q / h, s = q - m * h;
                rows[q] = ganon_ibf_row((unsigned long long)hrow[m0 + m], s,
                                        bsz, shift) + off;
            }
            __syncthreads();
            if (j < width) {
                for (int m = 0; m < mn; ++m) {
                    const unsigned long long* r = rows + m * h;
                    unsigned v = ftbl[(long long)r[0] * W32 + word];
                    for (int s = 1; s < h; ++s)
                        v &= ftbl[(long long)r[s] * W32 + word];
                    acc += (v >> bit) & 1u;
                }
            }
        }
        if (j < width) orow[j] = min(acc, n);
    }
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
    if (h < 1 || h > kMaxH || W8 % 4 || gs < 8 || gs % 8 || gs > W8 * 8 ||
        (gsel && (S < 1 || !slot_ok || gid)) || (!gsel && G < 1) ||
        (gid && Gs < 1))
        return (int)cudaErrorInvalidValue;
    const long long blocks = gsel ? B * S : B * G;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    fine_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)ftbl, W8 / 4, (const long long*)hashes, M,
        (const int*)n_hashes, (const long long*)grp_row_off,
        (const long long*)grp_bin_size, (const int*)grp_shift, G, h, gs,
        (const int*)gsel, (const unsigned char*)slot_ok, S,
        (const unsigned char*)surv, (int*)out, T, (const int*)gid, Gs);
    return (int)cudaGetLastError();
}
