// gather_probe: the random row-gather rate into a small table.
//
// Replaces the repository's only Pallas kernel,
// scripts/pallas_gather_probe.py:28 pallas_count (pl.pallas_call at :56):
// tbl u8 [R, 32] (R = 131,072: 4 MB) viewed as u32 [R / 16, 128], rows
// int32 [N]; out int32 [1, 128], where each probe r adds the popcounts
// of row r's eight u32 words to lanes 8 (r & 15) .. 8 (r & 15) + 7. The
// TPU probe asked how fast a kernel can load dynamic rows from VMEM; the
// same question here is the card's rate of random 32-byte row loads from
// a table that stays in the 50 MB L2, which is what the count kernels'
// bound rests on.
//
// What bounds it on the H100: the gather. Each probe reads 32 bytes at a
// random row (two 16-byte loads), the rows are 4 bytes each, and 8
// popcounts and 8 adds follow; the table itself is read from device
// memory once and then hits L2.
//
// Design: a grid of blocks walks the probes grid-stride, a thread per
// probe; the 128 lane sums of a block sit in shared memory (shared
// atomics), and each block adds its sums into the zeroed output once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;

__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const uint4* __restrict__ tbl,
                    const int* __restrict__ rows, long long N,
                    int* __restrict__ out) {
    __shared__ int acc[kLanes];
    for (int i = threadIdx.x; i < kLanes; i += blockDim.x) acc[i] = 0;
    __syncthreads();
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < N; i += step) {
        const int r = rows[i];
        const uint4 a = tbl[2 * (long long)r], c = tbl[2 * (long long)r + 1];
        int* lane = acc + 8 * (r & 15);
        atomicAdd(lane + 0, __popc(a.x));
        atomicAdd(lane + 1, __popc(a.y));
        atomicAdd(lane + 2, __popc(a.z));
        atomicAdd(lane + 3, __popc(a.w));
        atomicAdd(lane + 4, __popc(c.x));
        atomicAdd(lane + 5, __popc(c.y));
        atomicAdd(lane + 6, __popc(c.z));
        atomicAdd(lane + 7, __popc(c.w));
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kLanes; i += blockDim.x)
        if (acc[i]) atomicAdd(out + i, acc[i]);
}

}  // namespace

extern "C" int ganon_gather_probe(const void* tbl, long long R,
                                  const void* rows, long long N, void* out,
                                  void* stream) {
    if (R <= 0 || N < 0) return (int)cudaErrorInvalidValue;
    if (N == 0) return (int)cudaGetLastError();
    long long blocks = (N + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    gather_probe_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint4*)tbl, (const int*)rows, N, (int*)out);
    return (int)cudaGetLastError();
}
