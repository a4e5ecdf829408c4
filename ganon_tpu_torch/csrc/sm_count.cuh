// The card's streaming multiprocessors, for the kernels that size their
// grid to a few blocks an SM (132 on an H100 SXM, taken where the query
// fails).
#pragma once

#include <cuda_runtime.h>

inline int sm_count() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return 132;
    return sms;
}
