// IBF hash family shared by the count and scatter kernels.
//
// Same arithmetic as ganon_tpu/ops/ibf_query.py:ibf_row_indices:
//   g   = ((x * seed_i) ^ ((x * seed_i) >> clz64(bin_size))) * GOLDEN  (mod 2^64)
//   row = mulhi64(g, bin_size)
// On the card u64 is native, so mulhi is __umul64hi instead of 32-bit limbs.
#pragma once

#include <cstdint>

__device__ __forceinline__ unsigned long long ganon_hash_seed(int i) {
    switch (i) {
        case 0: return 13572355802537770549ULL;  // 2^64 / (e/2)
        case 1: return 13043817825332782213ULL;  // 2^64 / sqrt(2)
        case 2: return 10650232656628343401ULL;  // 2^64 / sqrt(5)
        case 3: return 16499269484942379435ULL;  // 2^64 / (sqrt(3)/2)
        default: return 4893150838803335377ULL;  // 2^64 / (3/(2*sqrt(e)))
    }
}

// Row of hash function i for value x; shift = clz64(bin_size) in [0, 63].
__device__ __forceinline__ unsigned long long ganon_ibf_row(
    unsigned long long x, int i, unsigned long long bin_size, int shift) {
    unsigned long long g = x * ganon_hash_seed(i);
    g ^= g >> shift;
    g *= 0x9E3779B97F4A7C15ULL;
    return __umul64hi(g, bin_size);
}
