// What the row gathers of probe_gather.cu (A1) and probe_mma.cu (B1) share:
// a division by a divisor fixed at launch, by a multiply and a shift in
// place of a 32-bit integer division (about 20 instructions on the card).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// n / d for n < 2^31 by a multiply and a shift (d >= 1, set on the host)
struct FastDiv {
  uint32_t d, m, s;
  explicit FastDiv(uint32_t d_) : d(d_), s(0) {
    while ((1u << s) < d) ++s;
    m = (uint32_t)((((uint64_t)1 << 32) * (((uint64_t)1 << s) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};
