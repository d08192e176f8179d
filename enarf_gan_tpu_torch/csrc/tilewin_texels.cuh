// What the tilewin kernels on the texel table (tilewin_combine.cu,
// tilewin_combine_bwd.cu) share: the table's layout, the members' cells and
// the bilinear form of a member's 2x2 texels.
//
// Texel table (ops/unirow.py::pack_texels): (B, 3, H+2, W+2, 64) bf16, one
// 128-byte line a texel, lanes [32 feature | 32 mask, bone k at lane 32+k];
// its gradient has the same shape in float32. A group's window is named by
// its base texel, ((b*3 + p)*(H+2) + bt)*(W+2) + bs over the whole table
// (ops/tilewin.py::texel_plan); window texel (t, s) is table texel
// base + t*(W+2) + s.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tilewin {

constexpr int kF = 32;            // channels = warp width = a texel's features
constexpr int kTexel = 64;        // lanes of a texel line
constexpr int kWin = 8;           // window side, texels
constexpr int kUnits = 8;         // units per block = warps per block
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ void texel_cell(float x, int& i, float& frac) {
  // x in [0, 7); an f32 sum of offset + fraction may round up to 7.0, which
  // then puts all the weight on texel 7, as the TPU kernel's hats do
  const float c = fminf(floorf(x), (float)(kWin - 2));
  i = (int)c;
  frac = x - c;
}

// The bilinear form of one lane of the 2x2 texels of cell (i, k) of the
// window at base texel `base`: p points at the lane of table texel 0, Wp is
// W+2. The texels stay inside the table: the plan's bases and cells keep
// every member's quad within rows and columns H+1 and W+1
// (ops/tilewin.py::texel_plan, tests/test_torch_tilewin.py).
__device__ __forceinline__ int64_t quad_texel(int32_t base, int i, int k,
                                              int Wp) {
  return (int64_t)base + i * Wp + k;
}

__device__ __forceinline__ float bilinear(const __nv_bfloat16* p, int64_t t,
                                          int Wp, float ft, float fs) {
  const __nv_bfloat16* q = p + t * kTexel;
  const float v00 = __bfloat162float(q[0]);
  const float v01 = __bfloat162float(q[kTexel]);
  const float v10 = __bfloat162float(q[(int64_t)Wp * kTexel]);
  const float v11 = __bfloat162float(q[(int64_t)(Wp + 1) * kTexel]);
  return (1.f - ft) * ((1.f - fs) * v00 + fs * v01) +
         ft * ((1.f - fs) * v10 + fs * v11);
}

}  // namespace tilewin
