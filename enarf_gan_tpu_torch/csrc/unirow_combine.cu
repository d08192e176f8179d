// Unirow gather + combine for Hopper (sm_90a), forward (the backward is
// unirow_combine_bwd.cu).
//
// Replaces the TPU Pallas kernel enarf_gan_tpu/ops/unirow.py::_combine_kernel
// (launched by _combine_pallas) and also does the row gather that the JAX
// package runs outside that kernel (jnp.take in sample_candidates_unirow).
//
// For every (batch b, point i, candidate m, plane p) the kernel reads one
// 256-lane bf16 row of the packed table (ops/unirow.py::pack_unirow):
//     [ A_f | B_f | C_f | D_f | A_m(32) | B_m(32) | C_m(32) | D_m(32) ]
// four F=32 feature corners, then four 32-lane mask corner blocks holding
// the mask logit of every bone. It computes
//     feat_m   = sum_p sum_q wq[q,p,m] * row_pm[q*F + f]
//     logit_pm = sum_q wq[q,p,m] * row_pm[4F + 32q + cand_idx[m]]
//     cand_w_m = prod_p sigmoid(logit_pm)          (logit clamped to [-2, 5]
//                                                   when clamp is set)
//     feature  = sum_m cand_w_m * valid_m * feat_m
// in float32.
//
// What bounds it: bytes. Each (point, candidate, plane) reads a 512-byte row
// at a data-dependent address, and the table (3*257*257 rows at 256^2 planes,
// about 101 MB) is larger than the H100's 50 MB L2, so rows come from HBM
// unless neighbouring rays hit the same cells. The arithmetic is a few
// multiply-adds per byte.
//
// Design: one warp per (b, point). Lane f reads feature lane f of each of the
// four corners, and mask lane f (bone f) of each corner block, so every row
// is read as eight fully used 64-byte segments and each byte of it once; the
// gathered (B, 3, M, n, 256) tensor that the plain version materialises
// (1.6 GB for one 4096-ray, 64-sample chunk) never exists. The 12 rows of a
// point (M=4 candidates x 3 planes) are independent loads, which keeps many
// row reads in flight per warp. A shuffle from lane cand_idx picks the
// candidate's mask logit. The (B, F, n) feature output is written through
// shared memory, so the eight warps of a block store 8 consecutive points of
// each feature row together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 32;           // feature lanes = warp width
constexpr int kMaskBlock = 32;   // lanes per mask corner block
constexpr int kRowWidth = 4 * kF + 4 * kMaskBlock;
constexpr int kWarps = 8;        // points per block

__global__ void __launch_bounds__(kWarps * 32)
unirow_combine_kernel(const __nv_bfloat16* __restrict__ table,
                      const int32_t* __restrict__ rows,
                      const float* __restrict__ wq4,
                      const int32_t* __restrict__ cand_idx,
                      const float* __restrict__ valid,
                      float* __restrict__ feature,
                      float* __restrict__ cand_w,
                      int R, int M, int n, int clamp) {
  __shared__ float tile[kF][kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kWarps;
  const int pt = pt0 + warp;

  float acc = 0.f;
  if (pt < n) {
    const int64_t plane_stride = (int64_t)M * n;           // rows/wq4 planes
    const __nv_bfloat16* tb = table + (int64_t)b * R * kRowWidth;
    const int32_t* rows_b = rows + (int64_t)b * 3 * plane_stride;
    const float* wq_b = wq4 + (int64_t)b * 12 * plane_stride;
    for (int m = 0; m < M; ++m) {
      const int64_t mi = (int64_t)m * n + pt;
      const int64_t bmi = (int64_t)b * plane_stride + mi;
      const int idx = cand_idx[bmi];
      const float v = valid[bmi];
      float feat = 0.f;
      float cw = 1.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const __nv_bfloat16* row =
            tb + (int64_t)rows_b[p * plane_stride + mi] * kRowWidth;
        float logit_lane = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float w = wq_b[(q * 3 + p) * plane_stride + mi];
          feat += w * __bfloat162float(row[q * kF + lane]);
          logit_lane +=
              w * __bfloat162float(row[4 * kF + q * kMaskBlock + lane]);
        }
        float logit = __shfl_sync(0xffffffffu, logit_lane, idx & 31);
        if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
        cw *= 1.f / (1.f + expf(-logit));
      }
      acc += cw * v * feat;
      if (lane == 0) cand_w[bmi] = cw;
    }
  }
  tile[lane][warp] = acc;
  __syncthreads();
  const int f = threadIdx.x / kWarps;
  const int j = threadIdx.x % kWarps;
  if (pt0 + j < n) feature[((int64_t)b * kF + f) * n + pt0 + j] = tile[f][j];
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   table (B, R, 256) bf16; rows (B, 3, M, n) int32 row index within b;
//   wq4 (B, 4, 3, M, n) f32; cand_idx (B, M, n) int32 in [0, 32);
//   valid (B, M, n) f32 -> feature (B, 32, n) f32, cand_w (B, M, n) f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int unirow_combine_bf16(const void* table, const void* rows,
                                   const void* wq4, const void* cand_idx,
                                   const void* valid, void* feature,
                                   void* cand_w, int B, int R, int M, int n,
                                   int clamp, void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_combine_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)table, (const int32_t*)rows, (const float*)wq4,
      (const int32_t*)cand_idx, (const float*)valid, (float*)feature,
      (float*)cand_w, R, M, n, clamp);
  return (int)cudaGetLastError();
}
