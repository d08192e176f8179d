// Unirow gather + combine, backward, for Hopper (sm_90a).
//
// Replaces the JAX package's hand VJP of the unirow combine,
// enarf_gan_tpu/ops/unirow.py::_combine_bwd (XLA, no Pallas), and the
// transpose of its row gather (the scatter-add of the row cotangents into
// the table that jnp.take's VJP does).
//
// The forward (csrc/unirow_combine.cu) computes, per (batch b, point i,
// candidate m, plane p), from one 256-lane bf16 row of the packed table:
//     feat_m   = sum_p sum_q wq[q,p,m] * row_pm[q*F + f]
//     logit_pm = sum_q wq[q,p,m] * row_pm[4F + 32q + cand_idx[m]]
//     sig_pm   = sigmoid(clamp(logit_pm))          (clamp to [-2, 5] if set)
//     cand_w_m = prod_p sig_pm
//     feature  = sum_m cand_w_m * valid_m * feat_m
// Given dfeature (B, F, n) and dcand_w (B, M, n) this kernel recomputes
// those intermediates and emits, as _combine_bwd does,
//     dfeat_m   = cand_w_m * valid_m * dfeature            (per channel f)
//     dcw_m     = valid_m * <dfeature, feat_m> + dcand_w_m
//     dlogit_pm = dcw_m * cand_w_m * (1 - sig_pm)          (the clamp passes
//                                                           the gradient on)
//     dtable[row_pm][q*F + f]            += wq[q,p,m] * dfeat_m[f]
//     dtable[row_pm][4F + 32q + idx_m]   += wq[q,p,m] * dlogit_pm
//     dwq4[q,p,m] = <row_pm[q*F:], dfeat_m> + row_pm[4F+32q+idx_m] * dlogit_pm
// in float32. valid takes no gradient (it comes from a bool).
//
// What bounds it: bytes, as the forward: each (point, candidate, plane)
// reads its 512-byte row again, and writes its row gradient into a float32
// table of (B, R, 256) by atomic adds, which land in L2 (the float32 table is
// 203 MB a batch item at 256^2 planes, so the adds also spill to HBM).
//
// Design: one warp per (b, point), lane = channel, as the forward. The
// row-gradient tensor (B, 3, M, n, 256) that the XLA VJP materialises (and
// then scatter-adds) never exists: every lane adds its channel's gradient
// straight into the table (one fully used 128-byte segment of float32 per
// corner and warp), and the lane of the candidate's bone adds the mask
// logit's. A candidate whose weight cand_w * valid is 0 has a zero feature
// gradient, and the warp skips those adds. The 13 dot products a candidate
// needs (<dfeature, feat_m> and the 12 dwq4 sums over channels) are warp
// reductions by shuffles. The atomics make the order of each sum vary from
// run to run, as the reference's CUDA sampler's backward does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 32;           // feature lanes = warp width
constexpr int kMaskBlock = 32;   // lanes per mask corner block
constexpr int kRowWidth = 4 * kF + 4 * kMaskBlock;
constexpr int kWarps = 8;        // points per block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
unirow_combine_bwd_kernel(const __nv_bfloat16* __restrict__ table,
                          const int32_t* __restrict__ rows,
                          const float* __restrict__ wq4,
                          const int32_t* __restrict__ cand_idx,
                          const float* __restrict__ valid,
                          const float* __restrict__ dfeature,
                          const float* __restrict__ dcand_w,
                          float* __restrict__ dtable,
                          float* __restrict__ dwq4,
                          int R, int M, int n, int clamp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int pt = blockIdx.x * kWarps + warp;
  if (pt >= n) return;                                     // warp-uniform

  const int64_t plane_stride = (int64_t)M * n;
  const __nv_bfloat16* tb = table + (int64_t)b * R * kRowWidth;
  float* dtb = dtable + (int64_t)b * R * kRowWidth;
  const int32_t* rows_b = rows + (int64_t)b * 3 * plane_stride;
  const float* wq_b = wq4 + (int64_t)b * 12 * plane_stride;
  float* dwq_b = dwq4 + (int64_t)b * 12 * plane_stride;
  const float df = dfeature[((int64_t)b * kF + lane) * n + pt];

  for (int m = 0; m < M; ++m) {
    const int64_t mi = (int64_t)m * n + pt;
    const int64_t bmi = (int64_t)b * plane_stride + mi;
    const int idx = cand_idx[bmi] & 31;
    const float v = valid[bmi];

    // recompute: corner feature lanes, the bone's mask logit, sigmoids
    float fq[3][4], w[3][4], sel[3][4], sig[3];
    int64_t row[3];
    float feat = 0.f;
    float cw = 1.f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      row[p] = (int64_t)rows_b[p * plane_stride + mi];
      const __nv_bfloat16* r = tb + row[p] * kRowWidth;
      float logit = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[p][q] = wq_b[(q * 3 + p) * plane_stride + mi];
        fq[p][q] = __bfloat162float(r[q * kF + lane]);
        feat += w[p][q] * fq[p][q];
        sel[p][q] = __shfl_sync(
            0xffffffffu, __bfloat162float(r[4 * kF + q * kMaskBlock + lane]),
            idx);
        logit += w[p][q] * sel[p][q];
      }
      if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
      sig[p] = 1.f / (1.f + expf(-logit));
      cw *= sig[p];
    }

    // backward
    const float wpt = cw * v;
    const float dfeat = wpt * df;
    const float dcw = warp_sum(df * feat) * v + dcand_w[bmi];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float dlogit = dcw * cw * (1.f - sig[p]);
      float* dr = dtb + row[p] * kRowWidth;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float dw = warp_sum(fq[p][q] * dfeat) + sel[p][q] * dlogit;
        if (lane == 0) dwq_b[(q * 3 + p) * plane_stride + mi] = dw;
        if (wpt != 0.f) atomicAdd(dr + q * kF + lane, w[p][q] * dfeat);
        const float dm = w[p][q] * dlogit;
        if (lane == idx && dm != 0.f)
          atomicAdd(dr + 4 * kF + q * kMaskBlock + idx, dm);
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   table (B, R, 256) bf16; rows (B, 3, M, n) int32 row index within b;
//   wq4 (B, 4, 3, M, n) f32; cand_idx (B, M, n) int32 in [0, 32);
//   valid (B, M, n) f32; dfeature (B, 32, n) f32; dcand_w (B, M, n) f32
//   -> dtable (B, R, 256) f32, which the caller zeroes (the kernel adds into
//   it), and dwq4 (B, 4, 3, M, n) f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int unirow_combine_bwd_bf16(const void* table, const void* rows,
                                       const void* wq4, const void* cand_idx,
                                       const void* valid, const void* dfeature,
                                       const void* dcand_w, void* dtable,
                                       void* dwq4, int B, int R, int M, int n,
                                       int clamp, void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_combine_bwd_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)table, (const int32_t*)rows, (const float*)wq4,
      (const int32_t*)cand_idx, (const float*)valid, (const float*)dfeature,
      (const float*)dcand_w, (float*)dtable, (float*)dwq4, R, M, n, clamp);
  return (int)cudaGetLastError();
}
