// Unirow gather + combine, backward, for Hopper (sm_90a). Kernel 1b, on the
// bf16 texel table (float32 planes' backward is kernel 1bf,
// unirow_combine_bwd_f32.cu).
//
// Replaces the JAX package's hand VJP of the unirow combine,
// enarf_gan_tpu/ops/unirow.py::_combine_bwd (XLA, no Pallas), and the
// transpose of its row gather (the scatter-add of the row cotangents into
// the table that jnp.take's VJP does).
//
// The forward (csrc/unirow_combine.cu) computes, per (batch b, point i,
// candidate m, plane p), from the 4 corner texels of the texel table
// (ops/unirow.py::pack_texels, layout in unirow_texels.cuh):
//     feat_m   = sum_p sum_q wq[q,p,m] * texel_pq[f]
//     logit_pm = sum_q wq[q,p,m] * texel_pq[32 + cand_idx[m]]
//     sig_pm   = sigmoid(clamp(logit_pm))          (clamp to [-2, 5] if set)
//     cand_w_m = prod_p sig_pm
//     feature  = sum_m cand_w_m * valid_m * feat_m
// Given dfeature (B, F, n) and dcand_w (B, M, n) this kernel recomputes
// those intermediates and emits, as _combine_bwd does,
//     dfeat_m   = cand_w_m * valid_m * dfeature            (per channel f)
//     dcw_m     = valid_m * <dfeature, feat_m> + dcand_w_m
//     dlogit_pm = dcw_m * cand_w_m * (1 - sig_pm)          (the clamp passes
//                                                           the gradient on)
//     dtexel_pq[f]             += wq[q,p,m] * dfeat_m[f]
//     dtexel_pq[32 + idx_m]    += wq[q,p,m] * dlogit_pm
//     dwq4[q,p,m] = <texel_pq[:F], dfeat_m> + texel_pq[32+idx_m] * dlogit_pm
// in float32. valid takes no gradient (it comes from a bool).
//
// What bounds it: the atomic adds into the gradient, then bytes. It
// re-reads the forward's texels (mostly L2 hits, as the forward's), reads
// the inputs and dfeature once, and adds into a float32 texel gradient of
// (B, 3, H+2, W+2, 64): 51 MB an image at 256^2 planes (the TPU layout's
// (B, R, 256) float32 table gradient was 203 MB), so one image's gradient
// lines stay in L2 while its blocks run. The adds of the 4 cells that share
// a texel meet there in float32. Lanes 32+K..63 are never written. A valid
// candidate makes 48 sectors of feature adds (12 texels x 128 bytes) and
// 12 scattered 4-byte mask adds; the stage build (tools/ablate.py) measures
// each kind's share.
//
// Design: the forward's (one warp per point, half a warp a candidate, lane
// (h, q, c), see unirow_texels.cuh; 4 blocks an SM); the block stages its 8 points'
// dfeature through shared memory (32-byte coalesced reads). A
// candidate's 13 dot products (12 dwq4 and <dfeature, feat_m>) take one
// transposed butterfly over the 4 chunk lanes (3 shuffles: lane c ends with
// plane sum4_entry(c)'s <texel_qp, dfeature>) and a 16-lane sum (4
// shuffles); with the logits' 6, 13 shuffles a candidate. Each lane adds 8
// channels of its corner with two sm_90 vector reductions
// (red.global.add.v4.f32): channels 4c..4c+3 and 16+4c..16+4c+3, so each
// reduction instruction covers 64 contiguous bytes of every corner (whole
// 32-byte sectors; half as many sector operations as 8 consecutive channels
// a lane, and half as many instructions as scalar atomics). Lane (q, c) with
// plane sum4_entry(c) < 3 adds that plane's mask logit gradient. Zero adds
// are skipped: a candidate with cand_w * valid = 0, a corner with weight 0
// (a texel of the zero padding). The atomics make the order of each sum vary
// from run to run, as the reference's CUDA sampler's backward does.

#include "unirow_texels.cuh"

namespace {

using namespace unirow;

constexpr int kBwdBlocksPerSM = 4;   // at most 64 registers a thread

// Stage ablations (tools/ablate.py). The main entry point instantiates kFull
// only; built with -DUNIROW_STAGE_ENTRY the library also exports
// unirow_combine_bwd_stage_bf16, whose variants change only the adds:
//   kScalar   the feature adds as 8 scalar atomicAdds a lane;
//   kNoFeat   no feature adds (the mask adds and dwq4 as in kFull);
//   kNoMask   no mask adds (the feature adds and dwq4 as in kFull).
enum Stage { kFull = 0, kScalar = 1, kNoFeat = 2, kNoMask = 3 };

__device__ __forceinline__ void red_add_v4(float* addr, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

template <typename T, int kStage>
__global__ void __launch_bounds__(kWarps * 32, kBwdBlocksPerSM)
unirow_combine_bwd_kernel(const T* __restrict__ tex,
                          const int32_t* __restrict__ rows,
                          const float* __restrict__ wq4,
                          const int32_t* __restrict__ cand_idx,
                          const float* __restrict__ valid,
                          const float* __restrict__ dfeature,
                          const float* __restrict__ dcand_w,
                          float* __restrict__ dtex,
                          float* __restrict__ dwq4,
                          int H, int W, int M, int n, int clamp) {
  __shared__ float dft[kF][kWarps + 1];
  const Lane L = lane_of(threadIdx.x);
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kWarps;
  const int pt = pt0 + warp;
  {
    const int f = threadIdx.x / kWarps;
    const int j = threadIdx.x % kWarps;
    dft[f][j] = pt0 + j < n
        ? __ldcs(dfeature + ((int64_t)b * kF + f) * n + pt0 + j) : 0.f;
  }
  __syncthreads();
  if (pt >= n) return;                                     // warp-uniform

  float df[8];                     // the lane's texel channels: the dots
  float dr[8];                     // 4c..4c+3, 16+4c..16+4c+3: the adds
#pragma unroll
  for (int j = 0; j < 8; ++j) df[j] = dft[Texel<T>::channel(L.c, j)][warp];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dr[j] = dft[4 * L.c + j][warp];
    dr[4 + j] = dft[16 + 4 * L.c + j][warp];
  }
  const Inputs<T> in = inputs_of(tex, rows, wq4, cand_idx, valid, b, H, W, M,
                                 n, pt);
  const float* dcw_p = dcand_w + (int64_t)b * M * n + pt;
  float* dtb = dtex + (int64_t)b * 3 * (H + 2) * (W + 2) * kTexel;
  float* dwq_p = dwq4 + (int64_t)b * 12 * M * n + pt;
  const int pe = sum4_entry(L.c);    // the plane this lane's dot sums end on

  for (int m0 = 0; m0 < M; m0 += 2) {                      // warp-uniform
    Cand<T> k;
    load_cand(k, in, L, m0 + L.h);
    const float dcw_in = k.active ? __ldcs(dcw_p + k.off) : 0.f;
    const Sig s = sigmoids(k, clamp);
    // <texel_qp chunk, dfeature chunk> per plane, then summed over the 4
    // chunk lanes: lane c holds plane pe's <texel_qp, dfeature>
    float d[4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float f[8];
      Texel<T>::unpack(k.feat[p], f);
      d[p] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) d[p] += f[j] * df[j];
    }
    d[3] = 0.f;
    const float dp = transpose_sum4(d, L.c);
    const bool has_plane = pe < 3;
    const float w_pe = has_plane ? pick3(k.w, pe) : 0.f;
    // <dfeature, feat_m> = sum over (q, p) of w_qp <texel_qp, dfeature>
    float g = w_pe * dp;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) g += __shfl_xor_sync(kAll, g, o);
    if (!k.active) continue;
    const float wt = s.cw * k.v;
    const float dcw = g * k.v + dcw_in;
    if (has_plane) {
      const float dlogit = dcw * s.cw * (1.f - pick3(s.sig, pe));
      __stcs(dwq_p + (L.q * 3 + pe) * in.ps + k.off,
             wt * dp + pick3(k.mask, pe) * dlogit);
      const float dm = w_pe * dlogit;
      if (kStage != kNoMask && dm != 0.f)
        atomicAdd(dtb + pick3(k.tex, pe) * kTexel + kF + k.idx, dm);
    }
    if (kStage == kNoFeat) continue;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float a = k.w[p] * wt;
      if (a == 0.f) continue;
      float* dst = dtb + k.tex[p] * kTexel + 4 * L.c;
      if (kStage == kScalar) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          atomicAdd(dst + j, a * dr[j]);
          atomicAdd(dst + 16 + j, a * dr[4 + j]);
        }
      } else {
        red_add_v4(dst, a * dr[0], a * dr[1], a * dr[2], a * dr[3]);
        red_add_v4(dst + 16, a * dr[4], a * dr[5], a * dr[6], a * dr[7]);
      }
    }
  }
}

template <typename T, int kStage>
int launch(const void* texels, const void* rows, const void* wq4,
           const void* cand_idx, const void* valid, const void* dfeature,
           const void* dcand_w, void* dtexels, void* dwq4, int B, int H,
           int W, int M, int n, int clamp, void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_combine_bwd_kernel<T, kStage>
      <<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)texels, (const int32_t*)rows, (const float*)wq4,
      (const int32_t*)cand_idx, (const float*)valid, (const float*)dfeature,
      (const float*)dcand_w, (float*)dtexels, (float*)dwq4, H, W, M, n,
      clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes), kernel 1b. Shapes, all
// contiguous:
//   texels (B, 3, H+2, W+2, 64) bf16; rows (B, 3, M, n) int32 cell rows;
//   wq4 (B, 4, 3, M, n) f32; cand_idx (B, M, n) int32 in [0, 32);
//   valid (B, M, n) f32; dfeature (B, 32, n) f32; dcand_w (B, M, n) f32
//   -> dtexels (B, 3, H+2, W+2, 64) f32, which the caller zeroes (the kernel
//   adds into it), and dwq4 (B, 4, 3, M, n) f32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int unirow_combine_bwd_bf16(const void* texels, const void* rows,
                                       const void* wq4, const void* cand_idx,
                                       const void* valid, const void* dfeature,
                                       const void* dcand_w, void* dtexels,
                                       void* dwq4, int B, int H, int W, int M,
                                       int n, int clamp, void* stream) {
  return launch<__nv_bfloat16, kFull>(texels, rows, wq4, cand_idx, valid,
                                      dfeature, dcand_w, dtexels, dwq4, B, H,
                                      W, M, n, clamp, stream);
}

#ifdef UNIROW_STAGE_ENTRY
// The stage ablations: unirow_combine_bwd_bf16's arguments and outputs, with
// `stage` one of Stage (0 full, 1 scalar, 2 nofeat, 3 nomask).
extern "C" int unirow_combine_bwd_stage_bf16(
    const void* texels, const void* rows, const void* wq4,
    const void* cand_idx, const void* valid, const void* dfeature,
    const void* dcand_w, void* dtexels, void* dwq4, int B, int H, int W,
    int M, int n, int clamp, int stage, void* stream) {
#define UNIROW_STAGE_CASE(K)                                                 \
  case K:                                                                    \
    return launch<__nv_bfloat16, K>(texels, rows, wq4, cand_idx, valid,     \
                                    dfeature, dcand_w, dtexels, dwq4, B, H,  \
                                    W, M, n, clamp, stream);
  switch (stage) {
    UNIROW_STAGE_CASE(kFull)
    UNIROW_STAGE_CASE(kScalar)
    UNIROW_STAGE_CASE(kNoFeat)
    UNIROW_STAGE_CASE(kNoMask)
  }
#undef UNIROW_STAGE_CASE
  return (int)cudaErrorInvalidValue;
}
#endif  // UNIROW_STAGE_ENTRY
