// Unirow gather + combine for Hopper (sm_90a), forward (the backward is
// unirow_combine_bwd.cu; both share unirow_texels.cuh). Kernel 1, on the bf16
// texel table (float32 planes are sampled by kernel 1f,
// unirow_combine_f32.cu).
//
// Replaces the TPU Pallas kernel enarf_gan_tpu/ops/unirow.py::_combine_kernel
// (launched by _combine_pallas) and also does the row gather that the JAX
// package runs outside that kernel (jnp.take in sample_candidates_unirow).
//
// The table is the texel table of ops/unirow.py::pack_texels, not the TPU's
// quad rows: the one-texel zero-padded planes channels-last, (B, 3, H+2, W+2,
// 64) bf16 (one 128-byte line a texel), lanes [32 feature | 32 mask, bone k
// at lane 32+k]. Corner q of the cell of row r =
// p*(H+1)*(W+1) + t*(W+1) + s is texel (p, t + q/2, s + q%2). For every
// (batch b, point i, candidate m, plane p) the kernel computes
//     feat_m   = sum_p sum_q wq[q,p,m] * texel_pq[f]
//     logit_pm = sum_q wq[q,p,m] * texel_pq[32 + cand_idx[m]]
//     cand_w_m = prod_p sigmoid(logit_pm)          (logit clamped to [-2, 5]
//                                                   when clamp is set)
//     feature  = sum_m cand_w_m * valid_m * feat_m
// in float32.
//
// What bounds it: bytes, read at data-dependent addresses. Per (point,
// candidate, plane) the function needs the feature half of 4 texels (64
// bytes) and the one 32-byte sector of each that holds the candidate's mask
// logit: 384 bytes of sectors.
// The TPU's quad-row table (101 MB an image at 256^2 planes, every texel
// stored 4 times, half of each row the all-bone mask quads) was twice the
// H100's 50 MB L2, so most of its 512-byte row reads came from HBM. The bf16
// texel table is 25.6 MB an image and stays in L2 while the blocks of one
// image run (the grid walks the points image by image), so the texel reads
// are mostly L2 hits.
//
// Design: one warp per (b, point); the 16 lanes of each half-warp serve one
// candidate at a time (half h takes candidates h, h+2, ...), lane (q, c)
// 8 channels of corner q's feature half (unirow_texels.cuh: the 16-byte
// chunk c). A candidate's 12 texels (4 corners x 3 planes) are 3 16-byte
// loads a lane plus 3 mask loads (one sector a texel), all in flight before
// any is used; 5 blocks an SM keep 40 warps of them. The per-candidate inputs (rows, wq4,
// cand_idx, valid: 70 MB at a fine chunk, read once) are loaded with the
// streaming hint (ld.global.cs: evict-first in L1 and L2), so they do not
// push the texels out of L2. Each lane keeps 8 channels' sums over its
// candidates; one transposed butterfly (7 shuffles) sums them over the 8
// lanes that share a chunk, leaving one channel a lane, and the (B, F, n)
// output is written through shared memory, 8 consecutive points a row.

#include "unirow_texels.cuh"

namespace {

using namespace unirow;

// Blocks of 8 warps an SM (bf16: at most 65536 / (256 * 5) = 51 registers a
// thread): on the H100 more warps in flight hide the texel gathers' L2
// latency better than more loads a warp (two candidates a half-warp at 71
// registers, 3 blocks an SM, was slower).
template <typename T>
constexpr int kFwdBlocksPerSM = 5;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, kFwdBlocksPerSM<T>)
unirow_combine_kernel(const T* __restrict__ tex,
                      const int32_t* __restrict__ rows,
                      const float* __restrict__ wq4,
                      const int32_t* __restrict__ cand_idx,
                      const float* __restrict__ valid,
                      float* __restrict__ feature,
                      float* __restrict__ cand_w,
                      int H, int W, int M, int n, int clamp) {
  __shared__ float tile[kF][kWarps + 1];
  const Lane L = lane_of(threadIdx.x);
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kWarps;
  const int pt = pt0 + warp;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (pt < n) {                                            // warp-uniform
    const Inputs<T> in = inputs_of(tex, rows, wq4, cand_idx, valid, b, H, W,
                                   M, n, pt);
    float* cw_out = cand_w + (int64_t)b * M * n + pt;
    for (int m0 = 0; m0 < M; m0 += 2) {                  // warp-uniform
      Cand<T> k;
      load_cand(k, in, L, m0 + L.h);
      const Sig s = sigmoids(k, clamp);
      const float wt = s.cw * k.v;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float f[8];
        Texel<T>::unpack(k.feat[p], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += wt * k.w[p] * f[j];
      }
      if (k.active && L.q == 0 && L.c == 0) __stcs(cw_out + k.off, s.cw);
    }
  }
  // sum over the 8 lanes (h, q) that share lane c's channels: lane (h, q, c)
  // ends with its entry 4h + q
  const float total = transpose_sum8(acc, L);
  tile[Texel<T>::channel(L.c, 4 * L.h + L.q)][warp] = total;
  __syncthreads();
  const int f = threadIdx.x / kWarps;
  const int j = threadIdx.x % kWarps;
  if (pt0 + j < n)
    __stcs(feature + ((int64_t)b * kF + f) * n + pt0 + j, tile[f][j]);
}

template <typename T>
int launch(const void* texels, const void* rows, const void* wq4,
           const void* cand_idx, const void* valid, void* feature,
           void* cand_w, int B, int H, int W, int M, int n, int clamp,
           void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_combine_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)texels, (const int32_t*)rows, (const float*)wq4,
      (const int32_t*)cand_idx, (const float*)valid, (float*)feature,
      (float*)cand_w, H, W, M, n, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes), kernel 1. Shapes, all
// contiguous:
//   texels (B, 3, H+2, W+2, 64) bf16; rows (B, 3, M, n) int32 cell rows
//   p*(H+1)*(W+1) + t*(W+1) + s; wq4 (B, 4, 3, M, n) f32; cand_idx (B, M, n)
//   int32 in [0, 32); valid (B, M, n) f32 -> feature (B, 32, n) f32, cand_w
//   (B, M, n) f32.
// Launch on `stream` and return cudaGetLastError() (0 on success).
extern "C" int unirow_combine_bf16(const void* texels, const void* rows,
                                   const void* wq4, const void* cand_idx,
                                   const void* valid, void* feature,
                                   void* cand_w, int B, int H, int W, int M,
                                   int n, int clamp, void* stream) {
  return launch<__nv_bfloat16>(texels, rows, wq4, cand_idx, valid, feature,
                               cand_w, B, H, W, M, n, clamp, stream);
}
