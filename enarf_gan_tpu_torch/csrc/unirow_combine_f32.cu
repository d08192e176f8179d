// Kernel 1f: the float32 candidate sampler for Hopper (sm_90a), forward
// (the backward, kernel 1bf, is unirow_combine_bwd_f32.cu; both share
// unirow_f32.cuh).
//
// Replaces what the JAX package runs for float32 planes (no Pallas kernel):
// enarf_gan_tpu/ops/quadtable.py::sample_candidates_quadtable, the cells and
// corner weights of _quad_cells_weights, XLA's row gathers of a feature-quad
// and a bone-folded mask-quad table, and the combine. For every (batch b,
// point i, candidate m) it computes, from the candidate's position, each
// plane's cell and corner weights wq[q,p], then
//     feat_m   = sum_p sum_q wq[q,p] * feature_p[corner q][f]
//     logit_pm = sum_q wq[q,p] * mask_p[cand_idx[m]][corner q]
//     cand_w_m = prod_p sigmoid(logit_pm)          (logit clamped to [-2, 5]
//                                                   when clamp is set)
//     feature  = sum_m cand_w_m * valid_m * feat_m
// in float32, and writes cand_w as (B, n, M), the caller's layout.
//
// What bounds it: bytes, read at data-dependent addresses. Per (point,
// candidate, plane) the function needs the 128-byte feature lines of the
// corners of nonzero weight of a valid candidate, and the mask sectors
// holding the candidate bone's 4 corners (every candidate's cand_w needs
// them): with the masks bone-major, (t, s) and (t, s+1) are neighbouring
// floats, so a plane's 4 corners lie in 2 sectors but where s+1 starts a new
// one. The tables of ops/unirow.py::pack_texels_f32 take 25.6 MB (feature)
// and 18.4 MB (23 bones' masks) an image at 256^2 planes: 44 MB together, in
// the H100's 50 MB L2 while an image's blocks run (the grid walks the points
// image by image). The earlier design (the bf16 kernel's template on
// float32 texels) read a 64-lane float32 texel table, 51.1 MB an image, and
// streamed per-candidate cells and corner weights (rows, wq4: 63 MB a fine
// chunk) that 132 PyTorch launches had computed; here the inputs are the
// positions, bones and valid bytes, 17 bytes a candidate.
//
// Design: one warp per (b, point); the warp loads its point's inputs for 6
// candidates in one instruction (unirow_f32.cuh: load_inputs); the 16 lanes
// of each half-warp serve one candidate at a time (half h takes candidates
// h, h+2, ...), lane (q, c) computes its corner q's cell and weight on each
// plane (a few float operations, rounded as PyTorch rounds them) and loads
// channels 4c..4c+3 and 16+4c..16+4c+3 of that corner's feature line (two
// 16-byte loads) and the candidate bone's mask value at the corner, all 9
// loads in flight before any is used; corners of weight 0 and the features
// of invalid candidates are not loaded. 4 blocks of 8 warps an SM (at most 64
// registers). Each lane keeps 8 channels' sums over its candidates; one
// transposed butterfly (7 shuffles) sums them over the 8 lanes that share a
// chunk, and the (B, F, n) output is written through shared memory, 8
// consecutive points a row. ptxas (nvcc 12.9, sm_90a; chip_smoke.py's
// build prints it): 64 registers, no spills, 1,152 bytes of shared memory.

#include "unirow_f32.cuh"

namespace {

using namespace unirow_f32;

constexpr int kChunk = 6;            // candidates a warp's input load covers
constexpr int kBlocksPerSM = 4;      // at most 64 registers a thread

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
unirow_f32_kernel(const float* __restrict__ feat,
                  const float* __restrict__ mask,
                  const float* __restrict__ pos,
                  const int32_t* __restrict__ cand_idx,
                  const uint8_t* __restrict__ valid,
                  float* __restrict__ feature,
                  float* __restrict__ cand_w,
                  int H, int W, int K, int M, int n, int clamp) {
  __shared__ float tile[kF][kWarps + 1];
  const Lane L = unirow::lane_of(threadIdx.x);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int pt0 = blockIdx.x * kWarps;
  const int pt = pt0 + warp;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (pt < n) {                                            // warp-uniform
    const Tables T = tables_of(feat, mask, b, H, W, K);
    const int64_t at = ((int64_t)b * n + pt) * M;          // (b, pt, m = 0)
    float gx, gy;                                          // unused here
    for (int m0 = 0; m0 < M; m0 += kChunk) {               // warp-uniform
      const uint32_t in = load_inputs<kChunk, false>(
          pos + at * 3, cand_idx + at, valid + at, nullptr, M, m0, lane);
      const int nc = min(kChunk, M - m0);
      for (int j0 = 0; j0 < nc; j0 += 2) {                 // warp-uniform
        const int j = j0 + L.h;
        const bool active = j < nc;
        const Cand k = cand_of<kChunk, false>(in, j, K);
        Loaded d;
        load_planes<false>(d, k, active, T, L, gx, gy, 0);
        const Sig s = sigmoids(d, clamp);
        const float wt = s.cw * k.v;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          float f[8];
          unpack(d.lo[p], d.hi[p], f);
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] += wt * d.w[p] * f[i];
        }
        if (active && L.q == 0 && L.c == 0)
          __stcs(cand_w + at + m0 + j, s.cw);
      }
    }
  }
  // sum over the 8 lanes (h, q) that share lane c's channels: lane (h, q, c)
  // ends with its entry 4h + q
  const float total = unirow::transpose_sum8(acc, L);
  tile[channel(L.c, 4 * L.h + L.q)][warp] = total;
  __syncthreads();
  const int f = threadIdx.x / kWarps;
  const int j = threadIdx.x % kWarps;
  if (pt0 + j < n)
    __stcs(feature + ((int64_t)b * kF + f) * n + pt0 + j, tile[f][j]);
}

}  // namespace

// Plain C entry point (loaded with ctypes), kernel 1f. Shapes, all
// contiguous: feat (B, 3, H+2, W+2, 32) f32, mask (B, 3, K, H+2, W+2) f32
// (ops/unirow.py::pack_texels_f32); cand_pos (B, n, M, 3) f32; cand_idx
// (B, n, M) int32; cand_valid (B, n, M) bool -> feature (B, 32, n) f32,
// cand_w (B, n, M) f32. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int unirow_combine_f32(const void* feat, const void* mask,
                                  const void* cand_pos, const void* cand_idx,
                                  const void* cand_valid, void* feature,
                                  void* cand_w, int B, int H, int W, int K,
                                  int M, int n, int clamp, void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_f32_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)mask, (const float*)cand_pos,
      (const int32_t*)cand_idx, (const uint8_t*)cand_valid, (float*)feature,
      (float*)cand_w, H, W, K, M, n, clamp);
  return (int)cudaGetLastError();
}
