// Patch-window (tilewin) gather + combine for Hopper (sm_90a), forward (the
// backward is tilewin_combine_bwd.cu).
//
// Replaces the TPU Pallas kernel
// enarf_gan_tpu/ops/tilewin_kernel.py::_combine_kernel_hat (launched by
// _hat_combine_call through tilewin_combine), and also does the window-row
// gathers that the JAX package runs outside that kernel (the two jnp.take of
// ops/tilewin.py::_fused_plan).
//
// A unit is one (pixel patch, depth sample); it has M member rays (M = 16 for
// a 4x4 patch, M = 4 on the coarse-corner pass) and Mp candidate-bone slots.
// The kernel reads the texel table (ops/unirow.py::pack_texels: the
// one-texel zero-padded planes, (B, 3, H+2, W+2, 64) bf16, one 128-byte line
// a texel: 32 feature lanes, then bone k's mask logit at lane 32 + k). For
// every (batch b, unit u, slot g, plane p) the plan names the base texel of
// the group's 8x8 window and the slot's bone. Member j sits at in-window
// position (xt, xs) in [0, 7); with i = floor(xt), k = floor(xs) (at most 6)
// and ft = xt - i, fs = xs - k it reads the texels (i..i+1, k..k+1) from the
// base and computes
//     S_g[j, f]   = sum_p bilinear(feature_p, f)
//     logit_gp[j] = valid_g[j] * bilinear(mask_p of the slot's bone)
//                   (clamped to [-2, 5])
//     cand_w_g[j] = prod_p sigmoid(logit_gp[j])
//     feature[j, f] = sum_g cand_w_g[j] * valid_g[j] * S_g[j, f]
// in float32. The bilinear weights are the values of the TPU kernel's hats
// max(0, 1 - |texel - x|); the TPU's one-hot MXU contraction existed because
// the TPU cannot address single texels, and is not carried over. The TPU's
// window rows (every stride-2 window of the planes packed whole, 198 MB of
// features and 142 MB of masks an image at 256^2 planes) held each texel up
// to 16 times; the texel table holds it once, 25.6 MB an image.
//
// What bounds it: bytes. The function needs only the 2x2 texels each valid
// member touches: one 64-byte feature half a texel (32 bf16 channels) and one
// 32-byte mask sector, every distinct one read once (an invalid member's
// feature is weighted by 0 and its logit is 0). At B = 1 (a frame) the
// table is 25.6 MB and stays in the 50 MB L2, so the re-reads of texels that
// neighbouring units and slots share cost L2 bandwidth, not HBM's. The
// distinct texels depend on the data (chip_smoke.py counts them); in a
// rendered frame the coordinates (xt, xs, valid, bases, bones) and the
// outputs weigh more than the table reads, and the bound of a fine launch
// is a few tens of microseconds. What this kernel spends is the load
// instructions: 64 two-byte-a-lane loads per (unit, slot, plane) for the
// features, mostly L1 and L2 hits; its stage build measures them at over
// half its time, with the table in L2 as before it in HBM (PERF.md). The
// arithmetic is 4 multiply-adds per (member, channel, plane).
//
// Design:
// * One warp per unit, 8 units per block. Lane f owns channel f. The warp
//   reads only the 2x2 texels its members touch, straight from the table
//   (64 B per texel, one fully used segment per warp load): the 16 members
//   of a fine unit cluster within a few texels, so their quads overlap and
//   the re-reads hit L1. Invalid members' texels are read too: skipping
//   them behind a per-member branch breaks up the unrolled loads (PERF.md).
// * The coordinates (B, 3, Mp, M, U) and validity (B, Mp, M, U) are unit-
//   minor; the block stages its 8 units of each row in shared memory, so
//   each 32-byte sector is read once.
// * Lane j < M computes member j's mask logit from the bone's lane of its
//   four texels and keeps its running product of sigmoids; a shuffle
//   broadcasts cand_w * valid to the 32 channel lanes.
// * Outputs are written in their final layouts, feature (B, F, n) with the
//   tiled point order n = (patch * M + member) * S + sample and cand_w
//   (B, Mp, n_patch, M, S), through shared memory so that the block's 8
//   consecutive samples of one row go out together. Nothing is transposed
//   afterwards, and U needs no padding: the kernel masks its ragged edge.

#include "tilewin_texels.cuh"

namespace {

using namespace tilewin;

// bilinear() of four equal texels v
__device__ __forceinline__ float bilinear_const(float v, float ft, float fs) {
  return (1.f - ft) * ((1.f - fs) * v + fs * v) + ft * ((1.f - fs) * v + fs * v);
}

// Stage ablations (the Hopper counterparts of tools/probe_hat_ablate.py's
// variants). The main entry point instantiates kFull only; built with
// -DTILEWIN_STAGE_ENTRY the library also exports tilewin_combine_stage_bf16,
// whose doctored variants replace one stage each and still write what they
// read into the outputs (so nvcc drops no load the variant keeps):
//   kStream     no table reads: a feature texel reads as (base & 255) / 256
//               and a mask texel as bone / 256 (coordinates, validity, base
//               texels and bones are read, outputs written);
//   kNoWeights  the texels are read, the bilinear fractions are 0.5;
//   kNoMask     no mask read (no bone either): logit 0, so cand_w = 0.5^3;
//   kNoFeat     no feature texel read: every texel reads as 1.
enum Stage { kFull = 0, kStream = 1, kNoWeights = 2, kNoMask = 3, kNoFeat = 4 };

size_t smem_bytes(int Mp, int M) {
  const size_t coords = 2 * 3 * (size_t)Mp * M * kUnits;   // xt, xs
  const size_t slots = 2 * (size_t)Mp * M * kUnits;        // valid, cand_w
  const size_t feat = (size_t)kF * (M * kUnits + 1);       // padded rows
  return (coords + slots + feat) * sizeof(float);
}

template <int M, int kStage = kFull>
__global__ void __launch_bounds__(kUnits * 32)
tilewin_combine_kernel(const __nv_bfloat16* __restrict__ tex,
                       const int32_t* __restrict__ bases,
                       const int32_t* __restrict__ bones,
                       const float* __restrict__ xt,
                       const float* __restrict__ xs,
                       const float* __restrict__ valid,
                       float* __restrict__ feature,
                       float* __restrict__ cand_w,
                       int Wp, int Mp, int U, int S, int clamp) {
  extern __shared__ float smem[];
  const int coord_n = 3 * Mp * M * kUnits;
  const int slot_n = Mp * M * kUnits;
  constexpr int kPitch = M * kUnits + 1;   // odd: lanes hit distinct banks
  float* s_xt = smem;                      // [3][Mp][M][kUnits]
  float* s_xs = s_xt + coord_n;
  float* s_valid = s_xs + coord_n;         // [Mp][M][kUnits]
  float* s_candw = s_valid + slot_n;       // [Mp][M][kUnits]
  float* s_feat = s_candw + slot_n;        // [kF][kPitch]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int u0 = blockIdx.x * kUnits;
  const int u = u0 + warp;

  const int64_t cbase = (int64_t)b * 3 * Mp * M * U;
  for (int e = threadIdx.x; e < coord_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int64_t off = cbase + (int64_t)(e / kUnits) * U + u0 + w;
    const bool ok = u0 + w < U;
    s_xt[e] = ok ? xt[off] : 0.f;
    s_xs[e] = ok ? xs[off] : 0.f;
  }
  const int64_t vbase = (int64_t)b * Mp * M * U;
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    s_valid[e] = (u0 + w < U)
        ? valid[vbase + (int64_t)(e / kUnits) * U + u0 + w] : 0.f;
  }
  __syncthreads();

  float acc[M];
#pragma unroll
  for (int j = 0; j < M; ++j) acc[j] = 0.f;

  if (u < U) {   // warp-uniform
    for (int g = 0; g < Mp; ++g) {
      float sg[M];
#pragma unroll
      for (int j = 0; j < M; ++j) sg[j] = 0.f;
      float cw = 1.f;                      // member `lane`'s cand_w (lane < M)
      const float v_lane =
          lane < M ? s_valid[(g * M + lane) * kUnits + warp] : 0.f;
      const int bone =
          kStage == kNoMask ? 0 : __ldg(bones + ((int64_t)b * Mp + g) * U + u);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int64_t ri = (((int64_t)b * 3 + p) * Mp + g) * U + u;
        const int32_t base = __ldg(bases + ri);
        const float* cx = s_xt + (p * Mp + g) * M * kUnits + warp;
        const float* cy = s_xs + (p * Mp + g) * M * kUnits + warp;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          int i, k;
          float ft, fs;
          texel_cell(cx[j * kUnits], i, ft);
          texel_cell(cy[j * kUnits], k, fs);
          if constexpr (kStage == kNoWeights) ft = fs = 0.5f;
          if constexpr (kStage == kStream)
            sg[j] += bilinear_const((float)(base & 255) * (1.f / 256.f), ft,
                                    fs);
          else if constexpr (kStage == kNoFeat)
            sg[j] += bilinear_const(1.f, ft, fs);
          else
            sg[j] += bilinear(tex + lane, quad_texel(base, i, k, Wp), Wp, ft,
                              fs);
        }
        if (lane < M) {
          int i, k;
          float ft, fs;
          texel_cell(cx[lane * kUnits], i, ft);
          texel_cell(cy[lane * kUnits], k, fs);
          if constexpr (kStage == kNoWeights) ft = fs = 0.5f;
          float logit;
          if constexpr (kStage == kNoMask)
            logit = 0.f;
          else if constexpr (kStage == kStream)
            logit = v_lane *
                    bilinear_const((float)(bone & 255) * (1.f / 256.f), ft, fs);
          else
            logit = v_lane * bilinear(tex + kF + bone,
                                      quad_texel(base, i, k, Wp), Wp, ft, fs);
          if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
          cw *= 1.f / (1.f + expf(-logit));
        }
      }
      if (lane < M) s_candw[(g * M + lane) * kUnits + warp] = cw;
      const float cwv = cw * v_lane;
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc[j] += __shfl_sync(kAll, cwv, j) * sg[j];
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j)
    s_feat[lane * kPitch + j * kUnits + warp] = acc[j];
  __syncthreads();

  // feature (B, F, n): point (patch * M + j) * S + s of unit u = patch * S + s
  const int64_t n = (int64_t)U * M;
  for (int e = threadIdx.x; e < kF * M * kUnits; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % M;
    const int f = e / (kUnits * M);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    feature[((int64_t)b * kF + f) * n + ((int64_t)patch * M + j) * S + s] =
        s_feat[f * kPitch + j * kUnits + w];
  }
  // cand_w (B, Mp, n_patch, M, S)
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % M;
    const int g = e / (kUnits * M);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    cand_w[((int64_t)b * Mp + g) * n + ((int64_t)patch * M + j) * S + s] =
        s_candw[e];
  }
}

template <int M, int kStage = kFull>
int launch(const void* texels, const void* bases, const void* bones,
           const void* xt, const void* xs, const void* valid, void* feature,
           void* cand_w, int B, int H, int W, int Mp, int U, int S, int clamp,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Mp, M);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tilewin_combine_kernel<M, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((U + kUnits - 1) / kUnits, B);
  tilewin_combine_kernel<M, kStage><<<grid, kUnits * 32, smem, stream>>>(
      (const __nv_bfloat16*)texels, (const int32_t*)bases,
      (const int32_t*)bones, (const float*)xt, (const float*)xs,
      (const float*)valid, (float*)feature, (float*)cand_w, W + 2, Mp, U, S,
      clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (for the wrapper's report).
extern "C" int tilewin_combine_smem_bytes(int Mp, int M) {
  return (int)smem_bytes(Mp, M);
}

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   texels (B, 3, H+2, W+2, 64) bf16; bases (B, 3, Mp, U) int32 window base
//   texels over the whole table; bones (B, Mp, U) int32 in [0, 32);
//   xt, xs (B, 3, Mp, M, U) f32 in [0, 7); valid (B, Mp, M, U) f32
//   -> feature (B, 32, U*M) f32, cand_w (B, Mp, U/S, M, S) f32.
// M is 4 or 16; S divides U. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tilewin_combine_bf16(const void* texels, const void* bases,
                                    const void* bones, const void* xt,
                                    const void* xs, const void* valid,
                                    void* feature, void* cand_w, int B, int H,
                                    int W, int Mp, int M, int U, int S,
                                    int clamp, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 16)
    return launch<16>(texels, bases, bones, xt, xs, valid, feature, cand_w, B,
                      H, W, Mp, U, S, clamp, st);
  if (M == 4)
    return launch<4>(texels, bases, bones, xt, xs, valid, feature, cand_w, B,
                     H, W, Mp, U, S, clamp, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef TILEWIN_STAGE_ENTRY
namespace {
template <int M>
int launch_stage(int stage, const void* texels, const void* bases,
                 const void* bones, const void* xt, const void* xs,
                 const void* valid, void* feature, void* cand_w, int B, int H,
                 int W, int Mp, int U, int S, int clamp, cudaStream_t st) {
#define TILEWIN_STAGE_CASE(K)                                                \
  case K:                                                                    \
    return launch<M, K>(texels, bases, bones, xt, xs, valid, feature, cand_w, \
                        B, H, W, Mp, U, S, clamp, st);
  switch (stage) {
    TILEWIN_STAGE_CASE(kFull)
    TILEWIN_STAGE_CASE(kStream)
    TILEWIN_STAGE_CASE(kNoWeights)
    TILEWIN_STAGE_CASE(kNoMask)
    TILEWIN_STAGE_CASE(kNoFeat)
  }
#undef TILEWIN_STAGE_CASE
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// The stage ablations: tilewin_combine_bf16's arguments and outputs, with
// `stage` one of Stage (0 full, 1 stream, 2 noweights, 3 nomask, 4 nofeat).
extern "C" int tilewin_combine_stage_bf16(
    const void* texels, const void* bases, const void* bones, const void* xt,
    const void* xs, const void* valid, void* feature, void* cand_w, int B,
    int H, int W, int Mp, int M, int U, int S, int clamp, int stage,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 16)
    return launch_stage<16>(stage, texels, bases, bones, xt, xs, valid,
                            feature, cand_w, B, H, W, Mp, U, S, clamp, st);
  if (M == 4)
    return launch_stage<4>(stage, texels, bases, bones, xt, xs, valid, feature,
                           cand_w, B, H, W, Mp, U, S, clamp, st);
  return (int)cudaErrorInvalidValue;
}
#endif  // TILEWIN_STAGE_ENTRY
