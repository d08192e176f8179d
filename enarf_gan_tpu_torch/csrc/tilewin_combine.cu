// Patch-window (tilewin) gather + combine for Hopper (sm_90a), forward only.
//
// Replaces the TPU Pallas kernel
// enarf_gan_tpu/ops/tilewin_kernel.py::_combine_kernel_hat (launched by
// _hat_combine_call through tilewin_combine), and also does the window-row
// gathers that the JAX package runs outside that kernel (the two jnp.take of
// ops/tilewin.py::_fused_plan).
//
// A unit is one (pixel patch, depth sample); it has M member rays (M = 16 for
// a 4x4 patch, M = 4 on the coarse-corner pass) and Mp candidate-bone slots.
// For every (batch b, unit u, slot g, plane p) the kernel reads one packed
// window row of the feature table (ops/tilewin.py::pack_tilewin: the 8x8
// texels of a 32-channel window, texel-major, 4096 B of bf16) and one
// 64-texel mask row (128 B) of the slot's bone. Member j sits at in-window
// position (xt, xs) in [0, 7); with i = floor(xt), k = floor(xs) (at most 6)
// and ft = xt - i, fs = xs - k it computes
//     S_g[j, f]   = sum_p bilinear(window_p, f)  over texels (i..i+1, k..k+1)
//     logit_gp[j] = valid_g[j] * bilinear(mask_p)  (clamped to [-2, 5])
//     cand_w_g[j] = prod_p sigmoid(logit_gp[j])
//     feature[j, f] = sum_g cand_w_g[j] * valid_g[j] * S_g[j, f]
// in float32. The bilinear weights are the values of the TPU kernel's hats
// max(0, 1 - |texel - x|); the TPU's one-hot MXU contraction existed because
// the TPU cannot address single texels, and is not carried over.
//
// What bounds it: bytes. The function needs, of the tables, only the 2x2
// texels each valid member touches: one 64-byte feature texel (32 bf16
// channels) and one 32-byte mask sector each, every distinct one read once
// (an invalid member's feature is weighted by 0 and its logit is 0). Window
// rows repeat across neighbouring units and a unit touches a few of a row's
// 64 texels, so that floor depends on the data; chip_smoke.py counts the
// distinct texels and sectors of each launch. In a rendered frame the
// coordinates (xt, xs, valid) and the outputs then weigh more than the table
// reads, and the floor is about 20 microseconds a fine launch, far below
// what this simple kernel's load and multiply-add issue takes (PERF.md).
// The arithmetic is 4 multiply-adds per (member, channel, plane): tiny next
// to the bytes.
//
// Design:
// * One warp per unit, 8 units per block. Lane f owns channel f. The warp
//   reads only the 2x2 texels its members touch, straight from the table
//   (64 B per texel, one fully used segment per warp load), never the whole
//   4 KB row: a coarse-corner unit (M = 4) touches at most 16 of the 64
//   texels, and the 16 members of a fine unit cluster within a few texels,
//   so their quads overlap and the re-reads hit L1. Staging every row in
//   shared memory would read all 4 KB of it whatever the members touch.
//   Invalid members' texels are read too: skipping them behind a per-member
//   branch breaks up the unrolled loads; it saved 7% of the kernel's time
//   in a rendered frame and cost 14% on chip_smoke.py's 80%-valid chunk
//   (PERF.md).
// * The coordinates (B, 3, Mp, M, U) and validity (B, Mp, M, U) are unit-
//   minor; the block stages its 8 units of each row in shared memory, so
//   each 32-byte sector is read once.
// * Lane j < M computes member j's mask logit from the 128-byte mask row
//   and keeps its running product of sigmoids; a shuffle broadcasts
//   cand_w * valid to the 32 channel lanes.
// * Outputs are written in their final layouts, feature (B, F, n) with the
//   tiled point order n = (patch * M + member) * S + sample and cand_w
//   (B, Mp, n_patch, M, S), through shared memory so that the block's 8
//   consecutive samples of one row go out together. Nothing is transposed
//   afterwards, and U needs no padding: the kernel masks its ragged edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 32;            // channels = warp width
constexpr int kWin = 8;           // window side, texels
constexpr int kNTex = kWin * kWin;
constexpr int kRow = kNTex * kF;  // bf16 per feature window row
constexpr int kUnits = 8;         // units per block = warps per block

__device__ __forceinline__ void texel_cell(float x, int& i, float& frac) {
  // x in [0, 7); an f32 sum of offset + fraction may round up to 7.0, which
  // then puts all the weight on texel 7, as the TPU kernel's hats do
  const float c = fminf(floorf(x), (float)(kWin - 2));
  i = (int)c;
  frac = x - c;
}

__device__ __forceinline__ float bilinear(const __nv_bfloat16* q, int dt,
                                          int ds, float ft, float fs) {
  const float v00 = __bfloat162float(q[0]);
  const float v01 = __bfloat162float(q[ds]);
  const float v10 = __bfloat162float(q[dt]);
  const float v11 = __bfloat162float(q[dt + ds]);
  return (1.f - ft) * ((1.f - fs) * v00 + fs * v01) +
         ft * ((1.f - fs) * v10 + fs * v11);
}

size_t smem_bytes(int Mp, int M) {
  const size_t coords = 2 * 3 * (size_t)Mp * M * kUnits;   // xt, xs
  const size_t slots = 2 * (size_t)Mp * M * kUnits;        // valid, cand_w
  const size_t feat = (size_t)kF * (M * kUnits + 1);       // padded rows
  return (coords + slots + feat) * sizeof(float);
}

template <int M>
__global__ void __launch_bounds__(kUnits * 32)
tilewin_combine_kernel(const __nv_bfloat16* __restrict__ feat_table,
                       const __nv_bfloat16* __restrict__ mask_table,
                       const int32_t* __restrict__ frows,
                       const int32_t* __restrict__ mrows,
                       const float* __restrict__ xt,
                       const float* __restrict__ xs,
                       const float* __restrict__ valid,
                       float* __restrict__ feature,
                       float* __restrict__ cand_w,
                       int Mp, int U, int S, int clamp) {
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
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int64_t ri = (((int64_t)b * 3 + p) * Mp + g) * U + u;
        const __nv_bfloat16* frow =
            feat_table + (int64_t)__ldg(frows + ri) * kRow + lane;
        const __nv_bfloat16* mrow =
            mask_table + (int64_t)__ldg(mrows + ri) * kNTex;
        const float* cx = s_xt + (p * Mp + g) * M * kUnits + warp;
        const float* cy = s_xs + (p * Mp + g) * M * kUnits + warp;
#pragma unroll
        for (int j = 0; j < M; ++j) {
          int i, k;
          float ft, fs;
          texel_cell(cx[j * kUnits], i, ft);
          texel_cell(cy[j * kUnits], k, fs);
          sg[j] += bilinear(frow + (i * kWin + k) * kF, kWin * kF, kF, ft, fs);
        }
        if (lane < M) {
          int i, k;
          float ft, fs;
          texel_cell(cx[lane * kUnits], i, ft);
          texel_cell(cy[lane * kUnits], k, fs);
          float logit = v_lane * bilinear(mrow + i * kWin + k, kWin, 1, ft, fs);
          if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
          cw *= 1.f / (1.f + expf(-logit));
        }
      }
      if (lane < M) s_candw[(g * M + lane) * kUnits + warp] = cw;
      const float cwv = cw * v_lane;
#pragma unroll
      for (int j = 0; j < M; ++j)
        acc[j] += __shfl_sync(0xffffffffu, cwv, j) * sg[j];
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

template <int M>
int launch(const void* feat_table, const void* mask_table, const void* frows,
           const void* mrows, const void* xt, const void* xs,
           const void* valid, void* feature, void* cand_w, int B, int Mp,
           int U, int S, int clamp, cudaStream_t stream) {
  const size_t smem = smem_bytes(Mp, M);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tilewin_combine_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((U + kUnits - 1) / kUnits, B);
  tilewin_combine_kernel<M><<<grid, kUnits * 32, smem, stream>>>(
      (const __nv_bfloat16*)feat_table, (const __nv_bfloat16*)mask_table,
      (const int32_t*)frows, (const int32_t*)mrows, (const float*)xt,
      (const float*)xs, (const float*)valid, (float*)feature, (float*)cand_w,
      Mp, U, S, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (for the wrapper's report).
extern "C" int tilewin_combine_smem_bytes(int Mp, int M) {
  return (int)smem_bytes(Mp, M);
}

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   feat_table (R, 16, 128) bf16 window rows (64 texels x 32 channels);
//   mask_table (Rm, 64) bf16; frows, mrows (B, 3, Mp, U) int32 global rows;
//   xt, xs (B, 3, Mp, M, U) f32 in [0, 7); valid (B, Mp, M, U) f32
//   -> feature (B, 32, U*M) f32, cand_w (B, Mp, U/S, M, S) f32.
// M is 4 or 16; S divides U. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tilewin_combine_bf16(const void* feat_table,
                                    const void* mask_table, const void* frows,
                                    const void* mrows, const void* xt,
                                    const void* xs, const void* valid,
                                    void* feature, void* cand_w, int B, int Mp,
                                    int M, int U, int S, int clamp,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 16)
    return launch<16>(feat_table, mask_table, frows, mrows, xt, xs, valid,
                      feature, cand_w, B, Mp, U, S, clamp, st);
  if (M == 4)
    return launch<4>(feat_table, mask_table, frows, mrows, xt, xs, valid,
                     feature, cand_w, B, Mp, U, S, clamp, st);
  return (int)cudaErrorInvalidValue;
}
