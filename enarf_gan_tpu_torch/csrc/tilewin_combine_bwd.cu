// Patch-window (tilewin) gather + combine, backward, for Hopper (sm_90a),
// at M = 16 members a unit (the fine pass; the coarse-corner pass, M = 4,
// runs without gradients).
//
// Replaces the backward of the JAX package's fused tilewin sampler
// (enarf_gan_tpu/ops/tilewin.py::_fused_sampler's bwd, which recomputes the
// whole XLA path sample_tilewin and takes its VJP), and the transpose of the
// window-row gathers: the scatter-add of the row cotangents into the tables,
// which here is a scatter-add into the texel table's gradient.
//
// The forward (csrc/tilewin_combine.cu) computes, for batch b, unit u,
// slot g (bone k_g), plane p and member j at in-window position (xt, xs),
// with i = min(floor(xt), 6), k = min(floor(xs), 6), ft = xt - i,
// fs = xs - k, from the texels (i..i+1, k..k+1) of the group's window on the
// texel table (layout in tilewin_texels.cuh):
//     S_g[j, f]   = sum_p bilinear(texel features_p, f; i, k, ft, fs)
//     logit_gp[j] = valid_g[j] * bilinear(texel lane 32 + k_g, p)
//                   (clamped to [-2, 5])
//     cand_w_g[j] = prod_p sigmoid(logit_gp[j])
//     feature[j, f] = sum_g cand_w_g[j] * valid_g[j] * S_g[j, f]
// Given dfeature (B, F, n) in tiled point order and dcand_w
// (B, Mp, n_patch, M, S) this kernel recomputes S, the sigmoids and cand_w
// and emits, in float32,
//     dS_g[j, f]    = cand_w_g[j] * valid_g[j] * dfeature[j, f]
//     dcw_g[j]      = valid_g[j] * <S_g[j], dfeature[j]> + dcand_w_g[j]
//     dlogit_gp[j]  = dcw_g[j] * cand_w_g[j] * (1 - sigmoid_gp[j])
//                     (the clamp passes the gradient on, as the forward's
//                      straight-through clamp does)
//     dtexels[texel c][f]        += w_c * dS_g[j, f]            (4 corners c)
//     dtexels[texel c][32 + k_g] += w_c * valid_g[j] * dlogit_gp[j]
//     dxt, dxs = the derivatives of the bilinear forms in ft and fs, summed
//                over channels (feature) plus the mask logit's share.
// w_c are the bilinear corner weights (1-ft)(1-fs), (1-ft)fs, ft(1-fs),
// ft*fs. The fraction carries the whole derivative in x: i is locally
// constant, and an x clamped to texel 6 keeps d(ft)/dx = 1, as the TPU
// kernel's hats max(0, 1 - |t - x|) do at that edge.
//
// What bounds it: bytes. It reads what the forward reads (the 2x2 texels of
// every member, the coordinates) plus dfeature and dcand_w, and writes the
// float32 texel gradient, (B, 3, H+2, W+2, 64): 51 MB an image at 256^2
// planes, which the caller zeroes. The TPU layout's gradients were those of
// both window tables, 1.1 GB of float32 an image, zeroed and filled the same
// way. A window-row gradient was private to its window; a texel gradient is
// shared by every unit, slot and sample that touches the texel, and the 16
// members of a unit cluster within about 1.5 texels, so their adds meet on
// the same addresses.
//
// Design: one warp per unit, 8 units a block, lane = channel, as the
// forward. The block stages the coordinates, validity, dcand_w and dfeature
// of its 8 units in shared memory (coalesced over units). Per slot, the
// member lanes first compute the mask logits, sigmoids and cand_w (they need
// only the mask lanes of the texels); then one pass over the planes reads
// each member's four feature texels once and takes from them S_g (for dcw),
// the feature adds and the feature share of dxt, dxs; last the member lanes
// add the mask gradients and the mask share of dxt, dxs (a kernel that
// recomputes S in a pass of its own reads the feature texels twice). Each
// valid member adds its 4 corners straight into the table as 4 scalar
// reductions of 128 contiguous bytes (lane f, channel f). Two other ways of
// adding were measured slower on the card and dropped (PERF.md): a
// shared-memory 8x8 tile a warp, summing the unit's adds and flushing each
// touched texel once with 16-byte reductions (its 66 KB a block halve the
// warps an SM), and 16-byte reductions straight into the table. The
// per-member sums over channels (32 of them a plane: the t- and
// s-derivatives of 16 members) are one transposed butterfly over the warp,
// 31 shuffles, which leaves member j's sums on lanes j and j + 16. dxt and
// dxs go out through shared memory in the unit-minor layout of xt and xs.
// The atomics make the order of each sum vary from run to run, as the
// reference's CUDA sampler's backward does.

#include "tilewin_texels.cuh"

namespace {

using namespace tilewin;

constexpr int kM = 16;                 // members per unit

// a[0..2O) on every lane -> a[0..O): lanes with bit O keep the upper half,
// each summed with its partner lane's copy.
template <int O>
__device__ __forceinline__ void halve(float* a, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = up ? a[k] : a[k + O];
    const float keep = up ? a[k + O] : a[k];
    a[k] = keep + __shfl_xor_sync(kAll, send, O);
  }
}

// 32 values on each lane -> lane l returns the sum over lanes of a[l].
__device__ __forceinline__ float transpose_sum(float* a, int lane) {
  halve<16>(a, lane);
  halve<8>(a, lane);
  halve<4>(a, lane);
  halve<2>(a, lane);
  halve<1>(a, lane);
  return a[0];
}

size_t smem_bytes(int Mp) {
  const size_t coords = 4 * 3 * (size_t)Mp * kM * kUnits;  // xt, xs, dxt, dxs
  const size_t slots = 2 * (size_t)Mp * kM * kUnits;       // valid, dcand_w
  const size_t grad = (size_t)kF * (kM * kUnits + 1);      // dfeature
  return (coords + slots + grad) * sizeof(float);
}

__global__ void __launch_bounds__(kUnits * 32, 2)
tilewin_combine_bwd_kernel(const __nv_bfloat16* __restrict__ tex,
                           const int32_t* __restrict__ bases,
                           const int32_t* __restrict__ bones,
                           const float* __restrict__ xt,
                           const float* __restrict__ xs,
                           const float* __restrict__ valid,
                           const float* __restrict__ dfeature,
                           const float* __restrict__ dcand_w,
                           float* __restrict__ dtex,
                           float* __restrict__ dxt,
                           float* __restrict__ dxs,
                           int Wp, int Mp, int U, int S, int clamp) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int coord_n = 3 * Mp * kM * kUnits;
  const int slot_n = Mp * kM * kUnits;
  constexpr int kPitch = kM * kUnits + 1;   // odd: lanes hit distinct banks
  float* s_xt = smem;                       // [3][Mp][M][kUnits]
  float* s_xs = s_xt + coord_n;
  float* s_dxt = s_xs + coord_n;
  float* s_dxs = s_dxt + coord_n;
  float* s_valid = s_dxs + coord_n;         // [Mp][M][kUnits]
  float* s_dcw = s_valid + slot_n;          // [Mp][M][kUnits]
  float* s_df = s_dcw + slot_n;             // [kF][kPitch]

  const int b = blockIdx.y;
  const int u0 = blockIdx.x * kUnits;
  const int u = u0 + warp;
  const int64_t n = (int64_t)U * kM;

  const int64_t cbase = (int64_t)b * 3 * Mp * kM * U;
  for (int e = threadIdx.x; e < coord_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int64_t off = cbase + (int64_t)(e / kUnits) * U + u0 + w;
    const bool ok = u0 + w < U;
    s_xt[e] = ok ? xt[off] : 0.f;
    s_xs[e] = ok ? xs[off] : 0.f;
  }
  const int64_t vbase = (int64_t)b * Mp * kM * U;
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int g = e / (kUnits * kM);
    const int uu = u0 + w;
    const bool ok = uu < U;
    s_valid[e] = ok ? valid[vbase + (int64_t)(e / kUnits) * U + uu] : 0.f;
    const int patch = ok ? uu / S : 0;
    const int s = uu - patch * S;
    s_dcw[e] = ok ? dcand_w[((int64_t)b * Mp + g) * n +
                            ((int64_t)patch * kM + j) * S + s]
                  : 0.f;
  }
  for (int e = threadIdx.x; e < kF * kM * kUnits; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int f = e / (kUnits * kM);
    const int uu = u0 + w;
    const bool ok = uu < U;
    const int patch = ok ? uu / S : 0;
    const int s = uu - patch * S;
    s_df[f * kPitch + j * kUnits + w] =
        ok ? dfeature[((int64_t)b * kF + f) * n + ((int64_t)patch * kM + j) * S
                      + s]
           : 0.f;
  }
  __syncthreads();

  if (u < U) {   // warp-uniform
    float df[kM];
#pragma unroll
    for (int j = 0; j < kM; ++j) df[j] = s_df[lane * kPitch + j * kUnits + warp];

    for (int g = 0; g < Mp; ++g) {
      const float* vv = s_valid + g * kM * kUnits + warp;
      const float v_lane = lane < kM ? vv[lane * kUnits] : 0.f;
      const int bone = __ldg(bones + ((int64_t)b * Mp + g) * U + u);
      const __nv_bfloat16* ftex = tex + lane;
      const __nv_bfloat16* mtex = tex + kF + bone;
      int32_t base[3];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        base[p] = __ldg(bases + (((int64_t)b * 3 + p) * Mp + g) * U + u);

      // member `lane`'s mask logits, sigmoids and cand_w (lanes < kM)
      float sig[3] = {0.f, 0.f, 0.f};
      float cw = 1.f;
      if (lane < kM) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const int coff = (p * Mp + g) * kM * kUnits + warp;
          int i, k;
          float ft, fs;
          texel_cell(s_xt[coff + lane * kUnits], i, ft);
          texel_cell(s_xs[coff + lane * kUnits], k, fs);
          float logit = v_lane * bilinear(mtex, quad_texel(base[p], i, k, Wp),
                                          Wp, ft, fs);
          if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
          sig[p] = 1.f / (1.f + expf(-logit));
          cw *= sig[p];
        }
      }
      const float cwv = cw * v_lane;

      // one pass over the features: S_g (for dcw), the feature adds and
      // the feature share of dxt, dxs
      float sj[kM];
#pragma unroll
      for (int j = 0; j < kM; ++j) sj[j] = 0.f;
      float a[32];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int coff = (p * Mp + g) * kM * kUnits + warp;
        const float* cx = s_xt + coff;
        const float* cy = s_xs + coff;
#pragma unroll
        for (int j = 0; j < kM; ++j) {
          int i, k;
          float ft, fs;
          texel_cell(cx[j * kUnits], i, ft);
          texel_cell(cy[j * kUnits], k, fs);
          const int64_t t00 = quad_texel(base[p], i, k, Wp);
          const __nv_bfloat16* q = ftex + t00 * kTexel;
          const float v00 = __bfloat162float(q[0]);
          const float v01 = __bfloat162float(q[kTexel]);
          const float v10 = __bfloat162float(q[(int64_t)Wp * kTexel]);
          const float v11 = __bfloat162float(q[(int64_t)(Wp + 1) * kTexel]);
          sj[j] += (1.f - ft) * ((1.f - fs) * v00 + fs * v01) +
                   ft * ((1.f - fs) * v10 + fs * v11);
          const float cwj = __shfl_sync(kAll, cwv, j);
          const float dsj = cwj * df[j];           // dS_g[j, lane]
          a[j] = dsj * ((1.f - fs) * (v10 - v00) + fs * (v11 - v01));
          a[kM + j] = dsj * ((1.f - ft) * (v01 - v00) + ft * (v11 - v10));
          if (vv[j * kUnits] == 0.f) continue;     // warp-uniform
          float* d = dtex + t00 * kTexel + lane;
          atomicAdd(d, (1.f - ft) * (1.f - fs) * dsj);
          atomicAdd(d + kTexel, (1.f - ft) * fs * dsj);
          atomicAdd(d + (int64_t)Wp * kTexel, ft * (1.f - fs) * dsj);
          atomicAdd(d + (int64_t)(Wp + 1) * kTexel, ft * fs * dsj);
        }
        // lane j < 16: member j's d/dft; lane 16 + j: its d/dfs
        const float r = transpose_sum(a, lane);
        const float rs = __shfl_down_sync(kAll, r, kM);
        if (lane < kM) {
          s_dxt[coff + lane * kUnits] = r;
          s_dxs[coff + lane * kUnits] = rs;
        }
      }

      // dcw of member `lane`: valid * <S_g[j], dfeature[j]> + dcand_w
#pragma unroll
      for (int j = 0; j < kM; ++j) {
        a[j] = sj[j] * df[j];
        a[kM + j] = 0.f;
      }
      const float dsum = transpose_sum(a, lane);
      const float dcw =
          lane < kM ? dsum * v_lane + s_dcw[(g * kM + lane) * kUnits + warp]
                    : 0.f;

      // the mask adds and the mask share of dxt, dxs (lanes < kM)
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int coff = (p * Mp + g) * kM * kUnits + warp;
        if (lane < kM) {
          int i, k;
          float ft, fs;
          texel_cell(s_xt[coff + lane * kUnits], i, ft);
          texel_cell(s_xs[coff + lane * kUnits], k, fs);
          const int64_t t00 = quad_texel(base[p], i, k, Wp);
          const __nv_bfloat16* q = mtex + t00 * kTexel;
          const float m00 = __bfloat162float(q[0]);
          const float m01 = __bfloat162float(q[kTexel]);
          const float m10 = __bfloat162float(q[(int64_t)Wp * kTexel]);
          const float m11 = __bfloat162float(q[(int64_t)(Wp + 1) * kTexel]);
          const float dl = dcw * cw * (1.f - sig[p]) * v_lane;
          if (dl != 0.f) {
            float* d = dtex + t00 * kTexel + kF + bone;
            atomicAdd(d, (1.f - ft) * (1.f - fs) * dl);
            atomicAdd(d + kTexel, (1.f - ft) * fs * dl);
            atomicAdd(d + (int64_t)Wp * kTexel, ft * (1.f - fs) * dl);
            atomicAdd(d + (int64_t)(Wp + 1) * kTexel, ft * fs * dl);
          }
          s_dxt[coff + lane * kUnits] +=
              dl * ((1.f - fs) * (m10 - m00) + fs * (m11 - m01));
          s_dxs[coff + lane * kUnits] +=
              dl * ((1.f - ft) * (m01 - m00) + ft * (m11 - m10));
        }
      }
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < coord_n; e += blockDim.x) {
    const int w = e % kUnits;
    if (u0 + w >= U) continue;
    const int64_t off = cbase + (int64_t)(e / kUnits) * U + u0 + w;
    dxt[off] = s_dxt[e];
    dxs[off] = s_dxs[e];
  }
}

}  // namespace

// Dynamic shared memory of one block, in bytes (for the wrapper's report).
extern "C" int tilewin_combine_bwd_smem_bytes(int Mp) {
  return (int)smem_bytes(Mp);
}

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   texels (B, 3, H+2, W+2, 64) bf16; bases (B, 3, Mp, U) int32 window base
//   texels over the whole table; bones (B, Mp, U) int32 in [0, 32);
//   xt, xs (B, 3, Mp, 16, U) f32 in [0, 7); valid (B, Mp, 16, U) f32;
//   dfeature (B, 32, U*16) f32 in tiled point order; dcand_w
//   (B, Mp, U/S, 16, S) f32
//   -> dtexels (B, 3, H+2, W+2, 64) f32, which the caller zeroes (the kernel
//   adds into it), and dxt, dxs (B, 3, Mp, 16, U) f32.
// S divides U. Launches on `stream` and returns cudaGetLastError().
extern "C" int tilewin_combine_bwd_bf16(
    const void* texels, const void* bases, const void* bones, const void* xt,
    const void* xs, const void* valid, const void* dfeature,
    const void* dcand_w, void* dtexels, void* dxt, void* dxs, int B, int H,
    int W, int Mp, int U, int S, int clamp, void* stream) {
  const size_t smem = smem_bytes(Mp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tilewin_combine_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((U + kUnits - 1) / kUnits, B);
  tilewin_combine_bwd_kernel<<<grid, kUnits * 32, smem,
                               (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)texels, (const int32_t*)bases,
      (const int32_t*)bones, (const float*)xt, (const float*)xs,
      (const float*)valid, (const float*)dfeature, (const float*)dcand_w,
      (float*)dtexels, (float*)dxt, (float*)dxs, W + 2, Mp, U, S, clamp);
  return (int)cudaGetLastError();
}
