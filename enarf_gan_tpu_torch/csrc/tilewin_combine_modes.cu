// Patch-window (tilewin) gather + combine in the TPU kernel's matrix
// formulations ("dot", "bdiag" and "vpu"), for Hopper (sm_90a), at M = 16
// members a unit and F = 32 channels.
//
// Replaces the TPU Pallas kernels
// enarf_gan_tpu/ops/tilewin_kernel.py::_combine_kernel (modes "dot" and
// "vpu") and ::_combine_kernel_bdiag (mode "bdiag"), launched by
// tilewin_combine under ENARF_TILEWIN_KERNEL, and also does the window-row
// gathers that the JAX package runs outside those kernels.
//
// The function is kernel 2's (csrc/tilewin_combine.cu), computed as the TPU
// computed it. A window row is one 16 x 128 bf16 tile W, texel-major: sublane
// sigma = 2t + h, lane lambda = 32 q + f holds texel (t, s = 4h + q), channel
// f. The separable bilinear weight splits into a t-weight on sigma and an
// s-weight on lambda. Per (unit, slot, plane):
//     A[h*16 + j, sigma] = wt_j(sigma / 2) * valid_j * [sigma % 2 == h]
//     D = A (32 x 16) @ W (16 x 128)                        (t-contraction)
//     S[j, f] += sum_q D[j, 32q + f] * ws_j(q) + D[16 + j, 32q + f] * ws_j(4 + q)
// with wt_j(t) = 1 - ft at t = i, ft at t = i + 1, 0 elsewhere (i, ft the
// member's texel and fraction, i clamped to 6 as in kernel 2), and ws_j the
// same in s. Then the mask logit, the sigmoid product and the slot sum are
// kernel 2's, in float32.
// * "dot" and "bdiag": A is rounded to bf16 (the TPU kernels'
//   A.astype(bfloat16)) and D = A @ W runs on the tensor cores in float32
//   accumulation, 32 mma.sync.m16n8k16 bf16 instructions: 2 row tiles (the
//   parities) by 16 column tiles, one k-step of 16 = sigma. "bdiag" packed 8
//   units' A blocks into one block-diagonal (256 x 128) lhs only to fill a
//   128-wide MXU; its products are the same numbers plus exact zeros, so it
//   runs this code path too.
// * "vpu": the same contraction in float32 FMAs on the CUDA cores, A not
//   rounded (the TPU kernel's broadcast-multiply sum).
//
// What bounds it: bytes. Unlike kernel 2, which reads only the 2x2 texels
// its members touch, this formulation reads whole 4 KB window rows: the
// bytes it needs are each distinct row read once, the mask sectors, the
// coordinates and the outputs. The tensor-core work (131 kFLOP a (unit,
// slot, plane)) is far below the card's bf16 rate; the vpu form's float32
// FMAs (64 kFLOP each) are of the order of the bytes.
//
// Design: one warp per unit, 8 units a block, as kernel 2; the block stages
// coordinates and validity in shared memory. Each warp streams its unit's
// Mp x 3 window rows through a double buffer in shared memory with cp.async
// (16 bytes a lane, rows padded to 136 lanes so that ldmatrix's 8 rows fall
// on distinct banks), fetching the next row while it multiplies the current
// one. ldmatrix.x4.trans feeds the mma's B fragments from the row as stored;
// the A fragments are built in registers (half of them are exact zeros, the
// other parity). Thread (g4 = lane / 4, c = lane % 4) holds D for members g4
// and g4 + 8 and lambdas 8 nt + 2c + {0, 1}, so the s-weights and the fold of
// the 4 quarters q onto a channel happen in its registers with no shuffle:
// it owns 8 channels of 2 members. The feature goes out through shared
// memory in its final (B, F, n) layout, as in kernel 2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 32;             // channels
constexpr int kWin = 8;            // window side, texels
constexpr int kNTex = kWin * kWin;
constexpr int kRow = kNTex * kF;   // bf16 per feature window row (16 x 128)
constexpr int kUnits = 8;          // units per block = warps per block
constexpr int kM = 16;             // members per unit
constexpr int kSig = 16;           // sublanes of a row tile
constexpr int kLam = 128;          // lanes of a row tile
constexpr int kPitchW = kLam + 8;  // padded shared row: 272 B, 16-B aligned
constexpr int kBufElems = kSig * kPitchW;

__device__ __forceinline__ void texel_cell(float x, int& i, float& frac) {
  const float c = fminf(floorf(x), (float)(kWin - 2));
  i = (int)c;
  frac = x - c;
}

// the bilinear weight of texel t along one axis: 1 - f at i, f at i + 1
__device__ __forceinline__ float axis_weight(int t, int i, float f) {
  return t == i ? 1.f - f : (t == i + 1 ? f : 0.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage ablations (the Hopper counterparts of tools/probe_tilewin_bdiag.py's
// variants), in both paths. The main entry point instantiates kFull only;
// built with -DTILEWIN_STAGE_ENTRY the library also exports
// tilewin_combine_modes_stage_bf16. Every variant still stages the whole
// window rows by cp.async and writes what it reads into the outputs:
//   kStream  S[j, f] += W[0, f] + xt_j + xs_j (no A, no s-weights, no
//            product), logit_j = valid_j * mask[mrow, texel 0];
//   kFeatA   the t-weights are 1 at every t (no valid, no rounding);
//   kFeatD   D[h, lambda] = sum_t W[2t + h, lambda] + sum_t A[j, t] (the
//            product replaced by a sum of the staged rows, A unrounded);
//   kFeatB   the s-weights are 1;
//   kFeat    no mask rows read: cand_w = 1;
//   kMask    no feature product: S[j, f] += sum over the row's 64 texels of
//            channel f (no weights).
enum Stage { kFull = 0, kStream = 1, kFeatA = 2, kFeatD = 3, kFeatB = 4,
             kFeat = 5, kMask = 6 };

size_t smem_bytes(int Mp) {
  const size_t rows = (size_t)kUnits * 2 * kBufElems * sizeof(__nv_bfloat16);
  const size_t coords = 2 * 3 * (size_t)Mp * kM * kUnits;  // xt, xs
  const size_t slots = 2 * (size_t)Mp * kM * kUnits;       // valid, cand_w
  const size_t feat = (size_t)kF * (kM * kUnits + 1);      // padded rows
  return rows + (coords + slots + feat) * sizeof(float);
}

template <bool kTensor, int kStage = kFull>
__global__ void __launch_bounds__(kUnits * 32)
tilewin_combine_modes_kernel(const __nv_bfloat16* __restrict__ feat_table,
                             const __nv_bfloat16* __restrict__ mask_table,
                             const int32_t* __restrict__ frows,
                             const int32_t* __restrict__ mrows,
                             const float* __restrict__ xt,
                             const float* __restrict__ xs,
                             const float* __restrict__ valid,
                             float* __restrict__ feature,
                             float* __restrict__ cand_w,
                             int Mp, int U, int S, int clamp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_rows = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* s_xt = reinterpret_cast<float*>(
      smem_raw + (size_t)kUnits * 2 * kBufElems * sizeof(__nv_bfloat16));
  const int coord_n = 3 * Mp * kM * kUnits;
  const int slot_n = Mp * kM * kUnits;
  constexpr int kPitch = kM * kUnits + 1;
  float* s_xs = s_xt + coord_n;
  float* s_valid = s_xs + coord_n;         // [Mp][M][kUnits]
  float* s_candw = s_valid + slot_n;       // [Mp][M][kUnits]
  float* s_feat = s_candw + slot_n;        // [kF][kPitch]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2;                // this thread's members g4, g4 + 8
  const int c = lane & 3;
  const int b = blockIdx.y;
  const int u0 = blockIdx.x * kUnits;
  const int u = u0 + warp;

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
    s_valid[e] = (u0 + w < U)
        ? valid[vbase + (int64_t)(e / kUnits) * U + u0 + w] : 0.f;
  }
  __syncthreads();

  float acc[2][8];                         // [member g4, g4+8][channel]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[mi][k] = 0.f;

  if (u < U) {   // warp-uniform
    __nv_bfloat16* buf = s_rows + (size_t)warp * 2 * kBufElems;
    const int n_it = Mp * 3;               // (slot, plane) pairs, g major
    auto fetch = [&](int it) {
      const int g = it / 3, p = it - 3 * (it / 3);
      const int64_t ri = (((int64_t)b * 3 + p) * Mp + g) * U + u;
      const __nv_bfloat16* row =
          feat_table + (int64_t)__ldg(frows + ri) * kRow;
      __nv_bfloat16* dst = buf + (it & 1) * kBufElems;
#pragma unroll
      for (int k = lane; k < kRow / 8; k += 32)   // 16-byte chunks
        cp_async16(dst + (k >> 4) * kPitchW + (k & 15) * 8, row + k * 8);
      cp_async_commit();
    };
    fetch(0);
    for (int g = 0; g < Mp; ++g) {
      const float* vv = s_valid + g * kM * kUnits + warp;
      const float v_lane = lane < kM ? vv[lane * kUnits] : 0.f;
      const float vm[2] = {vv[g4 * kUnits], vv[(g4 + 8) * kUnits]};
      float sg[2][8];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int k = 0; k < 8; ++k) sg[mi][k] = 0.f;
      float cw = 1.f;
      for (int p = 0; p < 3; ++p) {
        const int it = g * 3 + p;
        if (it + 1 < n_it) {
          fetch(it + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const __nv_bfloat16* W = buf + (it & 1) * kBufElems;
        const int coff = (p * Mp + g) * kM * kUnits + warp;
        const float* cx = s_xt + coff;
        const float* cy = s_xs + coff;

        // this thread's members: t-weights at t = c, c + 4 (tensor) or all
        // t (vpu), s-weights at all s
        int it_[2], is_[2];
        float ft_[2], fs_[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          texel_cell(cx[(g4 + 8 * mi) * kUnits], it_[mi], ft_[mi]);
          texel_cell(cy[(g4 + 8 * mi) * kUnits], is_[mi], fs_[mi]);
        }
        float hs[2][8];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int s = 0; s < 8; ++s)
            hs[mi][s] = kStage == kFeatB ? 1.f
                                         : axis_weight(s, is_[mi], fs_[mi]);

        if constexpr (kStage == kStream) {
          // channel of sg[.][k]: (k / 2) * 8 + 2c + k % 2, at texel 0
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float w =
                __bfloat162float(W[(k >> 1) * 8 + 2 * c + (k & 1)]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              sg[mi][k] += w + cx[(g4 + 8 * mi) * kUnits] +
                           cy[(g4 + 8 * mi) * kUnits];
          }
        } else if constexpr (kStage == kMask) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const __nv_bfloat16* col = W + nt * 8 + 2 * c;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int sig = 0; sig < kSig; ++sig) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(col + sig * kPitchW));
              s0 += v.x;
              s1 += v.y;
            }
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              sg[mi][k] += s0;
              sg[mi][k + 1] += s1;
            }
          }
        } else if constexpr (kStage == kFeatD) {
          float asum[2] = {0.f, 0.f};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              asum[mi] += axis_weight(t, it_[mi], ft_[mi]) * vm[mi];
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const __nv_bfloat16* col = W + nt * 8 + 2 * c;
            float d0[2] = {0.f, 0.f}, d1[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float2 we = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(col + (2 * t) * kPitchW));
              const float2 wo = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      col + (2 * t + 1) * kPitchW));
              d0[0] += we.x;
              d0[1] += we.y;
              d1[0] += wo.x;
              d1[1] += wo.y;
            }
            const int q = nt >> 2;
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sg[mi][k + e] += (d0[e] + asum[mi]) * hs[mi][q] +
                                 (d1[e] + asum[mi]) * hs[mi][4 + q];
          }
        } else if constexpr (kTensor) {
          // A fragments of the two parity tiles (rows: members g4, g4 + 8;
          // columns sigma = 2c + {0, 1} and 2c + 8 + {0, 1}, i.e. t = c and
          // t = c + 4 of parity 0 and 1)
          float w0[2], w4[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            w0[mi] = kStage == kFeatA ? 1.f
                                      : axis_weight(c, it_[mi], ft_[mi]) * vm[mi];
            w4[mi] = kStage == kFeatA
                         ? 1.f
                         : axis_weight(c + 4, it_[mi], ft_[mi]) * vm[mi];
          }
          const uint32_t a0[4] = {pack_bf16(w0[0], 0.f), pack_bf16(w0[1], 0.f),
                                  pack_bf16(w4[0], 0.f), pack_bf16(w4[1], 0.f)};
          const uint32_t a1[4] = {pack_bf16(0.f, w0[0]), pack_bf16(0.f, w0[1]),
                                  pack_bf16(0.f, w4[0]), pack_bf16(0.f, w4[1])};
          // ldmatrix row address of this lane: matrix lane/8 is (sigma half
          // (lane/8)%2, column tile +(lane/16)), row lane%8
          const __nv_bfloat16* lrow =
              W + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitchW +
              (lane >> 4) * 8;
#pragma unroll
          for (int nt = 0; nt < 16; nt += 2) {
            uint32_t bfr[4];
            ldmatrix_x4_trans(bfr, lrow + nt * 8);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int ntt = nt + hh;
              float d0[4], d1[4];
              mma_bf16(d0, a0, bfr[2 * hh], bfr[2 * hh + 1]);
              mma_bf16(d1, a1, bfr[2 * hh], bfr[2 * hh + 1]);
              const int q = ntt >> 2;
              const int k = (ntt & 3) * 2;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                sg[0][k + e] += d0[e] * hs[0][q] + d1[e] * hs[0][4 + q];
                sg[1][k + e] += d0[2 + e] * hs[1][q] + d1[2 + e] * hs[1][4 + q];
              }
            }
          }
        } else {
          float wt[2][8];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              wt[mi][t] = kStage == kFeatA
                              ? 1.f
                              : axis_weight(t, it_[mi], ft_[mi]) * vm[mi];
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            float d0[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
            float d1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
            const __nv_bfloat16* col = W + nt * 8 + 2 * c;
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float2 we = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      col + (2 * t) * kPitchW));
              const float2 wo = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      col + (2 * t + 1) * kPitchW));
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                d0[mi][0] += wt[mi][t] * we.x;
                d0[mi][1] += wt[mi][t] * we.y;
                d1[mi][0] += wt[mi][t] * wo.x;
                d1[mi][1] += wt[mi][t] * wo.y;
              }
            }
            const int q = nt >> 2;
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sg[mi][k + e] += d0[mi][e] * hs[mi][q] +
                                 d1[mi][e] * hs[mi][4 + q];
          }
        }

        // member `lane`'s mask logit, float32 on the CUDA cores
        if (kStage != kFeat && lane < kM) {
          const int64_t ri = (((int64_t)b * 3 + p) * Mp + g) * U + u;
          const __nv_bfloat16* mrow =
              mask_table + (int64_t)__ldg(mrows + ri) * kNTex;
          int i, k;
          float ft, fs;
          texel_cell(cx[lane * kUnits], i, ft);
          texel_cell(cy[lane * kUnits], k, fs);
          const __nv_bfloat16* q = mrow + i * kWin + k;
          const float bil =
              kStage == kStream
                  ? __bfloat162float(mrow[0])
                  : (1.f - ft) * ((1.f - fs) * __bfloat162float(q[0]) +
                                  fs * __bfloat162float(q[1])) +
                        ft * ((1.f - fs) * __bfloat162float(q[kWin]) +
                              fs * __bfloat162float(q[kWin + 1]));
          float logit = v_lane * bil;
          if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
          cw *= 1.f / (1.f + expf(-logit));
        }
        __syncwarp();   // the buffer is refilled two steps on
      }
      if (lane < kM) s_candw[(g * kM + lane) * kUnits + warp] = cw;
      const float cwv = cw * v_lane;
      const float c0 = __shfl_sync(0xffffffffu, cwv, g4);
      const float c1 = __shfl_sync(0xffffffffu, cwv, g4 + 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[0][k] += c0 * sg[0][k];
        acc[1][k] += c1 * sg[1][k];
      }
    }
  }
  // channel of acc[.][k]: f = (k / 2) * 8 + 2c + k % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      s_feat[((k >> 1) * 8 + 2 * c + (k & 1)) * kPitch +
             (g4 + 8 * mi) * kUnits + warp] = acc[mi][k];
  __syncthreads();

  // feature (B, F, n): point (patch * M + j) * S + s of unit u = patch * S + s
  const int64_t n = (int64_t)U * kM;
  for (int e = threadIdx.x; e < kF * kM * kUnits; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int f = e / (kUnits * kM);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    feature[((int64_t)b * kF + f) * n + ((int64_t)patch * kM + j) * S + s] =
        s_feat[f * kPitch + j * kUnits + w];
  }
  // cand_w (B, Mp, n_patch, M, S)
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int g = e / (kUnits * kM);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    cand_w[((int64_t)b * Mp + g) * n + ((int64_t)patch * kM + j) * S + s] =
        s_candw[e];
  }
}

template <bool kTensor, int kStage = kFull>
int launch(const void* feat_table, const void* mask_table, const void* frows,
           const void* mrows, const void* xt, const void* xs,
           const void* valid, void* feature, void* cand_w, int B, int Mp,
           int U, int S, int clamp, cudaStream_t stream) {
  const size_t smem = smem_bytes(Mp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tilewin_combine_modes_kernel<kTensor, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((U + kUnits - 1) / kUnits, B);
  tilewin_combine_modes_kernel<kTensor, kStage>
      <<<grid, kUnits * 32, smem, stream>>>(
      (const __nv_bfloat16*)feat_table, (const __nv_bfloat16*)mask_table,
      (const int32_t*)frows, (const int32_t*)mrows, (const float*)xt,
      (const float*)xs, (const float*)valid, (float*)feature, (float*)cand_w,
      Mp, U, S, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes (for the wrapper's report).
extern "C" int tilewin_combine_modes_smem_bytes(int Mp) {
  return (int)smem_bytes(Mp);
}

// Plain C entry point (loaded with ctypes). Shapes, all contiguous:
//   feat_table (R, 16, 128) bf16 window rows (64 texels x 32 channels);
//   mask_table (Rm, 64) bf16; frows, mrows (B, 3, Mp, U) int32 global rows;
//   xt, xs (B, 3, Mp, 16, U) f32 in [0, 7); valid (B, Mp, 16, U) f32
//   -> feature (B, 32, U*16) f32, cand_w (B, Mp, U/S, 16, S) f32.
// tensor = 1 runs the "dot"/"bdiag" tensor-core path, 0 the "vpu" path.
// S divides U. Launches on `stream` and returns cudaGetLastError().
extern "C" int tilewin_combine_modes_bf16(
    const void* feat_table, const void* mask_table, const void* frows,
    const void* mrows, const void* xt, const void* xs, const void* valid,
    void* feature, void* cand_w, int B, int Mp, int U, int S, int clamp,
    int tensor, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor)
    return launch<true>(feat_table, mask_table, frows, mrows, xt, xs, valid,
                        feature, cand_w, B, Mp, U, S, clamp, st);
  return launch<false>(feat_table, mask_table, frows, mrows, xt, xs, valid,
                       feature, cand_w, B, Mp, U, S, clamp, st);
}

#ifdef TILEWIN_STAGE_ENTRY
namespace {
template <bool kTensor>
int launch_stage(int stage, const void* feat_table, const void* mask_table,
                 const void* frows, const void* mrows, const void* xt,
                 const void* xs, const void* valid, void* feature,
                 void* cand_w, int B, int Mp, int U, int S, int clamp,
                 cudaStream_t st) {
#define MODES_STAGE_CASE(K)                                                 \
  case K:                                                                   \
    return launch<kTensor, K>(feat_table, mask_table, frows, mrows, xt, xs, \
                              valid, feature, cand_w, B, Mp, U, S, clamp, st);
  switch (stage) {
    MODES_STAGE_CASE(kFull)
    MODES_STAGE_CASE(kStream)
    MODES_STAGE_CASE(kFeatA)
    MODES_STAGE_CASE(kFeatD)
    MODES_STAGE_CASE(kFeatB)
    MODES_STAGE_CASE(kFeat)
    MODES_STAGE_CASE(kMask)
  }
#undef MODES_STAGE_CASE
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// The stage ablations: tilewin_combine_modes_bf16's arguments and outputs,
// with `stage` one of Stage (0 full, 1 stream, 2 featA, 3 featD, 4 featB,
// 5 feat, 6 mask).
extern "C" int tilewin_combine_modes_stage_bf16(
    const void* feat_table, const void* mask_table, const void* frows,
    const void* mrows, const void* xt, const void* xs, const void* valid,
    void* feature, void* cand_w, int B, int Mp, int U, int S, int clamp,
    int tensor, int stage, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor)
    return launch_stage<true>(stage, feat_table, mask_table, frows, mrows, xt,
                              xs, valid, feature, cand_w, B, Mp, U, S, clamp,
                              st);
  return launch_stage<false>(stage, feat_table, mask_table, frows, mrows, xt,
                             xs, valid, feature, cand_w, B, Mp, U, S, clamp,
                             st);
}
#endif  // TILEWIN_STAGE_ENTRY
