// Kernel 1bf: the float32 candidate sampler's backward for Hopper (sm_90a)
// (the forward, kernel 1f, is unirow_combine_f32.cu; both share
// unirow_f32.cuh).
//
// Replaces XLA's autodiff of the JAX package's float32 sampler,
// enarf_gan_tpu/ops/quadtable.py::sample_candidates_quadtable: the
// transposes of its two row gathers and of its combine, and the VJP of
// _quad_cells_weights down to the candidate positions. The forward computes,
// per (batch b, point i, candidate m, plane p), the cell and corner weights
// wq[q,p] from the position, and
//     feat_m   = sum_p sum_q wq[q,p] * feature_p[corner q][f]
//     logit_pm = sum_q wq[q,p] * mask_p[idx_m][corner q]
//     sig_pm   = sigmoid(clamp(logit_pm))          (clamp to [-2, 5] if set)
//     cand_w_m = prod_p sig_pm
//     feature  = sum_m cand_w_m * valid_m * feat_m
// Given dfeature (B, F, n) and dcand_w (B, n, M) this kernel recomputes those
// intermediates and emits
//     dfeat_m   = cand_w_m * valid_m * dfeature            (per channel f)
//     dcw_m     = valid_m * <dfeature, feat_m> + dcand_w_m
//     dlogit_pm = dcw_m * cand_w_m * (1 - sig_pm)          (the clamp passes
//                                                           the gradient on)
//     dfeature_p[corner q][f]      += wq[q,p] * dfeat_m[f]
//     dmask_p[idx_m][corner q]     += wq[q,p] * dlogit_pm
//     dwq[q,p] = <feature_p[corner q], dfeat_m> + mask_p[idx_m][corner q]
//                * dlogit_pm
//     dfx_p = sum_q dwq[q,p] dwq/dfx, dfy_p likewise (wq = cx * wy; the
//             floor and the range masks take no gradient)
//     dcand_pos[a] = dfx_a * W/2 + dfy_{(a+2)%3} * H/2  (plane a samples
//             coordinates (a, (a+1)%3))
// in float32. valid takes no gradient (it comes from a bool).
//
// What bounds it: the atomic adds into the two table gradients, then bytes.
// It re-reads the forward's table lines (44 MB of tables an image at 256^2
// planes, in L2), reads the inputs and dfeature once, and adds into float32
// gradients of the tables' own layouts, (B, 3, H+2, W+2, 32) and (B, 3, K,
// H+2, W+2): 44 MB an image, which the caller zeroes (the 64-lane texel
// gradient of the earlier float32 design was 51.1 MB and held 9 lanes of
// padding a texel). A valid candidate makes 48 sectors of feature adds (12
// corners x 128 bytes; corners of weight 0 add nothing) and, with the masks
// bone-major, one 8-byte add a plane and row of corners (the two horizontal
// corners are neighbouring floats) where 12 scattered 4-byte adds were. The
// position gradient is summed inside the warp that owns the point, with no
// atomics, and written once: the earlier design wrote dwq4 (50 MB a fine
// chunk) for autograd to carry back through the cells' 132-launch graph.
//
// Design: the forward's (one warp per point, half a warp a candidate, lane
// (h, q, c), one warp-wide load of a point's inputs for 5 candidates,
// dcand_w with them); 3 blocks of 8 warps an SM; the block stages its 8
// points' dfeature through shared memory (32-byte coalesced reads). A
// candidate's 13 dot products (12 dwq and <dfeature, feat_m>) take one
// transposed butterfly over the 4 chunk lanes (3 shuffles: lane c ends with
// plane pe = sum4_entry(c)'s <feature line, dfeature>) and a 16-lane sum (4
// shuffles). Lane (q, c) with pe < 3 holds dwq[q, pe]; the position gradient
// sums dwq * dwq/dfx and * dwq/dfy over the 4 corners (2 shuffles each) and
// takes the other plane's y term from the lane that holds it (1 shuffle);
// lanes q = 0 write the candidate's 3 coordinates. Each lane adds 8 channels
// of its corner with two sm_90 vector reductions (red.global.add.v4.f32, 64
// contiguous bytes of every corner a reduction instruction); lane (q, c)
// with q even adds its and its right neighbour's mask gradient with one
// red.global.add.v2.f32 where the pair is on 8 bytes, else two scalar adds
// in one sector. Zero adds are skipped: a candidate with cand_w * valid = 0
// adds no feature, a corner of weight 0 nothing. A corner of weight 0 is
// still loaded where the weight's derivative is not 0 (a position on a
// cell's edge, unirow_f32.cuh: load_planes): its texel enters the
// positions' gradient. The atomics make the order
// of each sum vary from run to run, as the reference's CUDA sampler's
// backward does. ptxas (nvcc 12.9, sm_90a; chip_smoke.py's build prints
// it): 80 registers, no spills, 1,152 bytes of shared memory. Under the
// forward's 4 blocks an SM (the stage build's blocks4) it takes 64
// registers with 40 bytes of spill stores and 80 of spill loads, and takes
// 16% longer at 4 images' fine pass on an H100 (4.46 ms against 3.84): the
// 8 more warps an SM do not pay for the spills.

#include "unirow_f32.cuh"

namespace {

using namespace unirow_f32;

constexpr int kChunk = 5;            // candidates a warp's input load covers
constexpr int kBlocksPerSM = 3;      // at most 85 registers a thread

// Stage ablations (tools/ablate.py). The main entry point instantiates kFull
// only; built with -DUNIROW_STAGE_ENTRY the library also exports
// unirow_combine_bwd_stage_f32, whose variants change only the adds or the
// occupancy:
//   kNoFeat   no feature adds (the mask adds and dcand_pos as in kFull);
//   kNoMask   no mask adds (the feature adds and dcand_pos as in kFull);
//   kBlocks4  kFull under a launch bound of 4 blocks an SM (at most 64
//             registers, with spills: 32 warps in flight where kFull has 24).
enum Stage { kFull = 0, kNoFeat = 1, kNoMask = 2, kBlocks4 = 3 };

__device__ __forceinline__ void red_add_v4(float* addr, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

__device__ __forceinline__ void red_add_v2(float* addr, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
               :: "l"(addr), "f"(a), "f"(b) : "memory");
}

template <int kStage>
__global__ void __launch_bounds__(kWarps * 32,
                                  kStage == kBlocks4 ? 4 : kBlocksPerSM)
unirow_f32_bwd_kernel(const float* __restrict__ feat,
                      const float* __restrict__ mask,
                      const float* __restrict__ pos,
                      const int32_t* __restrict__ cand_idx,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ dfeature,
                      const float* __restrict__ dcand_w,
                      float* __restrict__ dfeat,
                      float* __restrict__ dmask,
                      float* __restrict__ dpos,
                      int H, int W, int K, int M, int n, int clamp) {
  __shared__ float dft[kF][kWarps + 1];
  const Lane L = unirow::lane_of(threadIdx.x);
  const int lane = threadIdx.x & 31;
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

  float df[8];                     // the lane's channels of dfeature
#pragma unroll
  for (int j = 0; j < 8; ++j) df[j] = dft[channel(L.c, j)][warp];
  const Tables T = tables_of(feat, mask, b, H, W, K);
  const int64_t at = ((int64_t)b * n + pt) * M;            // (b, pt, m = 0)
  float* dfb = dfeat + (int64_t)b * 3 * T.plane * kF;
  float* dmb = dmask + (int64_t)b * 3 * K * T.plane;
  const int pe = unirow::sum4_entry(L.c);  // the plane this lane's dots end on
  const bool has_plane = pe < 3;
  // the lane (same h, q) that holds plane (pe + 2) % 3, whose y-coordinate
  // is this lane's plane's x (sum4_entry is its own inverse)
  const int y_lane = (lane & ~3) | unirow::sum4_entry(pe == 0 ? 2 : pe - 1);
  const float half_w = 0.5f * W, half_h = 0.5f * H;

  for (int m0 = 0; m0 < M; m0 += kChunk) {                 // warp-uniform
    const uint32_t in = load_inputs<kChunk, true>(
        pos + at * 3, cand_idx + at, valid + at, dcand_w + at, M, m0, lane);
    const int nc = min(kChunk, M - m0);
    for (int j0 = 0; j0 < nc; j0 += 2) {                   // warp-uniform
      const int j = j0 + L.h;
      const bool active = j < nc;
      const Cand k = cand_of<kChunk, true>(in, j, K);
      Loaded d;
      float gx = 0.f, gy = 0.f;      // plane pe's dw/dfx, dw/dfy at corner q
      load_planes<true>(d, k, active, T, L, gx, gy, pe);
      const Sig s = sigmoids(d, clamp);
      // <feature line of corner q on plane p, dfeature chunk>, then summed
      // over the 4 chunk lanes: lane c holds plane pe's
      float dot[4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float f[8];
        unpack(d.lo[p], d.hi[p], f);
        dot[p] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[p] += f[i] * df[i];
      }
      dot[3] = 0.f;
      const float dp = unirow::transpose_sum4(dot, L.c);
      const float w_pe = has_plane ? unirow::pick3(d.w, pe) : 0.f;
      // <dfeature, feat_m> = sum over (q, p) of w_qp <line_qp, dfeature>
      float g = w_pe * dp;
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) g += __shfl_xor_sync(kAll, g, o);
      const float wt = s.cw * k.v;
      const float dcw = g * k.v + k.dcw;
      float dlogit = 0.f, dw = 0.f;
      if (has_plane && active) {
        dlogit = dcw * s.cw * (1.f - unirow::pick3(s.sig, pe));
        dw = wt * dp + unirow::pick3(d.mask, pe) * dlogit;
      }
      // the position: dfx and dfy of plane pe summed over the 4 corners
      float sx = dw * gx, sy = dw * gy;
      sx += __shfl_xor_sync(kAll, sx, 4);
      sx += __shfl_xor_sync(kAll, sx, 8);
      sy += __shfl_xor_sync(kAll, sy, 4);
      sy += __shfl_xor_sync(kAll, sy, 8);
      const float sy_other = __shfl_sync(kAll, sy, y_lane);
      if (active && has_plane && L.q == 0)
        __stcs(dpos + (at + m0 + j) * 3 + pe,
               sx * half_w + sy_other * half_h);
      // the mask gradient: corners q and q+1 (q even) are neighbours
      const float dm = w_pe * dlogit;
      const float dm_right = __shfl_xor_sync(kAll, dm, 4);
      if (kStage != kNoMask && has_plane && !(L.q & 1)
          && (dm != 0.f || dm_right != 0.f)) {
        float* a = dmb + (int64_t)(pe * K + k.idx) * T.plane
            + unirow::pick3(d.tex, pe);
        if (!(reinterpret_cast<uintptr_t>(a) & 7)) {
          red_add_v2(a, dm, dm_right);
        } else {
          if (dm != 0.f) atomicAdd(a, dm);
          if (dm_right != 0.f) atomicAdd(a + 1, dm_right);
        }
      }
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float a = d.w[p] * wt;
        if (kStage == kNoFeat || a == 0.f) continue;
        float* dst = dfb + ((int64_t)p * T.plane + d.tex[p]) * kF + 4 * L.c;
        red_add_v4(dst, a * df[0], a * df[1], a * df[2], a * df[3]);
        red_add_v4(dst + 16, a * df[4], a * df[5], a * df[6], a * df[7]);
      }
    }
  }
}

template <int kStage>
int launch(const void* feat, const void* mask, const void* cand_pos,
           const void* cand_idx, const void* cand_valid, const void* dfeature,
           const void* dcand_w, void* dfeat, void* dmask, void* dpos, int B,
           int H, int W, int K, int M, int n, int clamp, void* stream) {
  dim3 grid((n + kWarps - 1) / kWarps, B);
  unirow_f32_bwd_kernel<kStage>
      <<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)mask, (const float*)cand_pos,
      (const int32_t*)cand_idx, (const uint8_t*)cand_valid,
      (const float*)dfeature, (const float*)dcand_w, (float*)dfeat,
      (float*)dmask, (float*)dpos, H, W, K, M, n, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes), kernel 1bf. Shapes, all
// contiguous: feat (B, 3, H+2, W+2, 32) f32, mask (B, 3, K, H+2, W+2) f32;
// cand_pos (B, n, M, 3) f32; cand_idx (B, n, M) int32; cand_valid (B, n, M)
// bool; dfeature (B, 32, n) f32; dcand_w (B, n, M) f32 -> dfeat and dmask
// (the tables' shapes, f32), which the caller zeroes (the kernel adds into
// them), and dcand_pos (B, n, M, 3) f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int unirow_combine_bwd_f32(
    const void* feat, const void* mask, const void* cand_pos,
    const void* cand_idx, const void* cand_valid, const void* dfeature,
    const void* dcand_w, void* dfeat, void* dmask, void* dcand_pos, int B,
    int H, int W, int K, int M, int n, int clamp, void* stream) {
  return launch<kFull>(feat, mask, cand_pos, cand_idx, cand_valid, dfeature,
                       dcand_w, dfeat, dmask, dcand_pos, B, H, W, K, M, n,
                       clamp, stream);
}

#ifdef UNIROW_STAGE_ENTRY
// The stage ablations: unirow_combine_bwd_f32's arguments and outputs, with
// `stage` one of Stage (0 full, 1 nofeat, 2 nomask, 3 blocks4).
extern "C" int unirow_combine_bwd_stage_f32(
    const void* feat, const void* mask, const void* cand_pos,
    const void* cand_idx, const void* cand_valid, const void* dfeature,
    const void* dcand_w, void* dfeat, void* dmask, void* dcand_pos, int B,
    int H, int W, int K, int M, int n, int clamp, int stage, void* stream) {
#define UNIROW_STAGE_CASE(S)                                                 \
  case S:                                                                    \
    return launch<S>(feat, mask, cand_pos, cand_idx, cand_valid, dfeature,   \
                     dcand_w, dfeat, dmask, dcand_pos, B, H, W, K, M, n,     \
                     clamp, stream);
  switch (stage) {
    UNIROW_STAGE_CASE(kFull)
    UNIROW_STAGE_CASE(kNoFeat)
    UNIROW_STAGE_CASE(kNoMask)
    UNIROW_STAGE_CASE(kBlocks4)
  }
#undef UNIROW_STAGE_CASE
  return (int)cudaErrorInvalidValue;
}
#endif  // UNIROW_STAGE_ENTRY
