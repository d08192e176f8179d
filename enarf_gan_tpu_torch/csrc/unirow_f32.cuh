// What kernels 1f (unirow_combine_f32.cu) and 1bf (unirow_combine_bwd_f32.cu)
// share: the float32 tables' layout, the loads of a point's candidate inputs,
// and each lane's cell and corner weight, computed from the candidate's
// position as ops/quadtable.py::_quad_cells_weights computes them.
//
// Tables (ops/unirow.py::pack_texels_f32), both with the one-texel ring of
// zeros (grid_sample's zeros padding), Hp = H+2, Wp = W+2:
//   feature (B, 3, Hp, Wp, 32) float32: a 128-byte line a texel;
//   mask    (B, 3, K, Hp, Wp) float32: bone-major planes, so the corners
//           (t, s) and (t, s+1) of a cell are neighbouring floats.
// Corner q of a point's cell (t, s) on plane p is texel (t + q/2, s + q%2).
//
// Lane mapping (unirow_texels.cuh's Lane): one warp per point; lane = 16h +
// 4q + c, where half h takes candidates h, h+2, ..., q is the corner and c
// one of the 4 lanes that share it, each holding channels 4c..4c+3 and
// 16+4c..16+4c+3 of the corner's feature line (two 16-byte loads; each load
// instruction of the 4 lanes reads 64 contiguous bytes, two whole sectors).
#pragma once

#include "unirow_texels.cuh"

namespace unirow_f32 {

using unirow::kAll;
using unirow::kF;
using unirow::kWarps;
using unirow::Lane;

// Entry j of a lane's 8 channels: its two float4 chunks, 4c.. and 16+4c..
__device__ __forceinline__ int channel(int c, int j) {
  return j < 4 ? 4 * c + j : 16 + 4 * c + (j - 4);
}

// A batch item's tables and sizes.
struct Tables {
  const float* feat;            // (3, Hp, Wp, 32)
  const float* mask;            // (3, K, Hp, Wp)
  int H, W, K;
  int plane;                    // Hp * Wp
};

__device__ __forceinline__ Tables tables_of(const float* feat,
                                            const float* mask, int b, int H,
                                            int W, int K) {
  const int plane = (H + 2) * (W + 2);
  return {feat + (int64_t)b * 3 * plane * kF,
          mask + (int64_t)b * 3 * K * plane, H, W, K, plane};
}

// One warp-wide load of a point's inputs for candidates [m0, m0 + kC): lane
// l < 3kC holds word l of their positions (cand_pos is (B, n, M, 3), so the
// point's are 12M contiguous bytes), lanes 3kC + j its bone cand_idx[m0+j],
// 4kC + j its valid byte, and with kDcw 5kC + j its dcand_w. The inputs are
// read once: evict-first (ld.global.cs), which keeps the tables in L2.
template <int kC, bool kDcw>
__device__ __forceinline__ uint32_t load_inputs(const float* pos,
                                                const int32_t* idx,
                                                const uint8_t* valid,
                                                const float* dcw, int M,
                                                int m0, int lane) {
  static_assert((kDcw ? 6 : 5) * kC <= 32, "a chunk's inputs fill a warp");
  const int nc = min(kC, M - m0);
  uint32_t w = 0u;
  if (lane < 3 * kC) {
    if (lane < 3 * nc) w = __float_as_uint(__ldcs(pos + 3 * m0 + lane));
  } else if (lane < 4 * kC) {
    const int j = lane - 3 * kC;
    if (j < nc) w = (uint32_t)__ldcs(idx + m0 + j);
  } else if (lane < 5 * kC) {
    const int j = lane - 4 * kC;
    if (j < nc) w = valid[m0 + j];
  } else if (kDcw && lane < 6 * kC) {
    const int j = lane - 5 * kC;
    if (j < nc) w = __float_as_uint(__ldcs(dcw + m0 + j));
  }
  return w;
}

// Candidate j of the chunk as the lanes of one half see it (every lane takes
// part in the shuffles). The bone is clamped to [0, K): the mask table holds
// K planes.
struct Cand {
  float p[3];                   // position
  float v;                      // valid
  float dcw;                    // dcand_w (backward)
  int idx;
};

template <int kC, bool kDcw>
__device__ __forceinline__ Cand cand_of(uint32_t w, int j, int K) {
  Cand k;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    k.p[a] = __uint_as_float(__shfl_sync(kAll, w, 3 * j + a));
  const int idx = (int)__shfl_sync(kAll, w, 3 * kC + j);
  k.idx = min(max(idx, 0), K - 1);
  k.v = __shfl_sync(kAll, w, 4 * kC + j) ? 1.f : 0.f;
  k.dcw = kDcw ? __uint_as_float(__shfl_sync(kAll, w, 5 * kC + j)) : 0.f;
  return k;
}

// The lane's corner q of a position's cell on one plane (coordinates px, py
// of the plane's axes), as _quad_cells_weights computes it in float32:
//   x = (px + 1) * (W/2) - 0.5, x0 = floor(x), fx = x - x0 (y likewise),
//   cx = (1 - fx) * [0 <= x0 <= W-1] for q%2 = 0, fx * [-1 <= x0 <= W-2]
//   for q%2 = 1, wy likewise from y and q/2, w = cx * wy,
//   cell s = clamp(x0, -1, W-1) + 1, t likewise.
// The roundings are explicit (no fused multiply-add), as PyTorch's, so the
// floor lands on the same cell and the weights are PyTorch's bit for bit.
// gx and gy are dw/dfx and dw/dfy (the floor and the range masks take no
// gradient).
struct Corner {
  float w, gx, gy;
  int tex;                      // texel within the plane
};

__device__ __forceinline__ Corner corner_of(float px, float py, int H, int W,
                                            int q) {
  const float x = __fsub_rn(__fmul_rn(__fadd_rn(px, 1.f), 0.5f * W), 0.5f);
  const float y = __fsub_rn(__fmul_rn(__fadd_rn(py, 1.f), 0.5f * H), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = __fsub_rn(x, x0);
  const float fy = __fsub_rn(y, y0);
  const bool right = q & 1, down = q >> 1;
  const bool in_x = right ? (x0 >= -1.f && x0 <= W - 2)
                          : (x0 >= 0.f && x0 <= W - 1);
  const bool in_y = down ? (y0 >= -1.f && y0 <= H - 2)
                         : (y0 >= 0.f && y0 <= H - 1);
  const float cx = in_x ? (right ? fx : __fsub_rn(1.f, fx)) : 0.f;
  const float wy = in_y ? (down ? fy : __fsub_rn(1.f, fy)) : 0.f;
  const int s = (int)fminf(fmaxf(x0, -1.f), (float)(W - 1)) + 1;
  const int t = (int)fminf(fmaxf(y0, -1.f), (float)(H - 1)) + 1;
  Corner c;
  c.w = __fmul_rn(cx, wy);
  c.gx = in_x ? (right ? wy : -wy) : 0.f;
  c.gy = in_y ? (down ? cx : -cx) : 0.f;
  c.tex = (t + down) * (W + 2) + s + right;
  return c;
}

// Plane p samples the position's coordinates (p, (p+1)%3)
// (ops/triplane.py::PLANE_COORDS).
__device__ __forceinline__ Corner plane_corner(const Cand& k, int p, int H,
                                               int W, int q) {
  return corner_of(k.p[p], k.p[p == 2 ? 0 : p + 1], H, W, q);
}

// What a lane loads of one candidate: its corner's weight, texel, mask value
// and feature chunks on each plane. A corner of weight 0 loads nothing in
// the forward (it lies in the padding, or on a cell's edge). The backward
// loads a corner on a cell's edge too, where its weight is 0 but not the
// weight's derivative (fx or fy is 0, or 1 - fx rounds to 0): the
// positions' gradient takes that corner's texel. An invalid candidate loads
// no feature (its feature is weighted by valid = 0), only the mask values
// its cand_w needs. All loads are issued before any is used.
struct Loaded {
  float w[3];
  int tex[3];
  float mask[3];
  float4 lo[3], hi[3];
};

// With kGrad, gx and gy take plane pe's dw/dfx and dw/dfy (the backward).
template <bool kGrad>
__device__ __forceinline__ void load_planes(Loaded& d, const Cand& k,
                                            bool active, const Tables& T,
                                            const Lane& L, float& gx,
                                            float& gy, int pe) {
  bool live[3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const Corner c = plane_corner(k, p, T.H, T.W, L.q);
    d.w[p] = active ? c.w : 0.f;
    d.tex[p] = c.tex;
    live[p] = active && (c.w != 0.f
                         || (kGrad && (c.gx != 0.f || c.gy != 0.f)));
    if (kGrad && p == pe) {
      gx = c.gx;
      gy = c.gy;
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    d.mask[p] = 0.f;
    d.lo[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    d.hi[p] = d.lo[p];
    if (live[p]) {
      d.mask[p] = __ldg(T.mask + (int64_t)(p * T.K + k.idx) * T.plane
                        + d.tex[p]);
      if (k.v != 0.f) {
        const float4* f = reinterpret_cast<const float4*>(
            T.feat + ((int64_t)p * T.plane + d.tex[p]) * kF) + L.c;
        d.lo[p] = __ldg(f);
        d.hi[p] = __ldg(f + 4);
      }
    }
  }
}

struct Sig {
  float sig[3];
  float cw;                     // prod_p sig[p]
};

// The candidate's mask logit on each plane (its 4 corners summed across the
// lanes of q: 2 shuffles a plane), sigmoids and their product.
__device__ __forceinline__ Sig sigmoids(const Loaded& d, int clamp) {
  Sig s;
  s.cw = 1.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float l = d.w[p] * d.mask[p];
    l += __shfl_xor_sync(kAll, l, 4);
    l += __shfl_xor_sync(kAll, l, 8);
    if (clamp) l = fminf(fmaxf(l, -2.f), 5.f);
    s.sig[p] = 1.f / (1.f + expf(-l));
    s.cw *= s.sig[p];
  }
  return s;
}

__device__ __forceinline__ void unpack(const float4& lo, const float4& hi,
                                       float (&f)[8]) {
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

}  // namespace unirow_f32
