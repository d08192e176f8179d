// What the bf16 unirow kernels (unirow_combine.cu, unirow_combine_bwd.cu:
// kernels 1 and 1b) share: the texel table's layout, the lane mapping, the
// loads of one candidate's texels and inputs, its sigmoids, and the
// transposed warp sums. The float32 kernels 1f and 1bf (unirow_f32.cuh) use
// its lane mapping and warp sums.
//
// Texel table (ops/unirow.py::pack_texels): (B, 3, H+2, W+2, 64) of bf16 (a
// 128-byte line a texel), lanes [32 feature | 32 mask, bone k at lane
// 32+k]. Row r = p*(H+1)*(W+1) + t*(W+1) + s names cell (t, s) of plane p;
// its corner q is texel (p, t + q/2, s + q%2).
//
// Lane mapping: one warp per point; lane = 16h + 4q + c, where half h takes
// candidates h, h+2, ..., q is the corner and c one of the 4 lanes that
// share the corner's feature half, 8 channels a lane (Texel<T>::channel):
// one 16-byte load of channels 8c..8c+7 (the half is 64 bytes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unirow {

constexpr int kF = 32;          // feature lanes of a texel (kernels take F=32)
constexpr int kTexel = 64;      // lanes of a texel: 32 feature, 32 mask
constexpr int kWarps = 8;       // points per block
constexpr unsigned kAll = 0xffffffffu;

// What differs between the two texel types: a lane's 8 feature channels of
// one corner (Chunk, its loads and its unpacking to float32), which channel
// is its entry j, and the load of one mask logit.
template <typename T>
struct Texel;

template <>
struct Texel<__nv_bfloat16> {
  using Chunk = uint4;                       // channels 8c..8c+7
  __device__ static __forceinline__ Chunk zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ static __forceinline__ Chunk load(const __nv_bfloat16* t, int c) {
    return __ldg(reinterpret_cast<const uint4*>(t) + c);
  }
  __device__ static __forceinline__ void unpack(const Chunk& v,
                                                float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ int channel(int c, int j) {
    return 8 * c + j;
  }
  __device__ static __forceinline__ float mask(const __nv_bfloat16* t,
                                               int k) {
    const unsigned short x =
        __ldg(reinterpret_cast<const unsigned short*>(t) + kF + k);
    return __uint_as_float((uint32_t)x << 16);
  }
};

struct Lane {
  int h, q, c;                  // half-warp, corner, feature chunk
};

__device__ __forceinline__ Lane lane_of(int tid) {
  const int lane = tid & 31;
  return {lane >> 4, (lane >> 2) & 3, lane & 3};
}

// One point's inputs: pointers offset to (b, pt); (plane p, candidate m) is
// at p*ps + m*n (rows), (q*3 + p)*ps + m*n (wq4), m*n (cand_idx, valid).
template <typename T>
struct Inputs {
  const T* tex;                 // batch item b's texel table
  const int32_t* rows;
  const float* wq;
  const int32_t* idx;
  const float* valid;
  int64_t ps;                   // plane stride M*n
  int n, H, W, M;
};

template <typename T>
__device__ __forceinline__ Inputs<T> inputs_of(
    const T* tex, const int32_t* rows, const float* wq4,
    const int32_t* cand_idx, const float* valid, int b, int H, int W, int M,
    int n, int pt) {
  const int64_t ps = (int64_t)M * n;
  return {tex + (int64_t)b * 3 * (H + 2) * (W + 2) * kTexel,
          rows + b * 3 * ps + pt, wq4 + b * 12 * ps + pt,
          cand_idx + b * ps + pt, valid + b * ps + pt, ps, n, H, W, M};
}

// The texel of corner A of row r's cell, within the batch item's table.
__device__ __forceinline__ int64_t corner_a(int r, int H, int W) {
  const int cells = (H + 1) * (W + 1);
  const int p = r / cells;
  const int cell = r - p * cells;
  const int t = cell / (W + 1);
  const int s = cell - t * (W + 1);
  return ((int64_t)p * (H + 2) + t) * (W + 2) + s;
}

// What a lane holds of one candidate: its corner's chunk and mask logit on
// each plane, its corner's weights, and where that corner's texels are.
template <typename T>
struct Cand {
  typename Texel<T>::Chunk feat[3];
  float mask[3];
  float w[3];
  int64_t tex[3];               // texel index of corner q, per plane
  int64_t off;                  // m*n
  float v;                      // valid (0 for a candidate past M)
  int idx;
  bool active;                  // m < M
};

// All of a candidate's loads are issued here, before any is used: the
// streaming inputs (evict-first, read once), then 3 feature chunks (one
// 16-byte load each) and 3 mask loads a lane (one 32-byte sector a texel),
// i.e. the 12 texels of the candidate across the half-warp.
template <typename T>
__device__ __forceinline__ void load_cand(Cand<T>& k, const Inputs<T>& in,
                                          const Lane& L, int m) {
  k.active = m < in.M;
  k.off = (int64_t)(k.active ? m : 0) * in.n;
  k.idx = 0;
  k.v = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    k.feat[p] = Texel<T>::zero();
    k.mask[p] = 0.f;
    k.w[p] = 0.f;
    k.tex[p] = 0;
  }
  if (!k.active) return;
  k.idx = __ldcs(in.idx + k.off) & 31;
  k.v = __ldcs(in.valid + k.off);
  const int64_t corner = (int64_t)(L.q >> 1) * (in.W + 2) + (L.q & 1);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const int r = __ldcs(in.rows + p * in.ps + k.off);
    k.w[p] = __ldcs(in.wq + (L.q * 3 + p) * in.ps + k.off);
    k.tex[p] = corner_a(r, in.H, in.W) + corner;
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const T* t = in.tex + k.tex[p] * kTexel;
    k.feat[p] = Texel<T>::load(t, L.c);
    k.mask[p] = Texel<T>::mask(t, k.idx);
  }
}

struct Sig {
  float sig[3];
  float cw;                     // prod_p sig[p]
};

// The candidate's mask logit on each plane (its 4 corners summed across
// the lanes of q: 2 shuffles a plane), sigmoids and their product.
template <typename T>
__device__ __forceinline__ Sig sigmoids(const Cand<T>& k, int clamp) {
  Sig s;
  s.cw = 1.f;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    float l = k.w[p] * k.mask[p];
    l += __shfl_xor_sync(kAll, l, 4);
    l += __shfl_xor_sync(kAll, l, 8);
    if (clamp) l = fminf(fmaxf(l, -2.f), 5.f);
    s.sig[p] = 1.f / (1.f + expf(-l));
    s.cw *= s.sig[p];
  }
  return s;
}

// a[i] for i in {0, 1, 2} without indexing a register array at run time.
template <typename T>
__device__ __forceinline__ T pick3(const T (&a)[3], int i) {
  return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]);
}

// Transposed butterfly: the sum of a[0..7] over the 8 lanes (h, q) that
// share chunk c, 7 shuffles; lane (h, q, c) returns entry 4h + q.
__device__ __forceinline__ float transpose_sum8(float (&a)[8], const Lane& L) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = L.h ? a[i] : a[i + 4];
    const float keep = L.h ? a[i + 4] : a[i];
    a[i] = keep + __shfl_xor_sync(kAll, send, 16);
  }
  const int q1 = L.q >> 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = q1 ? a[i] : a[i + 2];
    const float keep = q1 ? a[i + 2] : a[i];
    a[i] = keep + __shfl_xor_sync(kAll, send, 8);
  }
  const int q0 = L.q & 1;
  const float send = q0 ? a[0] : a[1];
  const float keep = q0 ? a[1] : a[0];
  return keep + __shfl_xor_sync(kAll, send, 4);
}

// Transposed butterfly over the 4 chunk lanes c of one (h, q): the sum of
// a[0..3], 3 shuffles; lane c returns entry sum4_entry(c).
__device__ __forceinline__ int sum4_entry(int c) {
  return ((c & 1) << 1) | (c >> 1);
}

__device__ __forceinline__ float transpose_sum4(float (&a)[4], int c) {
  const int c0 = c & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = c0 ? a[i] : a[i + 2];
    const float keep = c0 ? a[i + 2] : a[i];
    a[i] = keep + __shfl_xor_sync(kAll, send, 1);
  }
  const int c1 = c >> 1;
  const float send = c1 ? a[0] : a[1];
  const float keep = c1 ? a[1] : a[0];
  return keep + __shfl_xor_sync(kAll, send, 2);
}

}  // namespace unirow
