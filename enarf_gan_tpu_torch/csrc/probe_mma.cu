// Tensor-core gathers and products for Hopper (sm_90a): family B of the
// probes (Python side enarf_gan_tpu_torch/tools/mma.py).
//
// Replaces the TPU probe kernels
//   tools/bench_pallas_prims.py:73 onehot_gather_kernel      (B1)
//   tools/bench_dyngather2.py:115 kernel, :144 kernel2       (B2)
//   tools/bench_pallas_prims.py:105 matmul_chain_kernel      (B3)
//   tools/bisect_hat_kernel.py bdiag_dot, tools/bisect_kernel_ops.py
//   dot_kshape, tools/probe_mosaic_caps.py dot_batched       (B3)
// The TPU gathered rows by multiplying a one-hot matrix into a window of the
// table on its matrix unit, because it could not address single rows; these
// kernels ask what that formulation costs on Hopper's tensor cores, beside a
// direct gather of the same rows.
//
// All three use mma.sync.m16n8k16 bf16 with float32 sums, B fragments loaded
// by ldmatrix.x4.trans from row-major (k, 128) tiles staged in shared memory
// by cp.async (rows padded to 136 bf16 so that ldmatrix's 8 rows fall on
// distinct banks), as kernel 3 does (tilewin_combine_modes.cu). A warp owns
// 16 rows of the output and all 128 columns: 16 n-tiles, 64 float32 sums a
// thread. N is 128 throughout (the lanes of a TPU row).
//
// B1 one-hot windowed gather: per sample two local rows loc and weights w;
//   out[s, :] = sum_k A[s, k] slab[k, :] with A[s, k] = bf16(w0 [k == j0] +
//   w1 [k == j1]), j = loc - base, over a (WIN, 128) bf16 slab: the whole
//   table (static window) or WIN rows from a 512-aligned base that each
//   group of G samples takes from its first sample's row (dynamic). The A
//   fragments are built in registers from each thread's two samples; the
//   slab streams through shared memory in chunks of 64 rows, double
//   buffered, and every k-tile is multiplied, as the TPU's one-hot product
//   did. Bound: the tensor-core operations (S x WIN x 128 x 2) or the bytes
//   (indices, weights, the slab once a block, the float32 output).
// B1 direct: the same function read straight from the two rows (16 threads
//   a sample, 16 bytes each), the question being whether the one-hot
//   product ever beats it.
// B2 sorted-tile one-hot gather: block of 512 samples, one row each, weight
//   1, from the 512-row tile that the block's entry in `tile` names.
// B3 products: C (batch, M, 128) f32 = A (batch, M, K) bf16 @ B (K, 128)
//   bf16, B shared by the batch (the chain) or one a batch element; A and B
//   staged 16 deep through a double buffer. Bound: operations at the bf16
//   tensor rate (989 TFLOP/s), or bytes for the small batched products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;             // output columns
constexpr int kPitchB = kN + 8;     // padded shared row of B: 272 B
constexpr int kPitchA = 24;         // padded shared row of a 16-deep A: 48 B
constexpr int kChunk = 64;          // slab rows a stage (B1, B2)
constexpr int kWarps = 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// 16 k-rows of B (row-major, pitch kPitchB) times this warp's A fragment,
// into acc[16][4]
__device__ __forceinline__ void mma_row_tile(float (&acc)[16][4],
                                             const uint32_t (&a)[4],
                                             const __nv_bfloat16* sB,
                                             int lane) {
  const __nv_bfloat16* lrow =
      sB + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitchB + (lane >> 4) * 8;
#pragma unroll
  for (int nt = 0; nt < 16; nt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, lrow + nt * 8);
    mma_acc(acc[nt], a, b[0], b[1]);
    mma_acc(acc[nt + 1], a, b[2], b[3]);
  }
}

// rows r0 (acc[.][0..1]) and r0 + 8 (acc[.][2..3]) of a (rows, 128) output
__device__ __forceinline__ void store_acc(float* out, int64_t r0,
                                          const float (&acc)[16][4],
                                          int lane) {
  const int c = lane & 3;
  float* o0 = out + r0 * kN + 2 * c;
  float* o1 = o0 + 8 * kN;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    *reinterpret_cast<float2*>(o0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o1 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------------------ B1 and B2

enum { kStatic = 0, kDynamic = 1, kTile = 2 };

__device__ __forceinline__ int64_t window_base(int mode, const int32_t* loc,
                                               const int32_t* tile,
                                               int64_t group, int G, int WIN,
                                               int n_rows) {
  if (mode == kStatic) return 0;
  if (mode == kTile) return (int64_t)__ldg(tile + group) * WIN;
  int64_t base = __ldg(loc + group * G * 2);     // the group's first row
  if (base > n_rows - WIN) base = n_rows - WIN;
  return (base / 512) * 512;
}

template <int kMode>
__global__ void __launch_bounds__(kWarps * 32)
onehot_gather_kernel(const int32_t* __restrict__ loc,
                     const float* __restrict__ w,
                     const int32_t* __restrict__ tile,
                     const __nv_bfloat16* __restrict__ tab,
                     float* __restrict__ out, int G, int WIN, int n_rows) {
  __shared__ __align__(16) __nv_bfloat16 s_slab[2][kChunk * kPitchB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2, c = lane & 3;
  const int64_t s_block = (int64_t)blockIdx.x * kWarps * 16;
  const int64_t group = s_block / G;
  const int64_t base =
      window_base(kMode, loc, tile, group, G, WIN, n_rows);

  // this thread's two samples (A rows g4 and g4 + 8): local rows, weights
  int j[2][2];
  float wt[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t s = s_block + warp * 16 + g4 + 8 * h;
    if (kMode == kTile) {
      j[h][0] = j[h][1] = __ldg(loc + s);
      wt[h][0] = 1.f;
      wt[h][1] = 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        j[h][e] = (int)(__ldg(loc + 2 * s + e) - base);
        wt[h][e] = __ldg(w + 2 * s + e);
      }
    }
  }
  auto onehot = [&](int h, int k) {
    float v = 0.f;
    if (k == j[h][0]) v += wt[h][0];
    if (kMode != kTile && k == j[h][1]) v += wt[h][1];
    return v;
  };

  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  auto fetch = [&](int chunk) {
    const __nv_bfloat16* src = tab + (base + (int64_t)chunk * kChunk) * kN;
    __nv_bfloat16* dst = s_slab[chunk & 1];
    for (int q = threadIdx.x; q < kChunk * 16; q += blockDim.x)
      cp_async16(dst + (q >> 4) * kPitchB + (q & 15) * 8,
                 src + (q >> 4) * kN + (q & 15) * 8);
    cp_async_commit();
  };
  const int n_chunks = WIN / kChunk;
  fetch(0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      fetch(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < kChunk / 16; ++kt) {
      const int k0 = ch * kChunk + kt * 16 + 2 * c;
      const uint32_t a[4] = {pack_bf16(onehot(0, k0), onehot(0, k0 + 1)),
                             pack_bf16(onehot(1, k0), onehot(1, k0 + 1)),
                             pack_bf16(onehot(0, k0 + 8), onehot(0, k0 + 9)),
                             pack_bf16(onehot(1, k0 + 8), onehot(1, k0 + 9))};
      mma_row_tile(acc, a, s_slab[ch & 1] + kt * 16 * kPitchB, lane);
    }
    __syncthreads();   // the buffer is refilled two chunks on
  }
  store_acc(out, s_block + warp * 16 + g4, acc, lane);
}

// the same function read straight from the rows: 16 threads a sample
__global__ void __launch_bounds__(256)
direct_gather_kernel(const int32_t* __restrict__ loc,
                     const float* __restrict__ w,
                     const __nv_bfloat16* __restrict__ tab,
                     float* __restrict__ out, int64_t S, int G, int WIN,
                     int n_rows, int dynamic) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t s = t >> 4;
  const int part = (int)(t & 15);              // 8 channels a thread
  if (s >= S) return;
  const int64_t base = window_base(dynamic ? kDynamic : kStatic, loc, nullptr,
                                   s / G, G, WIN, n_rows);
  int j0 = (int)(__ldg(loc + 2 * s) - base);
  int j1 = (int)(__ldg(loc + 2 * s + 1) - base);
  float w0 = __ldg(w + 2 * s), w1 = __ldg(w + 2 * s + 1);
  if (j0 == j1) {                              // the one-hot sums, then rounds
    w0 += w1;
    w1 = 0.f;
  }
  w0 = (j0 >= 0 && j0 < WIN) ? __bfloat162float(__float2bfloat16_rn(w0)) : 0.f;
  w1 = (j1 >= 0 && j1 < WIN) ? __bfloat162float(__float2bfloat16_rn(w1)) : 0.f;
  j0 = min(max(j0, 0), WIN - 1);
  j1 = min(max(j1, 0), WIN - 1);
  const uint4 r0 = __ldg(reinterpret_cast<const uint4*>(
                             tab + (base + j0) * kN) + part);
  const uint4 r1 = __ldg(reinterpret_cast<const uint4*>(
                             tab + (base + j1) * kN) + part);
  const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&r0);
  const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&r1);
  float v[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __bfloat1622float2(h0[k]);
    const float2 b = __bfloat1622float2(h1[k]);
    v[2 * k] = w0 * a.x + w1 * b.x;
    v[2 * k + 1] = w0 * a.y + w1 * b.y;
  }
  float4* o = reinterpret_cast<float4*>(out + s * kN + part * 8);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// -------------------------------------------------------------------- B3

__global__ void __launch_bounds__(kWarps * 32)
gemm_kernel(const __nv_bfloat16* __restrict__ A,
            const __nv_bfloat16* __restrict__ B, float* __restrict__ C, int M,
            int K, int b_batched) {
  __shared__ __align__(16) __nv_bfloat16 sA[2][kWarps * 16 * kPitchA];
  __shared__ __align__(16) __nv_bfloat16 sB[2][16 * kPitchB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = blockDim.x / 2;          // 16 rows a warp
  const int64_t b = blockIdx.y;
  const int64_t m0 = (int64_t)blockIdx.x * rows;
  const __nv_bfloat16* Ab = A + (b * M + m0) * K;
  const __nv_bfloat16* Bb = B + (b_batched ? b * K * kN : 0);

  auto fetch = [&](int kt) {
    const int k0 = kt * 16;
    for (int q = threadIdx.x; q < rows * 2; q += blockDim.x)
      cp_async16(sA[kt & 1] + (q >> 1) * kPitchA + (q & 1) * 8,
                 Ab + (int64_t)(q >> 1) * K + k0 + (q & 1) * 8);
    for (int q = threadIdx.x; q < 16 * 16; q += blockDim.x)
      cp_async16(sB[kt & 1] + (q >> 4) * kPitchB + (q & 15) * 8,
                 Bb + (int64_t)(k0 + (q >> 4)) * kN + (q & 15) * 8);
    cp_async_commit();
  };

  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int nk = K / 16;
  fetch(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      fetch(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t a[4];
    ldmatrix_x4(a, sA[kt & 1] + (warp * 16 + (lane & 15)) * kPitchA +
                       (lane >> 4) * 8);
    mma_row_tile(acc, a, sB[kt & 1], lane);
    __syncthreads();
  }
  store_acc(C, b * M + m0 + warp * 16 + (lane >> 2), acc, lane);
}

template <int kMode>
int launch_onehot(const void* loc, const void* w, const void* tile,
                  const void* tab, void* out, int64_t S, int G, int WIN,
                  int n_rows, cudaStream_t st) {
  onehot_gather_kernel<kMode><<<(unsigned)(S / (kWarps * 16)), kWarps * 32, 0,
                                st>>>(
      (const int32_t*)loc, (const float*)w, (const int32_t*)tile,
      (const __nv_bfloat16*)tab, (float*)out, G, WIN, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). All tensors contiguous; each
// launches on `stream` and returns cudaGetLastError() (0 on success).

// B1 / B2: out (S, 128) f32 from tab (n_rows, 128) bf16. mode 0 (static
// window: n_rows == WIN) and 1 (dynamic base): loc (S, 2) int32 global rows,
// w (S, 2) f32; mode 2 (sorted tile): loc (S,) int32 in [0, WIN), tile
// (S / G,) int32 tile of each group, w unused. G a multiple of 64 dividing
// S; WIN a multiple of 64.
extern "C" int probe_onehot_gather(const void* loc, const void* w,
                                   const void* tile, const void* tab,
                                   void* out, int S, int G, int WIN,
                                   int n_rows, int mode, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || G <= 0 || G % (kWarps * 16) || S % G || WIN <= 0 ||
      WIN % kChunk || WIN > n_rows)
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kStatic:
      return launch_onehot<kStatic>(loc, w, tile, tab, out, S, G, WIN, n_rows, st);
    case kDynamic:
      return launch_onehot<kDynamic>(loc, w, tile, tab, out, S, G, WIN, n_rows, st);
    case kTile:
      return launch_onehot<kTile>(loc, w, tile, tab, out, S, G, WIN, n_rows, st);
  }
  return (int)cudaErrorInvalidValue;
}

// B1 direct: the same function as modes 0 and 1 of probe_onehot_gather,
// from the two rows of each sample.
extern "C" int probe_direct_gather(const void* loc, const void* w,
                                   const void* tab, void* out, int S, int G,
                                   int WIN, int n_rows, int dynamic,
                                   void* stream) {
  if (S <= 0 || G <= 0 || S % G || WIN <= 0 || WIN > n_rows)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)S * 16;
  direct_gather_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)loc, (const float*)w, (const __nv_bfloat16*)tab,
      (float*)out, S, G, WIN, n_rows, dynamic);
  return (int)cudaGetLastError();
}

// B3: C (batch, M, 128) f32 = A (batch, M, K) bf16 @ B, B (K, 128) bf16
// shared (b_batched 0) or (batch, K, 128). M a multiple of 16, K of 16.
extern "C" int probe_gemm(const void* A, const void* B, void* C, int batch,
                          int M, int K, int b_batched, void* stream) {
  if (batch <= 0 || M <= 0 || K <= 0 || M % 16 || K % 16 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  int warps = kWarps;
  while (M % (warps * 16)) warps >>= 1;       // 4, 2 or 1 warps a block
  dim3 grid(M / (warps * 16), batch);
  gemm_kernel<<<grid, warps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (float*)C, M, K,
      b_batched);
  return (int)cudaGetLastError();
}
