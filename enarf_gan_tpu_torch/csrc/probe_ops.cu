// One-construct kernels and launch cost for Hopper (sm_90a): family D of the
// probes (Python side enarf_gan_tpu_torch/tools/constructs.py).
//
// Replaces the TPU probe kernels that asked whether Mosaic compiles one
// construct, and at what cost:
//   tools/bisect_hat_kernel.py:32 load_c, hat_bcast, cat_sub, lane_slice,
//     mask_hat (bdiag_dot: probe_mma.cu)
//   tools/bisect_kernel_ops.py:53-135 block6d, concat_mid, reshape_lead,
//     iota_sepw, sigmoid_prod, multi_out, grid_6d (dot_kshape: probe_mma.cu)
//   tools/probe_kernel_variants.py:46 the warm-up kernel (2 x)
//   tools/probe_mosaic_caps.py:67-119 reshape_fm, reshape_tm, ewr
//     (gather_sub, gather_lane: probe_gather.cu; dot_batched: probe_mma.cu)
//   tools/probe_mosaic_coord_ops.py:69 expand, bcast (swapT: probe_gather.cu)
//   tools/probe_call_structure.py:55 trivial bodies under the hat kernel's
//     argument roster (1 to 7 inputs, 1 or 2 outputs)
// On this card every construct compiles (nvcc has no Mosaic layout rules);
// the questions left are whether each gives the right answer, what ptxas
// makes of it and what a launch costs. Most constructs are one
// instantiation of construct_kernel<kOp>: one thread per output element,
// grid-stride, reading what the element needs (bound: bytes, or the
// float32 operations of the reductions). Where one thread an element of
// narrow loads left a construct slower than one PyTorch call of the same
// function, it has a kernel of its own, on a grid that
// tools/constructs.py's plans give: reshape_fm (reshape_fm_kernel: 16-byte
// loads, a shuffle reduction; reduce_plan), ewr (ewr_mma_kernel: a warp a
// batch element on mma.sync, fragments straight from global memory;
// ewr_plan), reshape_lead and the three doubling constructs load_c,
// warm and cat_sub, which all compute x + x (vec4_kernel<false> and
// <true>: a 16-byte vector a thread; copy_plan), expand (expand_kernel: a
// 16-byte store a thread of one broadcast word; copy_plan) and concat_mid
// (concat_mid_kernel: a 16-byte vector a thread; copy_plan). The roster
// kernels do trivial work on 32 floats
// of each argument, so that their time is the launch's; probe_spin holds
// the stream for a set time, so that launches queued behind it show the
// device's own cost per launch once it drains them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  kLoadC = 0, kHatBcast, kCatSub, kLaneSlice, kMaskHat, kBlock6d, kConcatMid,
  kReshapeLead, kIotaSepw, kSigmoidProd, kMultiOut, kGrid6d, kWarm,
  kReshapeFm, kReshapeTm, kEwr, kExpand, kBcast, kNumOps
};

__device__ __forceinline__ float bf(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float hat(float t, float x) {
  return fmaxf(0.f, 1.f - fabsf(t - x));
}

// d0, d1, d2: the construct's dimensions (see the entry point)
template <int kOp>
__global__ void __launch_bounds__(256)
construct_kernel(const void* __restrict__ in0, const void* __restrict__ in1,
                 float* __restrict__ out0, float* __restrict__ out1,
                 int64_t n, int d0, int d1, int d2) {
  const float* x = reinterpret_cast<const float*>(in0);
  const __nv_bfloat16* h0 = reinterpret_cast<const __nv_bfloat16*>(in0);
  const __nv_bfloat16* h1 = reinterpret_cast<const __nv_bfloat16*>(in1);
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    if constexpr (kOp == kHatBcast) {                 // sum_l hat(l, x)
      const float xe = x[e];
      for (int l = 0; l < 128; ++l) v += hat((float)l, xe);
    } else if constexpr (kOp == kLaneSlice) {         // in1 = win bf16, d0 = M
      const int f = (int)(e % 32);
      const int64_t uj = e / 32;                      // u * M + j
      const float xe = reinterpret_cast<const float*>(in0)[uj];
      for (int q = 0; q < 4; ++q)
        v += bf(h1, uj * 128 + 32 * q + f) * (xe + (float)q);
    } else if constexpr (kOp == kMaskHat) {
      const float xe = x[e];
      for (int t = 0; t < 64; ++t)
        v += hat((float)(t / 8), xe) * hat((float)(t % 8), xe);
    } else if constexpr (kOp == kBlock6d) {           // d0 = TB, d1 = Mp
      const int64_t tb = e / 128;
      const int lam = (int)(e % 128);
      for (int pg = 0; pg < 3 * d1; ++pg)
        for (int s = 0; s < 16; ++s)
          v += bf(h0, (((int64_t)pg * d0 + tb) * 16 + s) * 128 + lam);
    } else if constexpr (kOp == kIotaSepw) {          // d0 = M
      const int sig = (int)(e % 16);
      const int64_t row = e / 16;                     // tb * 2M + r
      const int64_t tb = row / (2 * d0);
      const int r = (int)(row - tb * 2 * d0);
      const float c = x[tb * d0 + (r < d0 ? r : r - d0)];
      v = ((float)(sig / 2) == c ? 1.f : 0.f) *
          ((sig % 2) == (r / d0) ? 1.f : 0.f);
    } else if constexpr (kOp == kSigmoidProd) {
      float cw = 1.f;
      for (int k = 0; k < 3; ++k) cw *= 1.f / (1.f + expf(-x[e]));
      v = cw;
    } else if constexpr (kOp == kMultiOut) {
      v = x[e] * 2.f;
      out1[e] = x[e] + 1.f;
    } else if constexpr (kOp == kGrid6d) {            // plane 0, slot 0
      const int64_t u = e / 128;
      const int lam = (int)(e % 128);
      for (int s = 0; s < 16; ++s) v += bf(h0, (u * 16 + s) * 128 + lam);
    } else if constexpr (kOp == kReshapeTm) {
      const int64_t tb = e / 32;
      const int c = (int)(e % 32);
      for (int t = 0; t < 64; ++t) v += bf(h0, tb * 2048 + t * 32 + c);
    } else if constexpr (kOp == kBcast) {             // d0 = TB, d1 = M
      const int lam = (int)(e % 128);
      const int64_t row = e / 128;                    // tb * 2M + r
      const int64_t tb = row / (2 * d1);
      const int r = (int)(row - tb * 2 * d1);
      const float xv = x[(int64_t)(r < d1 ? r : r - d1) * d0 + tb];
      v = hat((float)((lam % 16) / 2), xv);
    }
    out0[e] = v;
  }
}

// reshape_fm, (TB, 2048) bf16 -> (TB, 32) float32: out[t, c] = the float32
// sum of x[t, 64c .. 64c + 63]. Bound: bytes (each 4 KB row read once).
// Block t of 256 threads takes row t; thread i reads the row's 16-byte
// vector i, which is the (i % 8)-th of output i / 8's 128 bytes, so a
// warp's load instruction covers 512 contiguous bytes (4 outputs). A lane
// sums its 8 values in float32, the 8 lanes of an output add theirs with
// three xor shuffles, and lane 0 stores the warp's 4 sums as one 16-byte
// store.
constexpr int kFmThreads = 256;        // constructs.REDUCE_THREADS
constexpr int kFmVecs = 2048 * 2 / 16;  // 16-byte vectors a row

__device__ __forceinline__ float sum8(const uint4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    s += f.x;
    s += f.y;
  }
  return s;
}

__global__ void __launch_bounds__(kFmThreads)
reshape_fm_kernel(const uint4* __restrict__ x, float4* __restrict__ out,
                  long long TB) {
  const long long row = blockIdx.x;
  if (row >= TB) return;                // the same for the whole block
  float s = sum8(__ldg(x + row * kFmVecs + threadIdx.x));
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  const float s1 = __shfl_sync(0xffffffffu, s, 8);
  const float s2 = __shfl_sync(0xffffffffu, s, 16);
  const float s3 = __shfl_sync(0xffffffffu, s, 24);
  if ((threadIdx.x & 31) == 0)
    out[row * (kFmThreads / 32) + (threadIdx.x >> 5)] =
        make_float4(s, s1, s2, s3);
}

// reshape_lead: merging leading axes is a copy of n float32 words; load_c,
// warm and cat_sub are each twice a float32 tensor (x * 2.0, or
// concat([x, x], 1)[:, :M] + [:, M:], which is x + x: the same bits in
// IEEE float32, overflow included). Bound: bytes. Thread i of block b
// copies (kTwice: doubles) the 16-byte vector b * 256 + i, with 32-bit
// indices and no loop (a block's vectors are 4 KB contiguous); block 0
// also does the last n % 4 words.
constexpr int kCopyThreads = 256;      // constructs.COPY_THREADS

__device__ __forceinline__ float4 doubled(float4 v) {
  return make_float4(v.x + v.x, v.y + v.y, v.z + v.z, v.w + v.w);
}

template <bool kTwice>
__global__ void __launch_bounds__(kCopyThreads)
vec4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
            unsigned n) {
  const unsigned n4 = n >> 2;
  const unsigned i = blockIdx.x * kCopyThreads + threadIdx.x;
  if (i < n4) out[i] = kTwice ? doubled(__ldg(x + i)) : __ldg(x + i);
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const float v = reinterpret_cast<const float*>(x)[n4 * 4 + threadIdx.x];
    reinterpret_cast<float*>(out)[n4 * 4 + threadIdx.x] = kTwice ? v + v : v;
  }
}

// expand, x (M, TB) float32 -> (TB, M, 128) float32: out[tb, j, l] =
// x[j, tb]. Bound: bytes (1 MB written from 8 KB read at the probe's M 16,
// TB 128). Thread i of block b stores the 16-byte vector v = b * 256 + i,
// four copies of x[j, tb] with tb * M + j = v / 32: a warp stores one
// 512-byte row of 128 words and reads one word, at one address for all its
// lanes. 32-bit indices and no loop, on copy_plan's grid (the rows' 128
// words make every vector whole).
__global__ void __launch_bounds__(kCopyThreads)
expand_kernel(const float* __restrict__ x, float4* __restrict__ out,
              unsigned TB, unsigned M) {
  const unsigned v = blockIdx.x * kCopyThreads + threadIdx.x;
  const unsigned row = v >> 5;          // tb * M + j
  if (row >= TB * M) return;
  const unsigned tb = row / M;
  const float e = __ldg(x + (row - tb * M) * TB + tb);
  out[v] = make_float4(e, e, e, e);
}

// concat_mid, x (TB, M) float32 -> (TB, 2M): out[tb] = [x[tb], x[tb]].
// Bound: bytes (8 KB read, 16 KB written at the probe's TB 128, M 16).
// kVec (M a multiple of 4): thread i of block b stores the 16-byte vector
// v = b * 256 + i, of row tb = v / (M / 2), which is x's vector tb M / 4 +
// (v mod M / 2) mod M / 4; 32-bit indices and no loop, on copy_plan's grid
// of the output. Else the same map word by word, a word a thread
// (word_plan).
template <bool kVec>
__global__ void __launch_bounds__(kCopyThreads)
concat_mid_kernel(const float* __restrict__ x, float* __restrict__ out,
                  unsigned TB, unsigned M) {
  const unsigned i = blockIdx.x * kCopyThreads + threadIdx.x;
  const unsigned q = kVec ? M >> 2 : M;        // vectors (words) of a row
  if (i >= 2 * TB * q) return;
  const unsigned tb = i / (2 * q), c = i - tb * 2 * q;
  const unsigned src = tb * q + (c < q ? c : c - q);
  if (kVec)
    reinterpret_cast<float4*>(out)[i] =
        __ldg(reinterpret_cast<const float4*>(x) + src);
  else
    out[i] = __ldg(x + src);
}

// ewr, (TB, 16, 64) bf16 . (TB, 32, 64) bf16 over the 64 -> (TB, 16, 32)
// float32: out[b, m, n] = sum_k x[b, m, k] y[b, n, k]. Bound: bytes (1 MB
// at the probe's TB 128, against 8.4 MFLOP). One warp a batch element:
// 4 n-tiles of 8 columns x 4 k-steps of 16, 16 mma.sync.m16n8k16 (bf16 in,
// float32 sums) into 16 accumulators a lane. A sum over k does not depend
// on k's order, so one permutation of k, the same for both operands, lets
// each lane build its fragments from 16-byte vectors read straight from
// global memory (no shared memory, no ldmatrix): lane (g, t) = (lane / 4,
// lane % 4) loads x's rows g and g + 8 and y's rows 8j + g (j < 4) at k =
// 32c + 8t .. 32c + 8t + 7 (c < 2), 12 vectors, all before the first mma.
// A vector's words 0 and 1 are k-step 2c's a0 / a2 (b0 / b1) and words 2
// and 3 step 2c + 1's: lane t's k-pair 2t (2t + 8) of step 2c + h is
// physical k 32c + 8t + 4h (+ 2), in x and in y alike. A warp's load
// instruction covers 8 rows x 64 contiguous bytes, whole 32-byte sectors.
// C leaves as float2s (rows g and g + 8, columns 8j + 2t, 8j + 2t + 1).
// Blocks of kEwrWarps warps (tools/constructs.py's ewr_plan); the warps
// past TB in the last block exit.
constexpr int kEwrWarps = 2;           // constructs.EWR_WARPS

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kEwrWarps * 32)
ewr_mma_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
               float2* __restrict__ out, int TB) {
  const long long b = (long long)blockIdx.x * kEwrWarps + (threadIdx.x >> 5);
  if (b >= TB) return;                  // the same for the whole warp
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint4* xb = x + b * 16 * 8;     // 8 vectors a 128-byte row
  const uint4* yb = y + b * 32 * 8;
  uint4 xv[2][2], yv[4][2];             // [row g, g + 8][c], [j][c]
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    xv[0][c] = __ldg(xb + g * 8 + 4 * c + t);
    xv[1][c] = __ldg(xb + (g + 8) * 8 + 4 * c + t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yv[j][c] = __ldg(yb + (8 * j + g) * 8 + 4 * c + t);
  }
  float acc[4][4] = {};
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[j], word(xv[0][c], 2 * h), word(xv[1][c], 2 * h),
                 word(xv[0][c], 2 * h + 1), word(xv[1][c], 2 * h + 1),
                 word(yv[j][c], 2 * h), word(yv[j][c], 2 * h + 1));
  float2* ob = out + b * 16 * 16;       // 16 float2 a 32-float row
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ob[g * 16 + 4 * j + t] = make_float2(acc[j][0], acc[j][1]);
    ob[(g + 8) * 16 + 4 * j + t] = make_float2(acc[j][2], acc[j][3]);
  }
}

template <int kOp>
int launch_construct(const void* in0, const void* in1, void* out0, void* out1,
                     int64_t n, int d0, int d1, int d2, cudaStream_t st) {
  int64_t blocks = (n + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  construct_kernel<kOp><<<(unsigned)blocks, 256, 0, st>>>(
      in0, in1, (float*)out0, (float*)out1, n, d0, d1, d2);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const void*, const void*, void*, void*, int64_t, int,
                         int, int, cudaStream_t);

// null for the constructs with kernels of their own (no construct_kernel
// instantiation is compiled for them)
template <int kOp>
constexpr LaunchFn launcher() {
  if constexpr (kOp == kLoadC || kOp == kCatSub || kOp == kReshapeLead ||
                kOp == kWarm || kOp == kReshapeFm || kOp == kEwr ||
                kOp == kExpand || kOp == kConcatMid)
    return nullptr;
  else
    return launch_construct<kOp>;
}

template <int... kOps>
struct Table {
  static constexpr LaunchFn fns[] = {launcher<kOps>()...};
};

using Ops = Table<0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                  17>;

// the roster kernels: trivial work on 32 floats of every argument
__global__ void roster_kernel(const float* a0, const float* a1,
                              const float* a2, const float* a3,
                              const float* a4, const float* a5,
                              const float* a6, float* o0, float* o1) {
  const int t = threadIdx.x;
  float s = a0[t];
  if (a1) s += a1[t];
  if (a2) s += a2[t] + a3[t] + a4[t] + a5[t] + a6[t];
  o0[t] = s;
  if (o1) o1[t] = 2.f * a0[t];
}

int roster(const void* a0, const void* a1, const void* a2, const void* a3,
           const void* a4, const void* a5, const void* a6, void* o0, void* o1,
           void* stream) {
  roster_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)a0, (const float*)a1, (const float*)a2, (const float*)a3,
      (const float*)a4, (const float*)a5, (const float*)a6, (float*)o0,
      (float*)o1);
  return (int)cudaGetLastError();
}

__global__ void spin_kernel(long long ns) {
  long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() (0 on success).

// A construct (Op) over n output elements; inputs float32 or bf16 as the
// construct reads them, outputs float32; d0, d1, d2 its dimensions.
extern "C" int probe_construct(int op, const void* in0, const void* in1,
                               void* out0, void* out1, long long n, int d0,
                               int d1, int d2, void* stream) {
  if (op < 0 || op >= kNumOps || n <= 0 || Ops::fns[op] == nullptr)
    return (int)cudaErrorInvalidValue;
  return Ops::fns[op](in0, in1, out0, out1, n, d0, d1, d2,
                      (cudaStream_t)stream);
}

static bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// reshape_fm over TB rows: `blocks` (>= TB) blocks of 256 threads, a row a
// block (constructs.reduce_plan); x and out on 16 bytes.
extern "C" int probe_reshape_fm(const void* x, void* out, long long TB,
                                int blocks, void* stream) {
  if (TB <= 0 || blocks < TB) return (int)cudaErrorInvalidValue;
  if (!aligned16(x, out)) return (int)cudaErrorMisalignedAddress;
  reshape_fm_kernel<<<blocks, kFmThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (float4*)out, TB);
  return (int)cudaGetLastError();
}

// reshape_lead as a copy, or load_c, warm and cat_sub as twice (`twice`
// nonzero), of n float32 words: `blocks` blocks of 256 threads, a 16-byte
// vector a thread (constructs.copy_plan); x and out on 16 bytes, n and the
// grid's threads within 2^32 (32-bit indices).
extern "C" int probe_vec4(const void* x, void* out, long long n, int twice,
                          int blocks, void* stream) {
  if (n <= 0 || n >= (1LL << 32) || blocks <= 0 || blocks > (1 << 24) ||
      (long long)blocks * kCopyThreads < (n >> 2))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x, out)) return (int)cudaErrorMisalignedAddress;
  auto kernel = twice ? vec4_kernel<true> : vec4_kernel<false>;
  kernel<<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, (unsigned)n);
  return (int)cudaGetLastError();
}

// expand of x (M, TB) into (TB, M, 128): `blocks` blocks of 256 threads, a
// 16-byte vector of the output a thread (constructs.copy_plan); out on 16
// bytes, the output's vectors within 2^32 (32-bit indices).
extern "C" int probe_expand(const void* x, void* out, long long TB,
                            long long M, int blocks, void* stream) {
  if (TB <= 0 || M <= 0 || TB * M >= (1LL << 27) || blocks <= 0 ||
      (long long)blocks * kCopyThreads < TB * M * 32)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x, out)) return (int)cudaErrorMisalignedAddress;
  expand_kernel<<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float4*)out, (unsigned)TB, (unsigned)M);
  return (int)cudaGetLastError();
}

// concat_mid of x (TB, M) into (TB, 2M): `blocks` blocks of 256 threads, a
// 16-byte vector of the output a thread where M is a multiple of 4
// (constructs.copy_plan), else a word a thread (constructs.word_plan); x
// and out on 16 bytes, the output's words within 2^31 (32-bit indices).
extern "C" int probe_concat_mid(const void* x, void* out, long long TB,
                                long long M, int blocks, void* stream) {
  const bool vec = M % 4 == 0;
  if (TB <= 0 || M <= 0 || 2 * TB * M >= (1LL << 31) || blocks <= 0 ||
      (long long)blocks * kCopyThreads < 2 * TB * M / (vec ? 4 : 1))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x, out)) return (int)cudaErrorMisalignedAddress;
  auto kernel = vec ? concat_mid_kernel<true> : concat_mid_kernel<false>;
  kernel<<<blocks, kCopyThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (unsigned)TB, (unsigned)M);
  return (int)cudaGetLastError();
}

// ewr over TB batch elements: `blocks` blocks of kEwrWarps warps, a warp a
// batch element (constructs.ewr_plan); x, y and out on 16 bytes.
extern "C" int probe_ewr(const void* x, const void* y, void* out,
                         long long TB, int blocks, void* stream) {
  if (TB <= 0 || TB > INT32_MAX || blocks <= 0 ||
      (long long)blocks * kEwrWarps < TB)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x, y) || !aligned16(y, out))
    return (int)cudaErrorMisalignedAddress;
  ewr_mma_kernel<<<blocks, kEwrWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (const uint4*)y, (float2*)out, (int)TB);
  return (int)cudaGetLastError();
}

// The argument rosters of tools/probe_call_structure.py: inputs, outputs.
extern "C" int probe_roster_1_1(const void* a0, void* o0, void* stream) {
  return roster(a0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o0,
                nullptr, stream);
}
extern "C" int probe_roster_2_1(const void* a0, const void* a1, void* o0,
                                void* stream) {
  return roster(a0, a1, nullptr, nullptr, nullptr, nullptr, nullptr, o0,
                nullptr, stream);
}
extern "C" int probe_roster_1_2(const void* a0, void* o0, void* o1,
                                void* stream) {
  return roster(a0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, o0,
                o1, stream);
}
extern "C" int probe_roster_7_1(const void* a0, const void* a1,
                                const void* a2, const void* a3,
                                const void* a4, const void* a5,
                                const void* a6, void* o0, void* stream) {
  return roster(a0, a1, a2, a3, a4, a5, a6, o0, nullptr, stream);
}
extern "C" int probe_roster_7_2(const void* a0, const void* a1,
                                const void* a2, const void* a3,
                                const void* a4, const void* a5,
                                const void* a6, void* o0, void* o1,
                                void* stream) {
  return roster(a0, a1, a2, a3, a4, a5, a6, o0, o1, stream);
}

// Holds the stream for `ns` nanoseconds (one thread reading the global
// timer), so that launches queued behind it run back to back.
extern "C" int probe_spin(long long ns, void* stream) {
  spin_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ns);
  return (int)cudaGetLastError();
}
