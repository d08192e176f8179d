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
// makes of it and what a launch costs. Each construct is one instantiation
// of construct_kernel<kOp>: one thread per output element, grid-stride,
// reading what the element needs (bound: bytes, or the float32 operations
// of the reductions). The roster kernels do trivial work on 32 floats of
// each argument, so that their time is the launch's; probe_spin holds the
// stream for a set time, so that launches queued behind it show the
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
    if constexpr (kOp == kLoadC || kOp == kWarm) {
      v = x[e] * 2.f;
    } else if constexpr (kOp == kHatBcast) {          // sum_l hat(l, x)
      const float xe = x[e];
      for (int l = 0; l < 128; ++l) v += hat((float)l, xe);
    } else if constexpr (kOp == kCatSub) {            // d0 = M
      const int64_t u = e / d0;
      const int j = (int)(e - u * d0);
      // x2 = concat([x, x], 1); x2[:, :M] + x2[:, M:]
      const int a = j, b = d0 + j;
      v = x[u * d0 + (a < d0 ? a : a - d0)] + x[u * d0 + (b < d0 ? b : b - d0)];
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
    } else if constexpr (kOp == kConcatMid) {         // d0 = M
      const int64_t tb = e / (2 * d0);
      const int r = (int)(e - tb * 2 * d0);
      v = x[tb * d0 + (r < d0 ? r : r - d0)];
    } else if constexpr (kOp == kReshapeLead) {
      v = x[e];
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
    } else if constexpr (kOp == kReshapeFm) {         // (TB, 2048) -> (TB, 32)
      const int64_t tb = e / 32;
      const int c = (int)(e % 32);
      for (int k = 0; k < 64; ++k) v += bf(h0, tb * 2048 + c * 64 + k);
    } else if constexpr (kOp == kReshapeTm) {
      const int64_t tb = e / 32;
      const int c = (int)(e % 32);
      for (int t = 0; t < 64; ++t) v += bf(h0, tb * 2048 + t * 32 + c);
    } else if constexpr (kOp == kEwr) {               // (TB,16,64).(TB,32,64)
      const int f = (int)(e % 32);
      const int64_t tj = e / 32;                      // tb * 16 + j
      const int64_t tb = tj / 16;
      for (int k = 0; k < 64; ++k)
        v += bf(h0, tj * 64 + k) * bf(h1, (tb * 32 + f) * 64 + k);
    } else if constexpr (kOp == kExpand) {            // d0 = TB, d1 = M
      const int64_t tj = e / 128;
      const int64_t tb = tj / d1;
      const int j = (int)(tj - tb * d1);
      v = x[(int64_t)j * d0 + tb];
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

template <int... kOps>
struct Table {
  static constexpr LaunchFn fns[] = {launch_construct<kOps>...};
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
  if (op < 0 || op >= kNumOps || n <= 0) return (int)cudaErrorInvalidValue;
  return Ops::fns[op](in0, in1, out0, out1, n, d0, d1, d2,
                      (cudaStream_t)stream);
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
