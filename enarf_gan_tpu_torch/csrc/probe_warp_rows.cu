// What bounds A2 (probe_gather.cu's row_warp_kernel), one warp copying rows
// by index in turn: kernels that take its loop apart, at its main case
// (rows of 512 bytes, 32 lanes a row; Python side
// enarf_gan_tpu_torch/tools/warp_rows.py). Each is one warp a loop of k rows
// with the loop's indices staged in shared memory first.
//   loads<B, S>: cp.async of B bytes a lane (512 / (32 B) loads a row) into
//     a ring of S groups of 8 rows, S - 1 groups in flight; nothing stored
//     (one word a lane goes out, so that the loads are not dead).
//   stores: 16 bytes a lane a row; nothing loaded.
//   ring: loads as loads<16, 4> and each lane's own stores of what it
//     copied (A2 with its stores on the warp's own path); W warps a block,
//     each its own loop, say whether the bound is the warp's or the SM's.
//   tma_ring: rows fetched by TMA bulk copies (lane 0, 16 rows in flight, an
//     mbarrier each) and stored by the lanes.
//   chase: one row's latency from L2: the warp loads a row, whose first word
//     names the next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIdx = 4096;            // bytes of staged indices (1,024 rows)
constexpr int kGroup = 8;             // rows a cp.async group
constexpr int kRow = 32;              // 16-byte units a row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the warp's k rows from r0 and their indices, staged in shared memory
__device__ __forceinline__ int stage_rows(const int32_t* idx, int* sidx,
                                          int64_t r0, int n, int k) {
  const int rows = (int)min((int64_t)k, (int64_t)n - r0);
  for (int r = threadIdx.x & 31; r < rows; r += 32) sidx[r] = __ldg(idx + r0 + r);
  __syncwarp();
  return rows;
}

// loads (kStore false) or the ring with stores (kStore true); W warps a
// block, each with its own indices and ring
template <int B, int S, bool kStore>
__global__ void __launch_bounds__(256)
loop_kernel(const uint4* __restrict__ tab, const int32_t* __restrict__ idx,
            uint4* __restrict__ out, int n, int k) {
  constexpr int P = 16 / B, GB = kGroup * 512;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* mine = smem_raw + w * (kIdx + S * GB);
  int* sidx = reinterpret_cast<int*>(mine);
  unsigned char* ring = mine + kIdx;
  const int64_t r0 = ((int64_t)blockIdx.x * (blockDim.x >> 5) + w) * k;
  if (r0 >= n) return;
  const int rows = stage_rows(idx, sidx, r0, n, k);
  const int groups = (rows + kGroup - 1) / kGroup;
  auto issue = [&](int g) {
    if (g < groups) {
      unsigned char* slot = ring + (g % S) * GB;
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int r = g * kGroup + u;
        if (r >= rows) break;
        const char* src = reinterpret_cast<const char*>(
            tab + (int64_t)sidx[r] * kRow);
#pragma unroll
        for (int p = 0; p < P; ++p)
          cp_async<B>(slot + u * 512 + (p * 32 + lane) * B,
                      src + (p * 32 + lane) * B);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < S - 1; ++g) issue(g);
  unsigned acc = 0;
  for (int g = 0; g < groups; ++g) {
    issue(g + S - 1);
    cp_async_wait<S - 1>();
    const uint4* slot = reinterpret_cast<const uint4*>(ring + (g % S) * GB);
    if (kStore) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int r = g * kGroup + u;
        if (r < rows) out[(r0 + r) * kRow + lane] = slot[u * kRow + lane];
      }
    } else {
      acc ^= slot[lane].x;
    }
  }
  if (!kStore) reinterpret_cast<unsigned*>(out)[blockIdx.x * blockDim.x +
                                               threadIdx.x] = acc;
}

__global__ void __launch_bounds__(32)
stores_kernel(uint4* __restrict__ out, int n, int k) {
  const int lane = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * k;
  for (int r = 0; r < k && r0 + r < n; ++r)
    out[(r0 + r) * kRow + lane] = make_uint4(lane, r, 0, 0);
}

constexpr int kTmaSlots = 16;

__global__ void __launch_bounds__(32)
tma_ring_kernel(const uint4* __restrict__ tab, const int32_t* __restrict__ idx,
                uint4* __restrict__ out, int n, int k) {
  constexpr int R = kTmaSlots;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  int* sidx = reinterpret_cast<int*>(smem_raw + 128 * 8);
  uint4* slots = reinterpret_cast<uint4*>(smem_raw + 128 * 8 + kIdx);
  const int lane = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * k;
  const int rows = stage_rows(idx, sidx, r0, n, k);
  if (lane == 0) {
    for (int s = 0; s < R; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto fetch = [&](int r) {                  // lane 0: row r into its slot
    const unsigned b = smem_addr(bar + r % R);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 512;\n"
                 ::"r"(b) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], 512, [%2];\n" ::"r"(smem_addr(slots + (r % R) * kRow)),
        "l"(tab + (int64_t)sidx[r] * kRow), "r"(b) : "memory");
  };
  if (lane == 0)
    for (int r = 0; r < R && r < rows; ++r) fetch(r);
  for (int r = 0; r < rows; ++r) {
    asm volatile(
        "{\n .reg .pred p;\n WAIT:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        " @!p bra WAIT;\n}\n" ::"r"(smem_addr(bar + r % R)),
        "r"((unsigned)(r / R) & 1) : "memory");
    out[(r0 + r) * kRow + lane] = slots[(r % R) * kRow + lane];
    __syncwarp();                            // the slot is read: refill it
    if (lane == 0 && r + R < rows) fetch(r + R);
  }
}

__global__ void chase_kernel(const int32_t* __restrict__ tab, int hops,
                             int32_t* __restrict__ out) {
  int j = 0;
  for (int h = 0; h < hops; ++h) {
    const int4 v = reinterpret_cast<const int4*>(tab + (int64_t)j * 128)[threadIdx.x];
    j = __shfl_sync(0xffffffffu, v.x, 0);
  }
  if (threadIdx.x == 0) *out = j;
}

template <typename K>
int launch(K kern, int grid, int block, int smem, cudaStream_t st,
           const void* tab, const void* idx, void* out, int n, int k) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<grid, block, smem, st>>>((const uint4*)tab, (const int32_t*)idx,
                                  (uint4*)out, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0: loads<B, S> (B = 4, 8, 16; S = 2, 8); 1: ring of W warps a block
// (W = 1, 2, 4, 8); 2: stores; 3: tma_ring. tab (rows, 128) f32, idx (n,)
// int32, out (n, 128) f32 (kinds 1-3) or at least a word a thread (kind 0);
// one warp a loop of k rows.
extern "C" int probe_warp_rows(int kind, int B, int S, int W, const void* tab,
                               const void* idx, void* out, int n, int k,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || k <= 0 || k > kIdx / 4) return (int)cudaErrorInvalidValue;
  const int loops = (n + k - 1) / k;
  if (kind == 0) {
    const int smem = kIdx + S * kGroup * 512;
#define LOADS(BB, SS)                                                       \
  if (B == BB && S == SS)                                                   \
    return launch(loop_kernel<BB, SS, false>, loops, 32, smem, st, tab, idx, \
                  out, n, k);
    LOADS(4, 8) LOADS(8, 8) LOADS(16, 8) LOADS(16, 2)
#undef LOADS
  } else if (kind == 1 && (W == 1 || W == 2 || W == 4 || W == 8) &&
             loops % W == 0) {
    return launch(loop_kernel<16, 4, true>, loops / W, 32 * W,
                  W * (kIdx + 4 * kGroup * 512), st, tab, idx, out, n, k);
  } else if (kind == 2) {
    stores_kernel<<<loops, 32, 0, st>>>((uint4*)out, n, k);
    return (int)cudaGetLastError();
  } else if (kind == 3) {
    return launch(tma_ring_kernel, loops, 32,
                  128 * 8 + kIdx + kTmaSlots * 512, st, tab, idx, out, n, k);
  }
  return (int)cudaErrorInvalidValue;
}

// one warp's chase of `hops` rows through tab (rows, 128) int32, whose word
// 0 of row j names the next row; the last row to out[0]
extern "C" int probe_warp_chase(const void* tab, int hops, void* out,
                                void* stream) {
  chase_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int32_t*)tab, hops,
                                                   (int32_t*)out);
  return (int)cudaGetLastError();
}
