// Row and lane gathers for Hopper (sm_90a): the microbenchmarks that ask how
// fast this card fetches rows by index (family A of the probes; Python side
// enarf_gan_tpu_torch/tools/gather.py).
//
// Replaces the TPU probe kernels
//   tools/bench_unitable.py:59 kern_take, :73 kern_dslice    (A1, A2)
//   tools/bench_gather.py:155 dg_kernel                      (A3)
//   tools/bench_dyngather2.py:176 dg_kernel                  (A3)
//   tools/bench_pallas_take2.py:30 kernels a-d               (A3, A1)
//   tools/probe_mosaic_caps.py gather_sub, gather_lane       (A1, A3)
//   tools/probe_kernel_dma.py:114 dma_kernel                 (A4)
//   tools/probe_kernel_dma.py:144 relay_kernel               (A5)
//   tools/probe_mosaic_coord_ops.py:69 swapT                 (A5)
// The TPU asked whether Mosaic could gather at all and at what rate; here
// every gather compiles, and the question left is the rate: each kernel is
// bound by bytes (it moves data and computes nothing), and its time against
// the bytes it must move (indices and rows read once, outputs written once,
// over 3.35 TB/s) says how close a gather of that shape comes to HBM's rate.
//
// A1 row gather: out[i, :] = tab[idx[i], :]. One thread per 16-byte unit of
//   a row (8- or 4-byte units where the row width allows no wider), and
//   consecutive threads on consecutive units, so a warp reads 512
//   contiguous bytes of one row (a 4 KB row takes 8 warps; narrow rows put
//   several rows into one warp). Grid-stride over the output.
// A2 thread-serial loop: one thread copies its rows one after another, unit
//   by unit (the counterpart of a loop of dynamic slices).
// A3 per-lane gather: out[i, l] = tab[idx[i, l], l] over a (TH, L) table,
//   from shared memory when the table fits in a block's 227 KB (each block
//   copies it in once) and from global memory above that; also the
//   sublane-in-tile form out[i, l] = tab[(i / G) * G + idx[i, l], l] and the
//   lane form out[i, l] = tab[i, idx[i, l]].
// A4 staged ring gather: R rows a block, Q rows in flight through a ring of
//   shared-memory slots filled by cp.async (16 bytes a thread), each block
//   reducing its rows to one float32 sum, as dma_kernel reduced its buffer;
//   and the same reduction with direct loads and no staging, to say
//   whether staging pays.
// A5 transpose through shared memory: a batch of (R, C) float32 matrices,
//   each staged in a padded tile (pitch C + 1, so the column reads fall on
//   distinct banks) and written out as (C, R).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;      // a block's dynamic shared memory, H100

int grid_for(int64_t work, int per_block, int cap) {
  const int64_t g = (work + per_block - 1) / per_block;
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// ---------------------------------------------------------------- A1, A2

template <typename V>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const V* __restrict__ tab, const int32_t* __restrict__ idx,
                  V* __restrict__ out, int64_t n, int units) {
  const int64_t total = n * units;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = e / units;
    const int u = (int)(e - i * units);
    out[e] = tab[(int64_t)__ldg(idx + i) * units + u];
  }
}

template <typename V>
__global__ void row_serial_kernel(const V* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  V* __restrict__ out, int64_t n, int units,
                                  int rows_per_thread) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  for (int r = 0; r < rows_per_thread; ++r) {
    const int64_t i = t * rows_per_thread + r;
    if (i >= n) return;
    const V* src = tab + (int64_t)idx[i] * units;
    V* dst = out + i * units;
    for (int u = 0; u < units; ++u) dst[u] = src[u];
  }
}

template <typename V>
int launch_rows(const void* tab, const void* idx, void* out, int64_t n,
                int row_bytes, int rows_per_thread, cudaStream_t st) {
  const int units = row_bytes / (int)sizeof(V);
  if (rows_per_thread > 0) {
    const int64_t threads = (n + rows_per_thread - 1) / rows_per_thread;
    row_serial_kernel<V><<<grid_for(threads, 32, 1 << 30), 32, 0, st>>>(
        (const V*)tab, (const int32_t*)idx, (V*)out, n, units,
        rows_per_thread);
  } else {
    row_gather_kernel<V><<<grid_for(n * units, kThreads, sm_count() * 16),
                           kThreads, 0, st>>>(
        (const V*)tab, (const int32_t*)idx, (V*)out, n, units);
  }
  return (int)cudaGetLastError();
}

int rows_entry(const void* tab, const void* idx, void* out, int n,
               int row_bytes, int rows_per_thread, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || row_bytes <= 0 || row_bytes % 4) return (int)cudaErrorInvalidValue;
  if (row_bytes % 16 == 0)
    return launch_rows<uint4>(tab, idx, out, n, row_bytes, rows_per_thread, st);
  if (row_bytes % 8 == 0)
    return launch_rows<uint2>(tab, idx, out, n, row_bytes, rows_per_thread, st);
  return launch_rows<uint32_t>(tab, idx, out, n, row_bytes, rows_per_thread,
                               st);
}

// -------------------------------------------------------------------- A3

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int64_t n, int L, int TH, int mode,
                   int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* src = tab;
  if (kShared) {                       // mode 0 only: the whole (TH, L) table
    T* s = reinterpret_cast<T*>(smem_raw);
    const int64_t m = (int64_t)TH * L;
    const int64_t vec = m * (int64_t)sizeof(T) / 16;
    const uint4* g4 = reinterpret_cast<const uint4*>(tab);
    uint4* s4 = reinterpret_cast<uint4*>(s);
    for (int64_t k = threadIdx.x; k < vec; k += blockDim.x) s4[k] = g4[k];
    for (int64_t k = vec * 16 / (int64_t)sizeof(T) + threadIdx.x; k < m;
         k += blockDim.x)
      s[k] = tab[k];
    __syncthreads();
    src = s;
  }
  const int64_t total = n * L;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       e < total; e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = e / L;
    const int l = (int)(e - i * L);
    const int64_t j = __ldg(idx + e);
    int64_t off;
    if (mode == 0)
      off = j * L + l;                       // tab[idx[i, l], l]
    else if (mode == 1)
      off = ((i / G) * G + j) * L + l;       // within groups of G rows
    else
      off = i * L + j;                       // tab[i, idx[i, l]]
    out[e] = src[off];
  }
}

template <typename T>
int launch_lanes(const void* tab, const void* idx, void* out, int64_t n, int L,
                 int TH, int mode, int G, int use_smem, cudaStream_t st) {
  const int64_t total = n * L;
  if (use_smem) {
    const size_t smem = (size_t)TH * L * sizeof(T);
    if (mode != 0 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          lane_gather_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const int per_sm = (int)(kMaxSmem / (smem > 0 ? smem : 1));
    lane_gather_kernel<T, true><<<grid_for(total, kThreads,
                                           sm_count() * (per_sm < 1 ? 1 : per_sm)),
                                  kThreads, smem, st>>>(
        (const T*)tab, (const int32_t*)idx, (T*)out, n, L, TH, mode, G);
  } else {
    lane_gather_kernel<T, false><<<grid_for(total, kThreads, sm_count() * 16),
                                   kThreads, 0, st>>>(
        (const T*)tab, (const int32_t*)idx, (T*)out, n, L, TH, mode, G);
  }
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------------- A4

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

__device__ __forceinline__ float sum8_bf16(uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    s += f.x + f.y;
  }
  return s;
}

constexpr int kRingThreads = 128;

__device__ __forceinline__ void block_sum_store(float acc, float* out) {
  __shared__ float red[kRingThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kRingThreads / 32; ++w) s += red[w];
    *out = s;
  }
}

// rows of `chunks` 16-byte units (bf16); block b reduces rows b*R .. b*R+R-1
template <int kQ>
__global__ void __launch_bounds__(kRingThreads)
ring_gather_kernel(const uint4* __restrict__ tab,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int R, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  const int64_t base = (int64_t)blockIdx.x * R;
  auto fetch_row = [&](int r) {
    const uint4* src = tab + (int64_t)__ldg(idx + base + r) * chunks;
    uint4* dst = ring + (r % kQ) * chunks;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x)
      cp_async16(dst + k, src + k);
  };
  for (int r = 0; r < kQ - 1; ++r) {
    if (r < R) fetch_row(r);
    cp_async_commit();
  }
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    if (r + kQ - 1 < R) fetch_row(r + kQ - 1);   // the slot read at r - 1
    cp_async_commit();                         // empty groups keep the count
    cp_async_wait<kQ - 1>();                   // row r has landed
    __syncthreads();
    const uint4* row = ring + (r % kQ) * chunks;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x)
      acc += sum8_bf16(row[k]);
    __syncthreads();                           // slot r % Q is refilled next
  }
  block_sum_store(acc, out + blockIdx.x);
}

__global__ void __launch_bounds__(kRingThreads)
direct_reduce_kernel(const uint4* __restrict__ tab,
                     const int32_t* __restrict__ idx, float* __restrict__ out,
                     int R, int chunks) {
  const int64_t base = (int64_t)blockIdx.x * R;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    const uint4* src = tab + (int64_t)__ldg(idx + base + r) * chunks;
    for (int k = threadIdx.x; k < chunks; k += blockDim.x)
      acc += sum8_bf16(__ldg(src + k));
  }
  block_sum_store(acc, out + blockIdx.x);
}

template <int kQ>
int launch_ring(const void* tab, const void* idx, void* out, int n_blocks,
                int R, int chunks, cudaStream_t st) {
  const size_t smem = (size_t)kQ * chunks * 16;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_gather_kernel<kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ring_gather_kernel<kQ><<<n_blocks, kRingThreads, smem, st>>>(
      (const uint4*)tab, (const int32_t*)idx, (float*)out, R, chunks);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------------- A5

__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int NB, int R, int C) {
  extern __shared__ float tile[];            // [R][C + 1]
  const int n = R * C;
  for (int b = blockIdx.x; b < NB; b += gridDim.x) {
    const float* src = x + (int64_t)b * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / C, c = e - (e / C) * C;
      tile[r * (C + 1) + c] = src[e];
    }
    __syncthreads();
    float* dst = out + (int64_t)b * n;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int c = e / R, r = e - (e / R) * R;
      dst[e] = tile[r * (C + 1) + c];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). All tensors contiguous; each
// launches on `stream` and returns cudaGetLastError() (0 on success).

// A1: out (n, row_bytes) = tab (rows, row_bytes)[idx (n,) int32];
// row_bytes a multiple of 4.
extern "C" int probe_row_gather(const void* tab, const void* idx, void* out,
                                int n, int row_bytes, void* stream) {
  return rows_entry(tab, idx, out, n, row_bytes, 0, stream);
}

// A2: the same function, one thread walking rows_per_thread rows in turn.
extern "C" int probe_row_serial(const void* tab, const void* idx, void* out,
                                int n, int row_bytes, int rows_per_thread,
                                void* stream) {
  if (rows_per_thread <= 0) return (int)cudaErrorInvalidValue;
  return rows_entry(tab, idx, out, n, row_bytes, rows_per_thread, stream);
}

// A3: out (n, L) from tab with idx (n, L) int32; elem_bytes 2 or 4; mode 0:
// tab (TH, L), out[i,l] = tab[idx[i,l], l] (use_smem stages the table in
// shared memory); mode 1: tab (n, L), rows in groups of G; mode 2: tab (n,
// L), out[i,l] = tab[i, idx[i,l]].
extern "C" int probe_lane_gather(const void* tab, const void* idx, void* out,
                                 int n, int L, int TH, int elem_bytes,
                                 int mode, int G, int use_smem,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || L <= 0 || mode < 0 || mode > 2 || (mode == 1 && G <= 0))
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch_lanes<uint32_t>(tab, idx, out, n, L, TH, mode, G, use_smem,
                                  st);
  if (elem_bytes == 2)
    return launch_lanes<uint16_t>(tab, idx, out, n, L, TH, mode, G, use_smem,
                                  st);
  return (int)cudaErrorInvalidValue;
}

// A4: out (n_blocks,) f32, block b the sum of bf16 rows idx[b*R .. b*R+R-1]
// of tab (rows, row_bytes); row_bytes a multiple of 16. staged: Q in
// {2, 4, 8, 16} rows in flight through shared memory by cp.async; else
// direct loads.
extern "C" int probe_ring_gather(const void* tab, const void* idx, void* out,
                                 int n_blocks, int R, int Q, int row_bytes,
                                 int staged, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks <= 0 || R <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  if (!staged) {
    direct_reduce_kernel<<<n_blocks, kRingThreads, 0, st>>>(
        (const uint4*)tab, (const int32_t*)idx, (float*)out, R, chunks);
    return (int)cudaGetLastError();
  }
  switch (Q) {
    case 2: return launch_ring<2>(tab, idx, out, n_blocks, R, chunks, st);
    case 4: return launch_ring<4>(tab, idx, out, n_blocks, R, chunks, st);
    case 8: return launch_ring<8>(tab, idx, out, n_blocks, R, chunks, st);
    case 16: return launch_ring<16>(tab, idx, out, n_blocks, R, chunks, st);
  }
  return (int)cudaErrorInvalidValue;
}

// A5: out (NB, C, R) = x (NB, R, C) transposed, float32.
extern "C" int probe_transpose(const void* x, void* out, int NB, int R, int C,
                               void* stream) {
  if (NB <= 0 || R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)R * (C + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  transpose_kernel<<<grid_for(NB, 1, sm_count() * 8), kThreads, smem,
                     (cudaStream_t)stream>>>((const float*)x, (float*)out,
                                             NB, R, C);
  return (int)cudaGetLastError();
}
