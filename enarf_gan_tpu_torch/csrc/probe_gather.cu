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
// A1 row gather: out[i, :] = tab[idx[i], :]. Bound by bytes: the rows read
//   once from a random place in the table, the indices, the output written
//   once. The first design (one unit a thread an iteration of a grid-stride
//   loop over 16 blocks an SM, a 64-bit division and an index load a unit)
//   took 48.3 us at 2 and 4 KB rows against index_select's 46.7 / 46.9 on
//   an H100 SXM at 700 W (PERF.md §6, A1). row_units_kernel reads the
//   output as a run of units (16 bytes, or 8 or 4 where the row width or a
//   pointer allows no wider) and gives each thread 16 bytes of it (one
//   unit, two or four), with 32-bit indices and no loop, every load before
//   the first store: warp w takes the 32 k units from 32 k w, lane l those
//   at l + 32 j (j < k), so that each load and store instruction of a warp
//   covers 512 contiguous bytes of the output and whole sectors of the
//   rows. A unit's row is its index over the units a row, by a
//   multiply-shift division. A random row of 128 bytes and more is read past L1
//   (ld.global.nc.L1::no_allocate) and the output, which nothing reads
//   again, leaves by streaming stores (st.global.cs); narrower rows and
//   the launch-bound sizes, which these hints slowed (8 B rows 281.5 us
//   with them, 262.1 without), take __ldg and plain stores. More bytes in
//   flight a thread (2 to 8 units, or 4 to 8 whole rows under 16 bytes by
//   one 16-byte index load and 16-byte stores) measured slower at every
//   width (PERF.md §6, A1), as did whole rows by TMA bulk copies through
//   shared memory (2 and 4 KB: 48.2 / 48.9 us); tools/gather.py::row_plan
//   chooses the unit, the hints and the grid.
// A2 warp-serial loop: out[i, :] = tab[idx[i], :] again, each warp walking k
//   rows in turn (the counterpart of kern_dslice's loop of dynamic slices,
//   which the TPU ran as one program: k = 1024 is one loop for all rows).
//   The TPU moved a (1, 128) row in one vector operation; here the unit of
//   the loop is a warp, whose lanes cover the row's 16-byte units (a 512-byte
//   f32 row: one copy a lane), where one thread copying the rows unit by
//   unit would run 32,768 dependent loads for 1,024 rows. What bounds
//   one warp is the rate at which its loads arrive, not their latency: on an
//   NVIDIA H100 80GB HBM3 at 700 W its loads of 1,024 rows of 512 B from L2
//   take 39-45 us whether a row is 1, 2 or 4 load instructions and whether 1
//   or 7 groups of 8 rows are in flight, while one row's load takes 166 ns;
//   its own stores of the rows take 10 us more on the same path, and 4 warps
//   of one SM go 3.3 times as fast (tools/warp_rows.py; PERF.md §6).
//   So the warp copies the rows by cp.async, 16 bytes a lane, into a ring of
//   shared memory with two groups of 32 loads in flight, and the rows leave
//   by TMA bulk stores, which the warp only issues.
// A3 per-lane gather: out[i, l] = tab[idx[i, l], l] over a (TH, L) table; also
//   the sublane-in-tile form out[i, l] = tab[(i / G) * G + idx[i, l], l] and
//   the lane form out[i, l] = tab[i, idx[i, l]]. Bound by the bytes of the
//   index and output streams (6 or 8 bytes an element against 2 or 4 of
//   output) and, for a table above L1, by the sector traffic of its random 2-
//   or 4-byte reads. Each thread takes a vector of 4 consecutive lanes of a
//   row: one 16-byte index load, 4 table reads, one 8- or 16-byte store; a
//   warp covers a 128-lane row, rows and lane vectors are the two dimensions
//   of the block and grid (no division an element), and every thread keeps
//   kLaneRows rows in flight: 64 KB and more of index loads outstanding an SM,
//   where HBM's latency at 3.35 TB/s needs about 20 KB. The table is read
//   either through L1 (ld.global.nc) or, for a table that fits on chip, from
//   shared memory: a block of 1024 threads stages the columns of the lanes it
//   covers (the whole table when its lanes are all of them and it fits in 227
//   KB), with the 4 lanes of a thread TX apart in each row (32 for a 128-lane
//   row), so that a warp's float32 reads fall on 32 distinct banks (bf16: 2
//   threads a bank). Ragged L (not a multiple of 4, or unaligned pointers)
//   takes scalar loads and stores; ragged n is masked. A launch-bound size
//   through L1 (fewer 4-lane vectors than kOneLaneBelow an SM) takes one lane
//   and one row a thread, so that more warps issue its reads at once and no
//   thread runs a loop of rows it does not have (4 rows a thread left row 7
//   of PERF.md §6 slower than the parent's one element a thread).
// A4 staged ring gather: R rows a block, Q rows in flight through a ring of
//   shared-memory slots filled by cp.async (16 bytes a thread), each block
//   reducing its rows to one float32 sum, as dma_kernel reduced its buffer;
//   and the same reduction with direct loads and no staging, to say
//   whether staging pays.
// A5 transpose: a batch of NB (R, C) float32 matrices written out as (C,
//   R). Bound by bytes, read once and written once: at the probe shapes,
//   2,304 matrices of (64, 16) (relay_kernel) or (16, 128) (swapT), 9.4 or
//   18.9 MB each way, 5.6 or 11.3 us at 3.35 TB/s. The first design (one
//   4-byte element a thread an iteration, two runtime divisions an element,
//   a padded shared-memory tile a matrix behind two __syncthreads, the next
//   matrix loaded only after the last one was written, and a grid of 1,056
//   blocks that took 2.18 matrices each, so that a third round ran on 192
//   blocks) took 8.73-9.02 / 15.63-16.33 us a call against 8.07-8.27 /
//   16.89-17.04 us for transpose().contiguous() on an H100 SXM at 700 W.
//   At the two probe shapes transpose4_kernel, templated on (R, C) so that
//   every index is shifts and masks, gives each thread 4 x 4 blocks: four
//   16-byte loads of 4 rows, the transposition in registers (no shared
//   memory, no barrier), four 16-byte stores of 4 columns. A warp's 32
//   blocks are laid out so that each of its loads and stores covers whole
//   32-byte sectors (8 (C = 16) or 4 (C = 128) runs of 64 or 128 bytes), and
//   a warp takes two such groups, all 8 loads of a thread issued before its
//   first store, so that a launch's loads are all in flight at once: 288 /
//   576 blocks of 256 threads, one wave of the card at 48 registers a
//   thread (5 blocks an SM). Every other shape takes transpose_kernel, with
//   runtime R and C: each matrix staged in a padded tile (pitch C + 1, so
//   the column reads fall on distinct banks). The caller chooses the kernel
//   and its grid (tools/gather.py::transpose_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "fast_div.cuh"

namespace {

constexpr int kThreads = 256;

int sm_count() {
  static int n = 0;                    // read once: a launch is host-bound
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// the most dynamic shared memory a block may ask for, read once
int max_smem() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return n;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of B = 4, 8 or 16 bytes (16: L2 only, .cg; else .ca). The
// "memory" clobbers keep shared-memory reads of a slot after its wait.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- A1, A2

// 16-, 8- and 4-byte loads that leave no line in L1 (a table row is read
// once), and streaming stores (the output is not read again)
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_stream(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_stream(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\n" : "=r"(v)
               : "l"(p));
  return v;
}

// total (n units) below 2^31; `units` the units a row. A thread takes 16
// bytes: kK units of V. kStream: the loads past L1 and the streaming
// stores, else __ldg and plain stores.
template <typename V, bool kStream>
__global__ void __launch_bounds__(kThreads)
row_units_kernel(const V* __restrict__ tab, const int32_t* __restrict__ idx,
                 V* __restrict__ out, uint32_t total, FastDiv units) {
  constexpr int kK = 16 / sizeof(V);
  const uint32_t upr = units.d;
  const uint32_t e0 = (blockIdx.x * kThreads + (threadIdx.x & ~31u)) * kK +
                      (threadIdx.x & 31);
  uint32_t row[kK];
  int32_t at[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {              // every index first
    const uint32_t e = e0 + 32 * j;
    row[j] = units.div(e);
    at[j] = e < total ? __ldg(idx + row[j]) : 0;
  }
  V v[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {              // then every row load
    const uint32_t e = e0 + 32 * j;
    if (e < total) {
      const V* src = tab + (int64_t)at[j] * upr + (e - row[j] * upr);
      v[j] = kStream ? ld_stream(src) : __ldg(src);
    }
  }
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    if (e0 + 32 * j >= total) continue;
    if (kStream) __stcs(out + e0 + 32 * j, v[j]);
    else out[e0 + 32 * j] = v[j];
  }
}

constexpr int kRowGroup = 32;     // A2: units a lane copies a group
constexpr int kRowStages = 4;     // A2: groups in the ring (see warp_rows)
constexpr int kIdxChunk = 1024;   // A2: indices staged at once

// A2's shared memory for k rows a warp: the indices staged at once (k up to
// kIdxChunk, in 128-byte lines), then the ring, of no more groups than
// those rows fill (slot g % kRowStages is then slot g)
__host__ __device__ inline int row_idx_bytes(int k) {
  return ((k < kIdxChunk ? k : kIdxChunk) * 4 + 127) / 128 * 128;
}

template <typename V>
int row_warp_smem(int k, int units) {
  const int rows = k < kIdxChunk ? k : kIdxChunk;
  const int groups = (rows * units + 32 * kRowGroup - 1) / (32 * kRowGroup);
  return row_idx_bytes(k) +
         (groups < kRowStages ? groups : kRowStages) * kRowGroup * 32 *
             (int)sizeof(V);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA bulk store of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, one bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// One warp a block. The warp's rows are one run of rows * units units
// (unit e is unit e % units of row e / units), which streams through a
// ring of kRowStages groups of 32 kRowGroup consecutive units in shared
// memory: lane l copies units l, l + 32, ... of a group by cp.async, one
// commit group a group, kRowStages - 2 groups ahead of the one it waits
// for. A group then leaves in one TMA bulk store issued by lane 0 (kBulk:
// every group starts and ends on 16 bytes), else by each lane's stores of
// the units it copied (rows whose run ends off 16 bytes). The bulk stores
// keep the rows off the path by which the warp's loads arrive (see A2
// above). The ring's fourth slot is the one a bulk store is still reading.
template <typename V, bool kBulk>
__device__ __forceinline__ void warp_rows(const V* __restrict__ tab,
                                          const int* sidx, V* ring,
                                          V* __restrict__ dst, int rows,
                                          int units, int lane) {
  constexpr int U = kRowGroup, S = kRowStages, GU = 32 * U;
  const int total = rows * units;
  const int groups = (total + GU - 1) / GU;
  // the lane's next unit to copy as (row, col), stepped by 32 units
  const int q = 32 / units, rem = 32 % units;
  int row = lane / units, col = lane % units;
  auto issue = [&](int g) {                  // group g into its slot
    if (g < groups) {
      V* slot = ring + (g % S) * GU + lane;
      const int e0 = g * GU + lane;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (e0 + u * 32 < total)
          cp_async<sizeof(V)>(slot + u * 32,
                              tab + (int64_t)sidx[row] * units + col);
        row += q;
        col += rem;
        if (col >= units) {
          col -= units;
          ++row;
        }
      }
    }
    cp_async_commit();                       // empty past the end
  };
#pragma unroll
  for (int g = 0; g < S - 2; ++g) issue(g);
  for (int g = 0; g < groups; ++g) {
    if (kBulk) {                             // group g - 2 has left its slot
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
    }
    issue(g + S - 2);
    cp_async_wait<S - 2>();                  // group g has landed
    const int e0 = g * GU;
    const V* slot = ring + (g % S) * GU;
    if (kBulk) {
      fence_proxy_async();                   // the copies, seen by the TMA
      __syncwarp();
      if (lane == 0)
        bulk_store(dst + e0, slot, min(GU, total - e0) * (int)sizeof(V));
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * 32 + lane;
        if (e < total) dst[e] = slot[u * 32 + lane];
      }
    }
  }
  if (kBulk && lane == 0) bulk_wait_read<0>();   // the ring is free again
  cp_async_wait<0>();
}

template <typename V, bool kBulk>
__global__ void __launch_bounds__(32)
row_warp_kernel(const V* __restrict__ tab, const int32_t* __restrict__ idx,
                V* __restrict__ out, int n, int units, int k) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int* sidx = reinterpret_cast<int*>(smem_raw);
  V* ring = reinterpret_cast<V*>(smem_raw + row_idx_bytes(k));
  const int lane = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * k;
  const int rows = (int)min((int64_t)k, (int64_t)n - r0);
  for (int c0 = 0; c0 < rows; c0 += kIdxChunk) {
    const int cr = min(kIdxChunk, rows - c0);
    for (int r = lane; r < cr; r += 32) sidx[r] = __ldg(idx + r0 + c0 + r);
    __syncwarp();
    warp_rows<V, kBulk>(tab, sidx, ring, out + (r0 + c0) * units, cr, units,
                        lane);
    __syncwarp();                              // sidx is read by all lanes
  }
}

// the largest dynamic shared memory for `kern`, asked for once
template <typename K>
int opt_in_smem(K kern, bool& done) {
  if (done) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem());
  done = err == 0;
  return err;
}

int launch_serial(const void* tab, const void* idx, void* out, int n,
                  int row_bytes, int rows_per_warp, cudaStream_t st) {
  // bulk stores when every warp's rows and chunks start on 16 bytes
  const bool bulk = (int64_t)rows_per_warp * row_bytes % 16 == 0 &&
                    (int64_t)n * row_bytes % 16 == 0;
  auto go = [&](auto vec) {
    using V = decltype(vec);
    const int units = row_bytes / (int)sizeof(V);
    static bool opted[2] = {false, false};
    auto* kern = bulk ? row_warp_kernel<V, true> : row_warp_kernel<V, false>;
    const int err = opt_in_smem(kern, opted[bulk]);
    if (err) return err;
    kern<<<(n + rows_per_warp - 1) / rows_per_warp, 32,
           row_warp_smem<V>(rows_per_warp, units), st>>>(
        (const V*)tab, (const int32_t*)idx, (V*)out, n, units, rows_per_warp);
    return (int)cudaGetLastError();
  };
  if (row_bytes % 16 == 0) return go(uint4{});
  if (row_bytes % 8 == 0) return go(uint2{});
  return go(uint32_t{});
}

template <typename V>
int launch_units(const void* tab, const void* idx, void* out, uint32_t total,
                 int units, bool stream, int blocks, cudaStream_t st) {
  auto* kern = stream ? row_units_kernel<V, true> : row_units_kernel<V, false>;
  kern<<<blocks, kThreads, 0, st>>>((const V*)tab, (const int32_t*)idx,
                                    (V*)out, total, FastDiv((uint32_t)units));
  return (int)cudaGetLastError();
}

// A1 on the plan of tools/gather.py::row_plan; refuses a plan whose grid
// does not cover the rows or whose unit the pointers do not allow
int rows_entry(const void* tab, const void* idx, void* out, int n,
               int row_bytes, int unit, bool stream, int blocks,
               cudaStream_t st) {
  if (n <= 0 || row_bytes <= 0 || blocks <= 0 ||
      (unit != 4 && unit != 8 && unit != 16) || row_bytes % unit)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)tab | (uintptr_t)out) % unit)
    return (int)cudaErrorMisalignedAddress;
  const int units = row_bytes / unit;
  const int64_t total = (int64_t)n * units;
  if (total >= (1LL << 31) || (int64_t)blocks * kThreads * (16 / unit) < total)
    return (int)cudaErrorInvalidValue;
  if (unit == 16)
    return launch_units<uint4>(tab, idx, out, (uint32_t)total, units,
                               stream, blocks, st);
  if (unit == 8)
    return launch_units<uint2>(tab, idx, out, (uint32_t)total, units,
                               stream, blocks, st);
  return launch_units<uint32_t>(tab, idx, out, (uint32_t)total, units, stream,
                                blocks, st);
}

// -------------------------------------------------------------------- A3

constexpr int kLaneRows = 4;          // rows in flight, 4 lanes a thread
constexpr int kLaneThreads = 256;     // a block reading the table through L1
constexpr int kStageThreads = 1024;   // a block staging it in shared memory
// through L1, fewer 4-lane vectors than this many an SM take one lane a
// thread (launch-bound sizes: more warps issue their reads at once)
constexpr int kOneLaneBelow = 256;

template <typename T> struct Vec4;                  // 4 elements of T
template <> struct Vec4<uint32_t> { using type = uint4; };
template <> struct Vec4<uint16_t> { using type = uint2; };

// mode 0: tab (TH, L), out[i, l] = tab[idx[i, l], l]; 1: tab (n, L), rows in
// groups of G; 2: tab (n, L), out[i, l] = tab[i, idx[i, l]]. kW lanes a
// thread (4, or 1 for a launch-bound size). kVec (kW 4): L % 4 == 0 and
// 16-byte aligned pointers. kStage (mode 0, kW 4): the block's columns of
// the table in shared memory, element (j, 4 x + e) of the block's lanes at
// s[j * 4 TX + e * TX + x].
template <typename T, int kMode, bool kVec, bool kStage, int kW>
__global__ void __launch_bounds__(kStage ? kStageThreads : kLaneThreads)
lane_gather_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int n, int L, int TH, int G) {
  static_assert(kW == 4 || (kW == 1 && !kVec && !kStage), "lanes a thread");
  constexpr int R = kW == 4 ? kLaneRows : 1;  // rows a thread has in flight
  using V = typename Vec4<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int x = threadIdx.x, TX = blockDim.x;
  const int l0 = kW * (blockIdx.x * TX + x);  // this thread's first lane
  const T* src = tab + l0;                    // element (j, l0 + e) at
  int pitch = L, step = 1;                    //   src[j * pitch + e * step]
  if (kStage) {
    T* s = reinterpret_cast<T*>(smem_raw);
    const int W = 4 * TX;
    for (int j = threadIdx.y; j < TH; j += blockDim.y) {
      T w[4];
      if (kVec && l0 < L) {
        const V q = __ldg(reinterpret_cast<const V*>(tab + (int64_t)j * L + l0));
        memcpy(w, &q, sizeof(q));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = l0 + e < L ? __ldg(tab + (int64_t)j * L + l0 + e) : T(0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j * W + e * TX + x] = w[e];
    }
    __syncthreads();
    src = s + x;
    pitch = W;
    step = TX;
  }
  if (l0 >= L) return;
  const int64_t stride = (int64_t)gridDim.y * blockDim.y;
  for (int64_t i0 = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; i0 < n;
       i0 += stride * R) {
    int q[R][kW];
#pragma unroll
    for (int u = 0; u < R; ++u) {            // every row's indices first
      const int64_t i = i0 + u * stride;
      if (i >= n) continue;
      const int32_t* p = idx + i * L + l0;
      if (kVec) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        q[u][0] = v.x; q[u][1] = v.y; q[u][2] = v.z; q[u][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < kW; ++e) q[u][e] = l0 + e < L ? __ldg(p + e) : 0;
      }
    }
    T r[R][kW];
#pragma unroll
    for (int u = 0; u < R; ++u) {            // then every table read
      const int64_t i = i0 + u * stride;
      if (i >= n) continue;
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (!kVec && l0 + e >= L) continue;
        int off;
        if (kMode == 0)
          off = q[u][e] * pitch + e * step;
        else if (kMode == 1)
          off = ((int)(i / G) * G + q[u][e]) * L + e;
        else
          off = (int)i * L + q[u][e] - l0;
        r[u][e] = kStage ? src[off] : __ldg(src + off);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int64_t i = i0 + u * stride;
      if (i >= n) continue;
      T* o = out + i * L + l0;
      if (kVec) {
        V v;
        memcpy(&v, r[u], sizeof(v));
        *reinterpret_cast<V*>(o) = v;
      } else {
#pragma unroll
        for (int e = 0; e < kW; ++e)
          if (l0 + e < L) o[e] = r[u][e];
      }
    }
  }
}

// The lane vectors (of kW lanes) a block covers: the whole row up to 32.
int lane_tx(int L, int kW = 4) {
  const int vl = (L + kW - 1) / kW;
  int tx = 1;
  while (tx < vl && tx < 32) tx *= 2;
  return tx;
}

// stage_blocks: the staging blocks the card holds at once (the wrapper's
// reading of the card's shared memory, gather.py::_stage)
template <typename T, int kMode, bool kVec, bool kStage, int kW = 4>
int launch_lanes(const T* tab, const int32_t* idx, T* out, int n, int L,
                 int TH, int G, int tx, int stage_blocks, cudaStream_t st) {
  const int gx = (L + kW * tx - 1) / (kW * tx);
  int ty = (kStage ? kStageThreads : kLaneThreads) / tx;
  // through L1, a small n takes fewer rows a block (down to a warp), so
  // that its blocks still cover the SMs
  while (!kStage && ty > 1 && tx * (ty / 2) >= 32 &&
         ((int64_t)n + ty - 1) / ty * gx < sm_count())
    ty /= 2;
  const dim3 block(tx, ty);
  size_t smem = 0;
  int resident = sm_count() * (2048 / (tx * ty));
  if (kStage) {
    smem = (size_t)TH * 4 * tx * sizeof(T);
    static bool opted = false;               // once an instantiation
    const int err = opt_in_smem(
        lane_gather_kernel<T, kMode, kVec, kStage, kW>, opted);
    if (err) return err;
    resident = stage_blocks;
  }
  // a row a thread-row when that fills no more than the card (a small n
  // spreads over more SMs), else the card full, each thread a loop of rows
  const int64_t rows_needed = ((int64_t)n + block.y - 1) / block.y;
  const int cap = (resident + gx - 1) / gx;
  const int gy = (int)(rows_needed < cap ? rows_needed : cap);
  lane_gather_kernel<T, kMode, kVec, kStage, kW>
      <<<dim3(gx, gy < 1 ? 1 : gy), block, smem, st>>>(tab, idx, out, n, L,
                                                       TH, G);
  return (int)cudaGetLastError();
}

template <typename T>
int lanes_entry(const void* tab_, const void* idx_, void* out_, int n, int L,
                int TH, int mode, int G, int stage_tx, int stage_blocks,
                cudaStream_t st) {
  const T* tab = (const T*)tab_;
  const int32_t* idx = (const int32_t*)idx_;
  T* out = (T*)out_;
  const bool vec = L % 4 == 0 && ((uintptr_t)tab_ % 16 | (uintptr_t)idx_ % 16 |
                                  (uintptr_t)out_ % 16) == 0;
  if (stage_tx > 0) {
    if (mode != 0 || stage_tx > lane_tx(L) || (stage_tx & (stage_tx - 1)) ||
        stage_blocks <= 0 ||
        (size_t)TH * 4 * stage_tx * sizeof(T) > (size_t)max_smem())
      return (int)cudaErrorInvalidValue;
    return vec ? launch_lanes<T, 0, true, true>(tab, idx, out, n, L, TH, G,
                                                stage_tx, stage_blocks, st)
               : launch_lanes<T, 0, false, true>(tab, idx, out, n, L, TH, G,
                                                 stage_tx, stage_blocks, st);
  }
  const bool one = (int64_t)n * ((L + 3) / 4) <
                   (int64_t)sm_count() * kOneLaneBelow;
  const int tx = lane_tx(L, one ? 1 : 4);
#define LANES_MODE(M)                                                       \
  return one ? launch_lanes<T, M, false, false, 1>(tab, idx, out, n, L, TH, \
                                                   G, tx, 0, st)            \
       : vec ? launch_lanes<T, M, true, false>(tab, idx, out, n, L, TH, G,  \
                                               tx, 0, st)                   \
             : launch_lanes<T, M, false, false>(tab, idx, out, n, L, TH, G, \
                                                tx, 0, st)
  if (mode == 0) LANES_MODE(0);
  if (mode == 1) LANES_MODE(1);
  LANES_MODE(2);
#undef LANES_MODE
}

// -------------------------------------------------------------------- A4

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
      cp_async<16>(dst + k, src + k);
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
  if (smem > (size_t)max_smem()) return (int)cudaErrorInvalidValue;
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

constexpr int kT4Threads = 256;
constexpr int kT4Groups = 2;        // 32-block groups a warp

// x (NB, kR, kC) -> out (NB, kC, kR), float4 units. A 4 x 4 block v of a
// matrix: rows 4 g .. 4 g + 3, columns 4 q .. 4 q + 3; within a matrix
// the blocks run q_lo (QL of them, a warp's 16-byte columns of a row),
// then g, then q_hi, so that 32 consecutive blocks read QL x 16 bytes of
// each of 32 / QL rows and write 4 g-runs of (32 / QL) x 16 bytes.
template <int kR, int kC>
__global__ void __launch_bounds__(kT4Threads, 5)
transpose4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                  int64_t groups) {
  constexpr int QL = kC / 4 < 8 ? kC / 4 : 8;
  constexpr int GR = kR / 4;
  constexpr int BPM = GR * (kC / 4);        // blocks a matrix
  constexpr int VPM = kR * kC / 4;          // float4s a matrix
  static_assert(kR % 4 == 0 && kC % 4 == 0 && (QL * GR) % 32 == 0, "shape");
  const int lane = threadIdx.x & 31;
  const int64_t g0 = ((int64_t)blockIdx.x * (kT4Threads / 32) +
                      (threadIdx.x >> 5)) * kT4Groups;
  // block p of this thread: matrix m, 4-row group g, 16-byte column q
  auto at = [&](int p, int64_t& m, int& g, int& q) {
    const int64_t u = (g0 + p) * 32 + lane;
    m = u / BPM;
    const int w = (int)(u % BPM);
    g = (w / QL) % GR;
    q = (w / (QL * GR)) * QL + w % QL;
  };
  float4 v[kT4Groups][4];
#pragma unroll
  for (int p = 0; p < kT4Groups; ++p) {
    if (g0 + p >= groups) break;
    int64_t m;
    int g, q;
    at(p, m, g, q);
    const float4* src = x + m * VPM + 4 * g * (kC / 4) + q;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[p][j] = __ldg(src + j * (kC / 4));
  }
#pragma unroll
  for (int p = 0; p < kT4Groups; ++p) {
    if (g0 + p >= groups) break;
    int64_t m;
    int g, q;
    at(p, m, g, q);
    float4* o = out + m * VPM + 4 * q * (kR / 4) + g;
    o[0] = make_float4(v[p][0].x, v[p][1].x, v[p][2].x, v[p][3].x);
    o[kR / 4] = make_float4(v[p][0].y, v[p][1].y, v[p][2].y, v[p][3].y);
    o[2 * (kR / 4)] = make_float4(v[p][0].z, v[p][1].z, v[p][2].z, v[p][3].z);
    o[3 * (kR / 4)] = make_float4(v[p][0].w, v[p][1].w, v[p][2].w, v[p][3].w);
  }
}

// `blocks` must cover the groups: a block takes (kT4Threads / 32) x
// kT4Groups of them, and blocks past the last find none
template <int kR, int kC>
int launch_transpose4(const void* x, void* out, int NB, int blocks,
                      cudaStream_t st) {
  const int64_t groups = (int64_t)NB * (kR * kC / 16) / 32;
  if ((int64_t)blocks * (kT4Threads / 32) * kT4Groups < groups)
    return (int)cudaErrorInvalidValue;
  transpose4_kernel<kR, kC><<<blocks, kT4Threads, 0, st>>>(
      (const float4*)x, (float4*)out, groups);
  return (int)cudaGetLastError();
}

// every other shape: a block a matrix at a time through a padded tile
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

// A1: out (n, row_bytes) = tab (rows, row_bytes)[idx (n,) int32]; row_bytes
// a multiple of `unit` (16, 8 or 4, which the table and output pointers
// lie on), the n row_bytes / unit units of the output below 2^31. The plan
// (tools/gather.py::row_plan): 16 bytes a thread in `blocks` blocks of
// 256, with the streaming hints (`streaming` nonzero) or without.
extern "C" int probe_row_gather(const void* tab, const void* idx, void* out,
                                int n, int row_bytes, int unit, int streaming,
                                int blocks, void* stream) {
  return rows_entry(tab, idx, out, n, row_bytes, unit, streaming != 0, blocks,
                    (cudaStream_t)stream);
}

// A2: the same function, one warp walking rows_per_warp rows in turn.
extern "C" int probe_row_serial(const void* tab, const void* idx, void* out,
                                int n, int row_bytes, int rows_per_warp,
                                void* stream) {
  if (n <= 0 || row_bytes <= 0 || row_bytes % 4 || rows_per_warp <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_serial(tab, idx, out, n, row_bytes, rows_per_warp,
                       (cudaStream_t)stream);
}

// A3: out (n, L) from tab with idx (n, L) int32; elem_bytes 2 or 4; mode 0:
// tab (TH, L), out[i,l] = tab[idx[i,l], l]; mode 1: tab (n, L), rows in
// groups of G; mode 2: tab (n, L), out[i,l] = tab[i, idx[i,l]]. stage_tx >
// 0 (mode 0 only) stages the table's columns in shared memory, stage_tx
// lane vectors (4 stage_tx lanes) a block, a power of two up to the row's,
// stage_blocks of them resident on the card at once; 0 reads the table
// through L1.
extern "C" int probe_lane_gather(const void* tab, const void* idx, void* out,
                                 int n, int L, int TH, int elem_bytes,
                                 int mode, int G, int stage_tx,
                                 int stage_blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || L <= 0 || TH <= 0 || mode < 0 || mode > 2 ||
      (mode == 1 && G <= 0))
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return lanes_entry<uint32_t>(tab, idx, out, n, L, TH, mode, G, stage_tx,
                                 stage_blocks, st);
  if (elem_bytes == 2)
    return lanes_entry<uint16_t>(tab, idx, out, n, L, TH, mode, G, stage_tx,
                                 stage_blocks, st);
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

// A5: out (NB, C, R) = x (NB, R, C) transposed, float32, in `blocks`
// blocks of the kernel the caller chose (tools/gather.py::transpose_plan):
// 1, transpose4_kernel, at (R, C) = (64, 16) and (16, 128) with both
// pointers on 16 bytes; 0, transpose_kernel, at any shape whose padded
// tile fits 48 KB.
extern "C" int probe_transpose(const void* x, void* out, int NB, int R, int C,
                               int kernel, int blocks, void* stream) {
  if (NB <= 0 || R <= 0 || C <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kernel == 1) {
    if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
        15)
      return (int)cudaErrorMisalignedAddress;
    if (R == 64 && C == 16)
      return launch_transpose4<64, 16>(x, out, NB, blocks, st);
    if (R == 16 && C == 128)
      return launch_transpose4<16, 128>(x, out, NB, blocks, st);
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)R * (C + 1) * sizeof(float);
  if (kernel != 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  transpose_kernel<<<blocks, kThreads, smem, st>>>((const float*)x,
                                                   (float*)out, NB, R, C);
  return (int)cudaGetLastError();
}
