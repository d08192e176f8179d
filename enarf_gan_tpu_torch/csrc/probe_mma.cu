// Row gathers and tensor-core products for Hopper (sm_90a): family B of the
// probes (Python side enarf_gan_tpu_torch/tools/mma.py).
//
// Replaces the TPU probe kernels
//   tools/bench_pallas_prims.py:73 onehot_gather_kernel      (B1)
//   tools/bench_dyngather2.py:115 kernel, :144 kernel2       (B2)
//   tools/bench_pallas_prims.py:105 matmul_chain_kernel      (B3)
//   tools/bisect_hat_kernel.py bdiag_dot, tools/bisect_kernel_ops.py
//   dot_kshape, tools/probe_mosaic_caps.py dot_batched       (B3)
// The TPU gathered rows by multiplying a one-hot matrix into a window of the
// table on its matrix unit, because it could not address single rows. This
// card can, so B1 and B2 read each sample's rows straight from the table;
// only B3 is a product. N is 128 throughout (the lanes of a TPU row).
//
// B1 one-hot windowed gather: per sample two rows loc and weights w;
//   out[s, :] = w0' tab[base + j0, :] + w1' tab[base + j1, :] in float32,
//   j = loc - base, base 0 (a static window: the whole (WIN, 128) bf16
//   table) or, for a dynamic window, the first row of the sample's group of
//   G, capped at n_rows - WIN and rounded down to 512; w' the weights as the
//   TPU's one-hot row holds them: summed where j0 = j1, rounded to bf16, 0
//   for a row outside [0, WIN). Any G that divides S, any WIN <= n_rows.
// B2 sorted-tile gather: out[s, :] = tab[tile[s / 512] * 512 + loc[s], :]
//   in float32 (the one-hot product of one row, weight 1).
// Both are bound by bytes: loc and w, each row once, the float32 output
//   (S x 512 bytes: 604 of B1's 623 MB at S = 1,179,648, 0.186 ms at 3.35
//   TB/s; B2's 2.15 GB and its 50.3 MB table, 0.661 ms). The one-hot
//   formulation's S x WIN x 128 x 2 operations (0.16-0.47 ms on the tensor
//   cores) are the TPU formulation's cost, not the function's. The first
//   design ran that formulation on mma.sync: a block of 64 samples streamed
//   the whole window through shared memory and multiplied every k-tile
//   (3.6 GB from L2 at (512, 768), 1.01-1.53 ms), and B2 a 128 KB tile a
//   block (8.6 GB, 2.28 ms). pair_rows_kernel, one kernel for both (a
//   template of the mode), gives a warp two samples and a half-warp each,
//   a thread 8 columns from 16 bytes of each of its rows, no loop: the
//   group by FastDiv's multiply-shift, the sample's pair of rows and of
//   weights by two 8-byte loads, the table's loads under an L2 evict-last
//   policy, and the output by streaming stores (st.global.cs), so that the
//   output's stream pushes as little of a dynamic window's 50.3 MB table
//   out of the 50 MB L2 as it can. Shuffles then exchange the halves so
//   that lane l stores unit l of each sample: each store instruction
//   writes one sample's whole 512 bytes. On an NVIDIA H100 80GB HBM3 at
//   700 W (PERF.md section 6, B1 and B2): 8 bytes of each row a thread
//   (a warp a sample) tied this at static windows and lost 7-12% at
//   dynamic ones and B2; 16-byte row loads stored straight from the lane
//   that loaded them (32 bytes a lane, so each store instruction fills
//   half of every sector it touches) lost 18-28% at static windows; a
//   static window staged in shared memory by persistent blocks lost
//   20-23%; the sample's loads by its first lane, shuffled, lost 0.5-2%.
//   Static windows reach 85% of the bytes bound. A dynamic window and B2
//   reach 73-76%: their rows come from HBM about once a group (B2: a block),
//   because the table does not stay in L2 beside the output from one group
//   that reads a row to the next (tools/mma.py::group_floor_ms).
//
// gemm_small_kernel uses mma.sync.m16n8k16 bf16 with float32 sums, B
// fragments loaded by ldmatrix.x4.trans from row-major (k, 128) tiles
// staged in shared memory (rows padded so that ldmatrix's 8 rows fall on
// distinct banks), as kernel 3 does (tilewin_combine_modes.cu).
// B3 products: C (batch, M, 128) f32 = A (batch, M, K) bf16 @ B (K, 128)
//   bf16, B shared by the batch (the chain) or one a batch element. At the
//   chain shapes, (1024, 512, 768), (1024, 512, 256) and (256, 1024, 1024),
//   the function is bound by bytes: A in once (805 MB at the first) and C
//   out once (268 MB), 0.3206 / 0.1603 / 0.2004 ms at 3.35 TB/s, against
//   0.104 ms for the first one's 103 GFLOP at 989 TFLOP/s. The kernel has
//   to stream A in and C out at HBM's rate; the first design (the
//   mma.sync kernel, 16 rows a warp, cp.async 16 deep) held it at 42-46% of
//   that on an H100 SXM at 700 W, for three reasons, each answered by
//   gemm_tma_kernel:
//   1. every block of 64 rows staged all of B through shared memory: 1.61
//      GB of L2 reads of B at the first chain, twice A's bytes. Here a
//      tile is 256 rows, and B is loaded once a block and kept in shared
//      memory when it fits beside a ring of 4 stages (K <= 256: 64 KB),
//      else streamed with A, one 16 KB k-tile a stage: B's L2 reads are
//      then half of A's bytes (0.40 GB at the first chain; at the second,
//      resident, 132 x 64 KB).
//   2. A came 16 deep (one 32-byte sector a row) through a double buffer
//      of cp.async, about 2 KB in flight a block, behind a wait and two
//      __syncthreads a step; Little's law asks for ~18 KB in flight an SM
//      (3.35 TB/s x ~0.7 us / 132). Here one producer thread keeps TMA
//      loads of (256, 64) tiles (32 KB, 128-byte swizzle) in a ring of
//      4-8 stages with full and empty mbarriers: 128-256 KB of A in flight
//      an SM, one block an SM, persistent over the tiles, so that the
//      loads of the next tile run under this one's epilogue.
//   3. mma.sync m16n8k16 with ldmatrix.trans of B in every warp, at every
//      step. Here two consumer warpgroups issue wgmma.mma_async m64n128k16
//      straight from the swizzled tiles (A K-major, B N-major, through
//      shared-memory descriptors), keep one group in flight and release a
//      stage after wgmma.wait_group; C leaves through a 16 KB staging box
//      a warpgroup by TMA stores, 32 columns at a time.
//   Ragged edges: rows past M and k past K lie outside the tensor maps,
//   which fill loads with zeros and clip stores.
// B3 at the launch-bound shapes (a walk of at most 128 rows: bdiag_dot
//   (256, 32, 16), dot_kshape (128, 32, 16), dot_batched (16, 128, 64), B
//   one a batch element) goes to gemm_small_kernel; the caller chooses
//   (tools/mma.py::gemm_plan). What bounds them is the launch: at
//   dot_batched 0.26 + 0.26 MB in and 1.05 MB out take 0.47 us at 3.35
//   TB/s and its 33.6 MFLOP 0.03 us on the tensor cores, while an empty
//   launch costs 2.04-2.28 us of device time on an H100 SXM at 700 W; so
//   the kernel has to add as little as it can to that floor, and after it
//   the bytes count (bdiag_dot writes 4.2 MB). The first design added ~2.0
//   us at dot_batched (4.21 us a call against 3.30 for the float32-out
//   torch.bmm) for two reasons:
//   1. too few blocks: 4 warps x 16 rows a block, a grid of 32 blocks on
//      132 SMs. Here a block takes 32 rows of a batch element (16 where
//      that gives fewer than 128 blocks) and half the columns, and its 8
//      warps 16 rows x 16 columns each: 128 blocks at dot_batched, 256 and
//      512 at the other two. More warps a block is what counted most: the
//      same 32 x 64 block in 2 warps was 0.5 us slower at dot_batched.
//   2. a chain of K / 16 dependent round trips a block: A and B came 16
//      deep by cp.async, each step behind a wait and two __syncthreads.
//      Here every operand byte of the block is fetched at once (16 bytes a
//      thread by cp.async into padded pitches, one commit group, one wait
//      and one __syncthreads), then every k step runs from shared memory.
//   Trials that measured slower and were taken out: 1-D bulk copies (TMA)
//   on one mbarrier, a copy a row landing at the padded pitch (0.5-0.6 us
//   slower: 48-96 small copies a block) or two dense copies, A's rows and
//   all of B (0.2-1.1 us slower: B's rows 256 bytes apart put an 8-way
//   bank conflict on every ldmatrix.trans, and the block reads all 128
//   columns of B); C staged in shared memory and sent by bulk stores
//   (1.2-1.4 us slower than the lanes' float2 stores, a full 32-byte
//   sector a quad of lanes). wgmma is not used: it takes 64 rows at a
//   time and would cut dot_batched to 32 blocks. Measured on an NVIDIA
//   H100 80GB HBM3 at 700 W (PERF.md section 6).

#include <cuda.h>               // CUtensorMap (types only: no libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fast_div.cuh"

namespace {

constexpr int kN = 128;             // output columns

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

// 16 k-rows of B (row-major, `pitch` bf16 a shared row, NT x 8 columns
// from sB, NT even) times this warp's A fragment, into acc[NT][4]. The
// pitch is an odd number of 16-byte units, so that ldmatrix's 8 rows fall
// on distinct banks.
template <int NT>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4],
                                          const uint32_t (&a)[4],
                                          const __nv_bfloat16* sB, int pitch,
                                          int lane) {
  static_assert(NT % 2 == 0, "ldmatrix.x4 takes two 8-column tiles");
  const __nv_bfloat16* lrow =
      sB + (((lane >> 3) & 1) * 8 + (lane & 7)) * pitch + (lane >> 4) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, lrow + nt * 8);
    mma_acc(acc[nt], a, b[0], b[1]);
    mma_acc(acc[nt + 1], a, b[2], b[3]);
  }
}

// acc[.][0..1] to o0 (this lane's first column of an output row r0) and
// acc[.][2..3] to row r0 + 8 of a (rows, 128) output, NT x 8 columns
template <int NT>
__device__ __forceinline__ void store_tiles(float* o0,
                                            const float (&acc)[NT][4]) {
  float* o1 = o0 + 8 * kN;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(o0 + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(o1 + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------------------ B1 and B2

enum { kStatic = 0, kDynamic = 1, kTile = 2 };
constexpr int kRowThreads = 256;    // a block of pair_rows_kernel
constexpr int kTileRows = 512;      // B2: samples a block and rows a tile

// an L2 policy that keeps the lines it loads ahead of the streaming stores
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 16 bytes of a table row, read through L1 under the L2 policy `pol`
__device__ __forceinline__ uint4 ld_row(const __nv_bfloat16* p,
                                        uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(pol));
  return v;
}

// four bf16 (two words) as float32: the bits moved into the high half
__device__ __forceinline__ float4 bf16x4(uint32_t lo, uint32_t hi) {
  return make_float4(__uint_as_float(lo << 16),
                     __uint_as_float(lo & 0xffff0000u),
                     __uint_as_float(hi << 16),
                     __uint_as_float(hi & 0xffff0000u));
}

// w0 a + w1 b: both products are exact in float32 (bf16 times bf16), so
// the sum rounds once whether or not the compiler fuses it
__device__ __forceinline__ float4 pair_sum(float w0, float4 a, float w1,
                                           float4 b) {
  return make_float4(w0 * a.x + w1 * b.x, w0 * a.y + w1 * b.y,
                     w0 * a.z + w1 * b.z, w0 * a.w + w1 * b.w);
}

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, src),
                     __shfl_sync(0xffffffffu, v.y, src),
                     __shfl_sync(0xffffffffu, v.z, src),
                     __shfl_sync(0xffffffffu, v.w, src));
}

// A sample's rows of the table and their weights. B1: as the one-hot row
// of the TPU kernel has them: j = row - base, the weights summed where j0
// equals j1, rounded to bf16, and 0 for a row outside [0, WIN), whose j is
// then clamped into the window (a finite row times 0); base 0 (static) or
// the group's first row capped at n_rows - WIN and rounded down to a
// multiple of 512 (& ~511: a floor, also below 0). B2: the row of the
// block's tile, weight 1.
struct Pair {
  int64_t r0, r1;
  float w0, w1;
};

template <int kMode>
__device__ __forceinline__ Pair load_pair(const int32_t* __restrict__ loc,
                                          const float* __restrict__ w,
                                          const int32_t* __restrict__ tile,
                                          uint32_t s, FastDiv group, int WIN,
                                          int n_rows) {
  Pair p;
  if (kMode == kTile) {
    p.r0 = p.r1 = (int64_t)__ldg(tile + s / kTileRows) * kTileRows +
                  __ldg(loc + s);
    p.w0 = 1.f;
    p.w1 = 0.f;
    return p;
  }
  int base = 0;
  if (kMode == kDynamic)
    base = min(__ldg(loc + 2 * group.div(s) * group.d), n_rows - WIN) & ~511;
  const int2 l = __ldg(reinterpret_cast<const int2*>(loc) + s);
  const float2 ww = __ldg(reinterpret_cast<const float2*>(w) + s);
  int j0 = l.x - base, j1 = l.y - base;
  float w0 = ww.x, w1 = ww.y;
  if (j0 == j1) {
    w0 += w1;
    w1 = 0.f;
  }
  p.w0 = (unsigned)j0 < (unsigned)WIN
             ? __bfloat162float(__float2bfloat16_rn(w0)) : 0.f;
  p.w1 = (unsigned)j1 < (unsigned)WIN
             ? __bfloat162float(__float2bfloat16_rn(w1)) : 0.f;
  p.r0 = base + min(max(j0, 0), WIN - 1);
  p.r1 = base + min(max(j1, 0), WIN - 1);
  return p;
}

// B1 (kStatic, kDynamic) and B2 (kTile): out (S, 128) f32. A warp takes
// two samples, a half-warp each, and a thread 8 columns from 16 bytes of
// each of its sample's rows; the halves are then exchanged by shuffles so
// that lane l stores unit l (16 bytes) of each sample and every store
// instruction of the warp writes one sample's 512 bytes. No loop.
template <int kMode>
__global__ void __launch_bounds__(kRowThreads)
pair_rows_kernel(const int32_t* __restrict__ loc, const float* __restrict__ w,
                 const int32_t* __restrict__ tile,
                 const __nv_bfloat16* __restrict__ tab,
                 float* __restrict__ out, uint32_t S, FastDiv group, int WIN,
                 int n_rows) {
  const uint32_t t = blockIdx.x * kRowThreads + threadIdx.x;
  const uint32_t s0 = (t >> 5) * 2;
  const int lane = (int)(t & 31);
  const uint32_t s = s0 + (lane >> 4);
  const int c = (lane & 15) * 8;
  const uint64_t pol = evict_last_policy();
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (s < S) {
    const Pair p = load_pair<kMode>(loc, w, tile, s, group, WIN, n_rows);
    const uint4 a = ld_row(tab + p.r0 * kN + c, pol);
    if (kMode == kTile) {
      lo = bf16x4(a.x, a.y);
      hi = bf16x4(a.z, a.w);
    } else {
      const uint4 b = ld_row(tab + p.r1 * kN + c, pol);
      lo = pair_sum(p.w0, bf16x4(a.x, a.y), p.w1, bf16x4(b.x, b.y));
      hi = pair_sum(p.w0, bf16x4(a.z, a.w), p.w1, bf16x4(b.z, b.w));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {      // unit `lane` of sample s0 + h
    const int src = 16 * h + (lane >> 1);
    const float4 a = shfl4(lo, src), b = shfl4(hi, src);
    if (s0 + h < S)
      __stcs(reinterpret_cast<float4*>(out + (int64_t)(s0 + h) * kN) + lane,
             (lane & 1) ? b : a);
  }
}

// -------------------------------------------------------------------- B3

// The streaming products: persistent blocks, TMA, wgmma (the note at the
// top of the file). Shared memory from a 1024-byte boundary: the ring of
// `stages` stages (a stage: A's (256, 64) tile, 32 KB, then B's (64, 128)
// k-tile, 16 KB, unless B is resident), B's k-tiles when resident, two
// 16 KB staging boxes of C (one a consumer warpgroup), the barriers.
constexpr int kTileM = 256;                  // output rows of a tile
constexpr int kTileK = 64;                   // k of a TMA tile: 128 B of bf16
constexpr int kAStage = kTileM * kTileK * 2;           // 32 KB
constexpr int kBTile = kTileK * kN * 2;                // 16 KB
constexpr int kBHalf = kBTile / 2;           // one TMA box: 64 columns
constexpr int kCBox = 32;                    // f32 columns a C store: 128 B
constexpr int kCStage = 128 * kCBox * 4;               // 16 KB
constexpr int kMaxStages = 8;
constexpr int kConsumers = 256;              // two warpgroups, 128 rows each
constexpr int kGemmThreads = kConsumers + 128;         // + the producer's

constexpr int gemm_smem_bytes(int stages, int resident, int nk) {
  return 1024 + stages * (kAStage + (resident ? 0 : kBTile)) +
         (resident ? nk * kBTile : 0) + 2 * kCStage +
         8 * (2 * kMaxStages + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Until the barrier's phase of parity `parity` has completed. A wait of
// more than 2 s is a fault of the pipeline: trap, which fails the launch,
// rather than hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (spin == 0) t0 = t;
      else if (t - t0 > 2000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one TMA store of a box from shared memory, one bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      ::"l"((uint64_t)map), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes, seen by the TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b) : "memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle; the offsets
// in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

// d (64 x 128, f32) += A (64 x 16, K-major) B (16 x 128, N-major), both
// from shared memory; d = A B when scale_d is 0
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The launch-bound products (the note at the top of the file): a block
// owns `block_rows` (16 or 32) rows of one batch element and half of the
// columns (kSmallCols); its warps take 16 rows x kSmallWarpCols columns
// each. Every operand byte of the block arrives by cp.async, 16 bytes a
// thread, in one commit group; after one wait and one __syncthreads every
// k step runs from shared memory. Dynamic shared memory: A's rows at a
// pitch of K + 8 bf16, then B's K rows at kSmallCols + 8 (odd numbers of
// 16-byte units, so that ldmatrix's 8 rows fall on distinct banks).
constexpr int kSmallCols = kN / 2;          // columns a block
constexpr int kSmallWarpCols = 16;          // columns a warp
constexpr int kSmallSmem = 48 * 1024;       // launches without an opt-in

constexpr int small_smem_bytes(int block_rows, int K) {
  return block_rows * (K + 8) * 2 + K * (kSmallCols + 8) * 2;
}

__global__ void __launch_bounds__(2 * (kSmallCols / kSmallWarpCols) * 32)
gemm_small_kernel(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ B, float* __restrict__ C,
                  int M, int K, int b_batched, int block_rows) {
  constexpr int NT = kSmallWarpCols / 8;
  constexpr int pb = kSmallCols + 8, ub = kSmallCols / 8;
  extern __shared__ __align__(16) uint8_t smem_small[];
  const int pa = K + 8, ua = K / 8;         // 16-byte units a row of A
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_small);
  __nv_bfloat16* sB = sA + block_rows * pa;
  const int half = blockIdx.x & 1;
  const int m0 = (blockIdx.x >> 1) * block_rows;
  const int rows = min(block_rows, M - m0);
  const int64_t b = blockIdx.y;
  const __nv_bfloat16* Ab = A + (b * M + m0) * K;
  const __nv_bfloat16* Bb =
      B + (b_batched ? b * K * kN : 0) + half * kSmallCols;

  for (int q = threadIdx.x; q < rows * ua; q += blockDim.x)
    cp_async16(sA + (q / ua) * pa + (q % ua) * 8,
               Ab + (int64_t)(q / ua) * K + (q % ua) * 8);
  for (int q = threadIdx.x; q < K * ub; q += blockDim.x)
    cp_async16(sB + (q / ub) * pb + (q % ub) * 8,
               Bb + (int64_t)(q / ub) * kN + (q % ub) * 8);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % (block_rows / 16), wn = warp / (block_rows / 16);
  if (wm * 16 >= rows) return;              // rows come 16 at a time
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const __nv_bfloat16* wB = sB + wn * kSmallWarpCols;
  for (int kt = 0; kt < K / 16; ++kt) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (wm * 16 + (lane & 15)) * pa + kt * 16 +
                       (lane >> 4) * 8);
    mma_tiles<NT>(acc, a, wB + kt * 16 * pb, pb, lane);
  }
  store_tiles<NT>(C + (b * M + m0 + wm * 16 + (lane >> 2)) * kN +
                      half * kSmallCols + wn * kSmallWarpCols +
                      2 * (lane & 3),
                  acc);
}

// C (walks, rows, 128) f32 = A (walks, rows, K) bf16 @ B (K, 128) (shared
// by the walks) or (walks, K, 128) bf16; a tile is 256 rows of one walk.
// Warpgroups 0 and 1 multiply (rows 0-127 and 128-255 of a tile, two
// m64n128k16 a 16-deep k step each); warpgroup 2's first thread issues
// the TMA loads. kResB: B, shared, loaded once into shared memory.
template <bool kResB>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, int rows,
                int walks, int nk, int stages, int b_batched) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = kAStage + (kResB ? 0 : kBTile);
  uint8_t* b_res = ring + stages * stage_bytes;
  uint8_t* c_stage = b_res + (kResB ? nk * kBTile : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(c_stage + 2 * kCStage);
  const uint32_t full0 = smem_u32(bars);               // full[s]: +8 s
  const uint32_t empty0 = smem_u32(bars + kMaxStages);
  const uint32_t b_full = smem_u32(bars + 2 * kMaxStages);
  const int tiles_per_walk = (rows + kTileM - 1) / kTileM;
  const int n_tiles = walks * tiles_per_walk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers / 32);   // a consumer warp each
    }
    mbar_init(b_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kConsumers) return;
    if (kResB) {
      mbar_expect_tx(b_full, nk * kBTile);
      for (int kt = 0; kt < nk; ++kt) {
        const uint32_t dst = smem_u32(b_res + kt * kBTile);
        tma_load_3d(dst, &map_b, b_full, 0, kt * kTileK, 0);
        tma_load_3d(dst + kBHalf, &map_b, b_full, 64, kt * kTileK, 0);
      }
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int w = tile / tiles_per_walk;
      const int m0 = (tile % tiles_per_walk) * kTileM;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t dst = smem_u32(ring + s * stage_bytes);
        mbar_expect_tx(full, stage_bytes);     // out-of-bounds fill counts
        tma_load_3d(dst, &map_a, full, kt * kTileK, m0, w);
        if (!kResB) {
          const int wb = b_batched ? w : 0;
          tma_load_3d(dst + kAStage, &map_b, full, 0, kt * kTileK, wb);
          tma_load_3d(dst + kAStage + kBHalf, &map_b, full, 64, kt * kTileK,
                      wb);
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x >> 7;          // rows 128 wg .. of a tile
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int row0 = (t >> 5) * 16 + (lane >> 2);   // and + 8, of each m64
    const int col0 = 2 * (lane & 3);
    const uint32_t cst = smem_u32(c_stage + wg * kCStage);
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    if (kResB) mbar_wait(b_full, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int w = tile / tiles_per_walk;
      const int m0 = (tile % tiles_per_walk) * kTileM;
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full0 + 8 * s, ph);
        const uint32_t a_u =
            smem_u32(ring + s * stage_bytes) + wg * 128 * (kTileK * 2);
        const uint32_t b_u = kResB ? smem_u32(b_res + kt * kBTile)
                                   : smem_u32(ring + s * stage_bytes + kAStage);
        wgmma_fence();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
#pragma unroll
        for (int kk = 0; kk < kTileK / 16; ++kk) {
          // B, N-major: 8 k-rows of 128 B a 1024-byte atom (SBO), the
          // second 64 columns 8 KB on (LBO); 16 k-rows = 2048 B a step
          const uint64_t db = wgmma_desc(b_u + kk * 2048, kBHalf >> 4, 64);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            // A, K-major: 8 rows of 128 B an atom (SBO); a k step is 32 B
            wgmma_m64n128k16(acc[h],
                             wgmma_desc(a_u + h * 64 * 128 + kk * 32, 1, 64),
                             db, (kt | kk) != 0);
        }
        wgmma_commit();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_wait<1>();                      // the previous stage is read
        if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      // C out through shared memory, 32 columns at a time, by TMA stores
      // (128-byte swizzle: 16-byte unit c of row r at c ^ (r % 8))
#pragma unroll
      for (int q = 0; q < kN / kCBox; ++q) {
        if (t == 0) bulk_wait_read<0>();      // the box is free again
        named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int jj = 0; jj < kCBox / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = h * 64 + row0 + 8 * e;
              const int c = jj * 8 + col0;
              const int j = q * (kCBox / 8) + jj;   // the n8 block
              st_shared_v2(cst + r * 128 + (((c >> 2) ^ (r & 7)) << 4) +
                               (c & 3) * 4,
                           acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
            }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (t == 0) tma_store_3d(&map_c, cst, q * kCBox, m0 + wg * 128, w);
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------- B3, the host

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime so
// that this library does not link libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a (d2, d1, d0) tensor, d0 innermost, read or written in (b1, b0) boxes
// with the 128-byte swizzle; loads fill what lies outside it with zeros,
// stores clip to it
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                uint32_t b0, uint32_t b1) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem_bytes, d0 * d1 * elem_bytes};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(ptr), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kResB>
int launch_gemm_tma(const CUtensorMap& ma, const CUtensorMap& mb,
                    const CUtensorMap& mc, int rows, int walks, int nk,
                    int stages, int b_batched, int blocks, int smem,
                    int max_smem, cudaStream_t st) {
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tma_kernel<kResB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem);
    if (err != cudaSuccess) return (int)err;
    opted = true;
  }
  gemm_tma_kernel<kResB><<<blocks, kGemmThreads, smem, st>>>(
      ma, mb, mc, rows, walks, nk, stages, b_batched);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). All tensors contiguous; each
// launches on `stream` and returns cudaGetLastError() (0 on success).

// B1 / B2: out (S, 128) f32 from tab (n_rows, 128) bf16. mode 0 (static
// window: n_rows == WIN) and 1 (dynamic base): loc (S, 2) int32 global rows,
// w (S, 2) f32, G dividing S, WIN at most n_rows; mode 2 (sorted tile): loc
// (S,) int32 in [0, 512), tile (S / 512,) int32 tile of each block of 512
// samples, G = WIN = 512, w unused. S below 2^26; tab on 16 bytes, loc and
// w on 8 (B1), out on 16. The grid is the caller's
// (tools/mma.py::pair_plan): `blocks` blocks of 256 threads, two samples a
// warp; a grid that does not cover the samples is refused.
extern "C" int probe_pair_rows(const void* loc, const void* w,
                               const void* tile, const void* tab, void* out,
                               int S, int G, int WIN, int n_rows, int mode,
                               int blocks, void* stream) {
  if (S <= 0 || S >= (1 << 26) || G <= 0 || S % G || WIN <= 0 ||
      WIN > n_rows || mode < kStatic || mode > kTile ||
      (mode == kStatic && WIN != n_rows) ||
      (mode == kTile && (G != kTileRows || WIN != kTileRows)) ||
      (int64_t)blocks * (kRowThreads / 32) * 2 < S)
    return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out)) &
       15) ||
      (mode != kTile && ((reinterpret_cast<uintptr_t>(loc) |
                          reinterpret_cast<uintptr_t>(w)) & 7)))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const FastDiv group((uint32_t)G);
  const int32_t* l = (const int32_t*)loc;
  const float* ww = (const float*)w;
  const int32_t* tl = (const int32_t*)tile;
  const __nv_bfloat16* tb = (const __nv_bfloat16*)tab;
  float* o = (float*)out;
  if (mode == kStatic)
    pair_rows_kernel<kStatic><<<blocks, kRowThreads, 0, st>>>(
        l, ww, tl, tb, o, (uint32_t)S, group, WIN, n_rows);
  else if (mode == kDynamic)
    pair_rows_kernel<kDynamic><<<blocks, kRowThreads, 0, st>>>(
        l, ww, tl, tb, o, (uint32_t)S, group, WIN, n_rows);
  else
    pair_rows_kernel<kTile><<<blocks, kRowThreads, 0, st>>>(
        l, ww, tl, tb, o, (uint32_t)S, group, WIN, n_rows);
  return (int)cudaGetLastError();
}

// B3: C (batch, M, 128) f32 = A (batch, M, K) bf16 @ B, B (K, 128) bf16
// shared (b_batched 0) or (batch, K, 128); M and K multiples of 16, every
// pointer on 16 bytes. probe_gemm: the TMA and wgmma kernel, with `stages`
// ring stages (2-8) and B resident in shared memory (b_resident, B shared
// only); the plan is the caller's (tools/mma.py::gemm_plan), and a plan
// that does not fit the card's shared memory is refused.
extern "C" int probe_gemm(const void* A, const void* B, void* C, int batch,
                          int M, int K, int b_batched, int stages,
                          int b_resident, void* stream) {
  if (batch <= 0 || M <= 0 || K <= 0 || M % 16 || K % 16 || batch > 65535 ||
      stages < 2 || stages > kMaxStages || (b_resident && b_batched))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(C)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int64_t rows = b_batched ? M : (int64_t)batch * M;
  if (rows >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const int walks = b_batched ? batch : 1;
  const int nk = (K + kTileK - 1) / kTileK;
  const int smem = gemm_smem_bytes(stages, b_resident, nk);
  int dev = 0, max_smem = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > max_smem) return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ma, mb, mc;
  if (!tensor_map(&ma, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, A, K, rows, walks,
                  kTileK, kTileM) ||
      !tensor_map(&mb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, kN, K,
                  b_batched ? batch : 1, 64, kTileK) ||
      !tensor_map(&mc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, C, kN, rows, walks,
                  kCBox, 128))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = walks * ((rows + kTileM - 1) / kTileM);
  const int blocks = (int)(tiles < sms ? tiles : sms);
  cudaStream_t st = (cudaStream_t)stream;
  return b_resident
             ? launch_gemm_tma<true>(ma, mb, mc, (int)rows, walks, nk, stages,
                                     b_batched, blocks, smem, max_smem, st)
             : launch_gemm_tma<false>(ma, mb, mc, (int)rows, walks, nk,
                                      stages, b_batched, blocks, smem,
                                      max_smem, st);
}

// B3 at the launch-bound shapes: the same function by mma.sync, a block of
// block_rows (16 or 32) rows of a batch element and 64 columns in
// block_rows / 16 x 4 warps (gemm_small_kernel). The block is the caller's
// (tools/mma.py::gemm_small_plan); one whose operands exceed 48 KB of
// shared memory is refused.
extern "C" int probe_gemm_small(const void* A, const void* B, void* C,
                                int batch, int M, int K, int b_batched,
                                int block_rows, void* stream) {
  if (batch <= 0 || M <= 0 || K <= 0 || M % 16 || K % 16 || batch > 65535 ||
      (block_rows != 16 && block_rows != 32))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) |
       reinterpret_cast<uintptr_t>(C)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int smem = small_smem_bytes(block_rows, K);
  if (smem > kSmallSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + block_rows - 1) / block_rows * (kN / kSmallCols),
                  batch);
  const int threads = block_rows / 16 * (kSmallCols / kSmallWarpCols) * 32;
  gemm_small_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)A, (const __nv_bfloat16*)B, (float*)C, M, K,
      b_batched, block_rows);
  return (int)cudaGetLastError();
}
