// Patch-window (tilewin) gather + combine in the TPU kernel's matrix
// formulations ("dot", "bdiag" and "vpu"), for Hopper (sm_90a), at M = 16
// members a unit and F = 32 channels.
//
// Replaces the TPU Pallas kernels
// enarf_gan_tpu/ops/tilewin_kernel.py::_combine_kernel (modes "dot" and
// "vpu") and ::_combine_kernel_bdiag (mode "bdiag"), launched by
// tilewin_combine under ENARF_TILEWIN_KERNEL, and also does the window-row
// gathers that the JAX package runs outside those kernels.
//
// The function is kernel 2's (csrc/tilewin_combine.cu), on the same texel
// table and plan (tilewin_texels.cuh), computed as the TPU computed it. The
// window of a (unit, slot, plane) is the 8x8 texels from its base texel; its
// tile W holds their 32 feature channels, 4 KB of bf16: the TPU's window
// row, sublane 2t + s/4 and lane 32 (s % 4) + f. The separable bilinear
// weight splits into a t-weight and an s-weight. Per (unit, slot, plane),
// with k = 8h + t enumerating the 16 sublanes (a sum over k does not depend
// on the order of k):
//     A[h*16 + j, k] = wt_j(t) * valid_j * [k / 8 == h]
//     D = A (32 x 16) @ W (16 x 128), W[k, 32q + f] = texel (t, 4h + q), f
//     S[j, f] += sum_q D[j, 32q + f] ws_j(q) + D[16 + j, 32q + f] ws_j(4 + q)
// with wt_j(t) = 1 - ft at t = i, ft at t = i + 1, 0 elsewhere (i, ft the
// member's texel and fraction, i clamped to 6 as in kernel 2), and ws_j the
// same in s. Then the mask logit, the sigmoid product and the slot sum are
// kernel 2's, in float32, from the same texels.
// * "dot" and "bdiag": A is rounded to bf16 (the TPU kernels'
//   A.astype(bfloat16)) and D = A @ W runs on the tensor cores in float32
//   accumulation, 32 mma.sync.m16n8k16 bf16 instructions: 2 row tiles (the
//   halves h) by 16 column tiles, one k-step of 16. "bdiag" packed 8 units'
//   A blocks into one block-diagonal (256 x 128) lhs only to fill a
//   128-wide MXU; its products are the same numbers plus exact zeros, so it
//   runs this code path too.
// * "vpu": the same contraction in float32 FMAs on the CUDA cores, A not
//   rounded (the TPU kernel's broadcast-multiply sum).
//
// What bounds it: bytes; kernel 2's bound is its bound (the same function).
// This formulation moves whole tiles: each (unit, slot, plane) reads its 4
// KB through L2 (64 feature halves of texels), where kernel 2 reads only
// the 2x2 texels its members touch. The tensor-core work (131 kFLOP a
// (unit, slot, plane)) is far below the card's bf16 rate; the vpu form's
// float32 FMAs (64 kFLOP each) are of the order of the bytes.
//
// Design: one warp per unit, 8 units a block, as kernel 2; the block stages
// the plan (base texels, bones), coordinates and validity in shared memory.
// Each warp streams its unit's Mp x 3 tiles through a ring of kStages slots
// in shared memory: lane 0 issues a TMA tile load a tile, completing on the
// slot's mbarrier, kStages tiles ahead of the one the warp multiplies, and
// refills a slot as soon as the warp has read it. The tensor map views the
// texel table (B*3 planes, W+2, H+2, 64 lanes) with t listed before s, and a
// box of (32 lanes, 8 t, 8 s, 1 plane) from the window's base: the tile
// lands texel-column-major, [s][t][f], 64 bytes a texel, in the 64-byte
// swizzle (tile_off), so that the 8 rows of each ldmatrix matrix (the 8 t of
// one s) fall on distinct banks. TMA fills the box past the plane with
// zeros, the zeros that the TPU's window rows hold there. ldmatrix.x4.trans
// feeds the mma's B fragments from the tile as stored; the A fragments are
// built in registers (half of them are exact zeros, the other half h).
// Thread (g4 = lane / 4, c = lane % 4) holds D for members g4 and g4 + 8 and
// lanes 8 nt + 2c + {0, 1}, so the s-weights and the fold of the 4 quarters
// q onto a channel happen in its registers with no shuffle: it owns 8
// channels of 2 members. Lane j < 16 computes member j's mask logit from the
// bone's lane of its 2x2 texels, which the tile does not hold: when the tile
// is issued, lane j copies the four 4-byte words that hold them into the
// slot's mask words by cp.async, so that their trip to L2 overlaps the
// tile's. (Loaded after the product, as kernel 2 loads them, they cost each
// warp a trip to L2 a tile: the TMA fills no L1 line for them to hit.) Two
// blocks an SM keep 16 warps and 32 tiles in flight. The feature goes out
// through shared memory (the ring, once the warps are done) in its final
// (B, F, n) layout, as in kernel 2.
//
// The stage build (-DTILEWIN_STAGE_ENTRY, tools/ablate.py) runs the same
// kernel on the TPU's window rows (pack_tilewin's (R, 16, 128) feature rows
// and (Rm, 64) mask rows): a second tensor map views the rows with the same
// box, so the tile lands in the same layout, and the mask logit reads the
// mask row. Its full variant on the rows that a plan's base texels name is
// the texel kernel's result, number for number.

#include <cuda.h>               // CUtensorMap (types only: no libcuda)

#include "tilewin_texels.cuh"

namespace {

using namespace tilewin;

constexpr int kNTex = kWin * kWin;
constexpr int kM = 16;                      // members per unit
constexpr int kStages = 2;                  // ring slots a warp
constexpr int kTileBytes = kNTex * kF * 2;  // a tile: 64 texels x 32 bf16
constexpr int kAlign = 512;                 // the 64-byte swizzle's period
constexpr int kMaskSlot = kM * 4 * 4;       // a tile's mask words: 16 x 4

// where a tile comes from: the texel table (the main path) or window rows
// (the stage build)
enum Fetch { kTexels = 0, kRows = 1 };

// bf16 offset of texel (t, s), channel f in a tile as the TMA writes it:
// texel s * 8 + t at 64 bytes, its 16-byte unit f / 8 xor-ed with (t / 2)
// % 4 (the 64-byte swizzle: bits 4-5 of the address with bits 7-8)
__device__ __forceinline__ int tile_off(int t, int s, int f) {
  return (s * kWin + t) * kF + ((((f >> 3) ^ (t >> 1)) & 3) << 3) + (f & 7);
}

// channels f, f + 1 (f even) of texel (t, s) of a tile
__device__ __forceinline__ float2 tile_pair(const __nv_bfloat16* W, int t,
                                            int s, int f) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(W + tile_off(t, s, f)));
}

// the bilinear weight of texel t along one axis: 1 - f at i, f at i + 1
__device__ __forceinline__ float axis_weight(int t, int i, float f) {
  return t == i ? 1.f - f : (t == i + 1 ? f : 0.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// one 4-byte asynchronous copy from global to shared memory (through L1)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}

// Stage ablations (the Hopper counterparts of tools/probe_tilewin_bdiag.py's
// variants), in both paths, on window rows. The main entry point
// instantiates kFull on the texel table only; built with
// -DTILEWIN_STAGE_ENTRY the library also exports
// tilewin_combine_modes_stage_bf16. Every variant still loads the whole
// tiles and writes what it reads into the outputs:
//   kStream  S[j, f] += W[texel (0, 0), f] + xt_j + xs_j (no A, no
//            s-weights, no product), logit_j = valid_j * mask[mrow, texel 0];
//   kFeatA   the t-weights are 1 at every t (no valid, no rounding);
//   kFeatD   D[h, lambda] = sum_t W[8h + t, lambda] + sum_t A[j, t] (the
//            product replaced by a sum of the staged tile, A unrounded);
//   kFeatB   the s-weights are 1;
//   kFeat    no mask rows read: cand_w = 1;
//   kMask    no feature product: S[j, f] += sum over the tile's 64 texels of
//            channel f (no weights).
enum Stage { kFull = 0, kStream = 1, kFeatA = 2, kFeatD = 3, kFeatB = 4,
             kFeat = 5, kMask = 6 };

// shared memory of a block: the tile ring and its mbarriers, then each
// warp's mask words (kStages slots of 16 members x 4 corners x 4 bytes),
// the windows (base texels or rows) and slots (bones or mask rows) of the
// block's 8 units, and the staged coordinates and validity
size_t smem_bytes(int Mp) {
  const size_t ring = (size_t)kUnits * kStages * kTileBytes;
  const size_t bars = (size_t)kUnits * kStages * sizeof(uint64_t);
  const size_t mask = (size_t)kUnits * kStages * kMaskSlot;
  const size_t plan = 2 * 3 * (size_t)Mp * kUnits;          // win, sel
  const size_t coords = 2 * 3 * (size_t)Mp * kM * kUnits;  // xt, xs
  const size_t slots = 2 * (size_t)Mp * kM * kUnits;       // valid, cand_w
  return kAlign + ring + bars + mask + (plan + coords + slots) * 4;
}

// the staged feature rows, padded (kF x (kM * kUnits + 1) floats), reuse
// the ring once every warp is done with it
static_assert(kF * (kM * kUnits + 1) * 4 <= kUnits * kStages * kTileBytes,
              "the feature staging must fit in the ring");

// map: the tensor map of the tiles (tile_map); mask: the texel table
// (kTexels) or the mask rows (kRows); win: the windows' base texels
// (B, 3, Mp, U) or feature rows; sel: the slots' bones (B, Mp, U) or the
// mask rows (B, 3, Mp, U).
// two blocks an SM: <= 128 registers (the vpu path spills a few of its
// float32 sums) and 87 KB of shared memory at Mp = 4
template <bool kTensor, int kFetch, int kStage = kFull>
__global__ void __launch_bounds__(kUnits * 32, 2)
tilewin_combine_modes_kernel(const __grid_constant__ CUtensorMap map,
                             const __nv_bfloat16* __restrict__ mask,
                             const int32_t* __restrict__ win,
                             const int32_t* __restrict__ sel,
                             const float* __restrict__ xt,
                             const float* __restrict__ xs,
                             const float* __restrict__ valid,
                             float* __restrict__ feature,
                             float* __restrict__ cand_w,
                             int Hp, int Wp, int Mp, int U, int S, int clamp) {
  static_assert(kFetch == kRows || kStage == kFull,
                "the stage ablations run on window rows");
  constexpr bool kLogit = kStage != kFeat;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) &
                  (kAlign - 1));
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + kUnits * kStages * kTileBytes);
  unsigned char* mwords =
      reinterpret_cast<unsigned char*>(bars + kUnits * kStages);
  int32_t* s_win =
      reinterpret_cast<int32_t*>(mwords + kUnits * kStages * kMaskSlot);
  const int plan_n = 3 * Mp * kUnits;
  const int coord_n = 3 * Mp * kM * kUnits;
  const int slot_n = Mp * kM * kUnits;
  constexpr int kPitch = kM * kUnits + 1;
  int32_t* s_sel = s_win + plan_n;         // [3][Mp][kUnits] or [Mp][kUnits]
  float* s_xt = reinterpret_cast<float*>(s_sel + plan_n);
  float* s_xs = s_xt + coord_n;            // [3][Mp][M][kUnits]
  float* s_valid = s_xs + coord_n;         // [Mp][M][kUnits]
  float* s_candw = s_valid + slot_n;       // [Mp][M][kUnits]
  float* s_feat = reinterpret_cast<float*>(ring);  // [kF][kPitch], at the end

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g4 = lane >> 2;                // this thread's members g4, g4 + 8
  const int c = lane & 3;
  const int b = blockIdx.y;
  const int u0 = blockIdx.x * kUnits;
  const int u = u0 + warp;
  const uint32_t bar0 = smem_u32(bars + warp * kStages);

  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int sel_n = kFetch == kTexels ? Mp * kUnits : plan_n;
  for (int e = threadIdx.x; e < plan_n + sel_n; e += blockDim.x) {
    const int w = e % kUnits;
    const bool is_win = e < plan_n;
    const int r = (is_win ? e : e - plan_n) / kUnits;   // p * Mp + g, or g
    const int32_t* src = is_win ? win : sel;
    const int rows = is_win || kFetch == kRows ? 3 * Mp : Mp;
    (is_win ? s_win : s_sel)[r * kUnits + w] =
        u0 + w < U ? __ldg(src + ((int64_t)b * rows + r) * U + u0 + w) : 0;
  }
  const int64_t cbase = (int64_t)b * 3 * Mp * kM * U;
  for (int e = threadIdx.x; e < coord_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int64_t off = cbase + (int64_t)(e / kUnits) * U + u0 + w;
    const bool ok = u0 + w < U;
    s_xt[e] = ok ? xt[off] : 0.f;
    s_xs[e] = ok ? xs[off] : 0.f;
  }
  const int64_t vbase = (int64_t)b * Mp * kM * U;
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    s_valid[e] = (u0 + w < U)
        ? valid[vbase + (int64_t)(e / kUnits) * U + u0 + w] : 0.f;
  }
  __syncthreads();

  float acc[2][8];                         // [member g4, g4+8][channel]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[mi][k] = 0.f;

  if (u < U) {   // warp-uniform
    const __nv_bfloat16* slots = reinterpret_cast<const __nv_bfloat16*>(
        ring + (size_t)warp * kStages * kTileBytes);
    const uint32_t slot0 = smem_u32(slots);
    const unsigned char* mslots = mwords + (size_t)warp * kStages * kMaskSlot;
    const CUtensorMap* tiles = &map;
    const int n_it = Mp * 3;               // (slot, plane) pairs, g major

    // member `lane`'s (lane < M) 2x2 mask texels of tile it: the bf16
    // elements of `mask` and the bilinear fractions
    auto mask_texels = [&](int it, int64_t (&e)[4], float& ft, float& fs) {
      const int g = it / 3, p = it - 3 * g;
      const int r = (p * Mp + g) * kUnits + warp;
      int i, k;
      texel_cell(s_xt[(p * Mp + g) * kM * kUnits + lane * kUnits + warp], i,
                 ft);
      texel_cell(s_xs[(p * Mp + g) * kM * kUnits + lane * kUnits + warp], k,
                 fs);
      if constexpr (kFetch == kTexels) {
        e[0] = quad_texel(s_win[r], i, k, Wp) * kTexel + kF +
               s_sel[g * kUnits + warp];
        e[1] = e[0] + kTexel;
        e[2] = e[0] + (int64_t)Wp * kTexel;
        e[3] = e[2] + kTexel;
      } else {
        e[0] = (int64_t)s_sel[r] * kNTex +
               (kStage == kStream ? 0 : i * kWin + k);
        e[1] = kStage == kStream ? e[0] : e[0] + 1;
        e[2] = kStage == kStream ? e[0] : e[0] + kWin;
        e[3] = kStage == kStream ? e[0] : e[0] + kWin + 1;
      }
    };
    // every lane: tile `it` into its slot (lane 0's TMA load) and its
    // members' mask words (lanes < M, one 4-byte cp.async a corner), then
    // one cp.async group, so that tile it's words are group it
    auto issue = [&](int it) {
      const int g = it / 3, p = it - 3 * g;
      const int st = it % kStages;
      if (lane == 0) {
        const int32_t w = s_win[(p * Mp + g) * kUnits + warp];
        mbar_expect_tx(bar0 + 8 * st, kTileBytes);
        if constexpr (kFetch == kTexels) {
          const int plane = w / (Hp * Wp);
          const int rem = w - plane * (Hp * Wp);
          const int bt = rem / Wp;
          tma_load_4d(slot0 + st * kTileBytes, tiles, bar0 + 8 * st, 0, bt,
                      rem - bt * Wp, plane);
        } else {
          tma_load_4d(slot0 + st * kTileBytes, tiles, bar0 + 8 * st, 0, 0, 0,
                      w);
        }
      }
      if (kLogit && lane < kM) {
        int64_t e[4];
        float ft, fs;
        mask_texels(it, e, ft, fs);
        const uint32_t dst =
            smem_u32(mslots + st * kMaskSlot) + lane * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q)       // the 4-byte word holding e[q]
          cp_async4(dst + 4 * q, mask + (e[q] & ~(int64_t)1));
      }
      cp_async_commit();
    };
    for (int it = 0; it < kStages; ++it) {
      if (it < n_it) issue(it);
      else cp_async_commit();
    }
    for (int g = 0; g < Mp; ++g) {
      const float* vv = s_valid + g * kM * kUnits + warp;
      const float v_lane = lane < kM ? vv[lane * kUnits] : 0.f;
      const float vm[2] = {vv[g4 * kUnits], vv[(g4 + 8) * kUnits]};
      float sg[2][8];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int k = 0; k < 8; ++k) sg[mi][k] = 0.f;
      float cw = 1.f;
      for (int p = 0; p < 3; ++p) {
        const int it = g * 3 + p;
        const int st = it % kStages;
        const int coff = (p * Mp + g) * kM * kUnits + warp;
        const float* cx = s_xt + coff;
        const float* cy = s_xs + coff;

        // member `lane`'s mask logit before its product (the bilinear form
        // of tilewin_texels.cuh): its words are group it, each lane's own
        cp_async_wait<kStages - 1>();
        float bil = 0.f;
        if (kLogit && lane < kM) {
          int64_t e[4];
          float ft, fs;
          mask_texels(it, e, ft, fs);
          const uint4 wv = *reinterpret_cast<const uint4*>(
              mslots + st * kMaskSlot + lane * 16);
          const uint32_t wd[4] = {wv.x, wv.y, wv.z, wv.w};
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = __uint_as_float((e[q] & 1 ? wd[q] >> 16 : wd[q] & 0xffffu)
                                   << 16);
          bil = kStage == kStream
                    ? v[0]
                    : (1.f - ft) * ((1.f - fs) * v[0] + fs * v[1]) +
                          ft * ((1.f - fs) * v[2] + fs * v[3]);
        }
        mbar_wait(bar0 + 8 * st, (it / kStages) & 1);
        const __nv_bfloat16* W = slots + st * (kTileBytes / 2);

        // this thread's members: t-weights at t = 2c, 2c + 1 (tensor) or
        // all t (vpu), s-weights at all s
        int it_[2], is_[2];
        float ft_[2], fs_[2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          texel_cell(cx[(g4 + 8 * mi) * kUnits], it_[mi], ft_[mi]);
          texel_cell(cy[(g4 + 8 * mi) * kUnits], is_[mi], fs_[mi]);
        }
        float hs[2][8];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int s = 0; s < 8; ++s)
            hs[mi][s] = kStage == kFeatB ? 1.f
                                         : axis_weight(s, is_[mi], fs_[mi]);

        if constexpr (kStage == kStream) {
          // channel of sg[.][k]: (k / 2) * 8 + 2c + k % 2, at texel (0, 0)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float w =
                __bfloat162float(W[tile_off(0, 0, k / 2 * 8 + 2 * c + k % 2)]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              sg[mi][k] += w + cx[(g4 + 8 * mi) * kUnits] +
                           cy[(g4 + 8 * mi) * kUnits];
          }
        } else if constexpr (kStage == kMask) {
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int q = nt >> 2, f = (nt & 3) * 8 + 2 * c;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int t = 0; t < kWin; ++t)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 v = tile_pair(W, t, 4 * h + q, f);
                s0 += v.x;
                s1 += v.y;
              }
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              sg[mi][k] += s0;
              sg[mi][k + 1] += s1;
            }
          }
        } else if constexpr (kStage == kFeatD) {
          float asum[2] = {0.f, 0.f};
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              asum[mi] += axis_weight(t, it_[mi], ft_[mi]) * vm[mi];
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int q = nt >> 2, f = (nt & 3) * 8 + 2 * c;
            float d0[2] = {0.f, 0.f}, d1[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float2 we = tile_pair(W, t, q, f);
              const float2 wo = tile_pair(W, t, 4 + q, f);
              d0[0] += we.x;
              d0[1] += we.y;
              d1[0] += wo.x;
              d1[1] += wo.y;
            }
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sg[mi][k + e] += (d0[e] + asum[mi]) * hs[mi][q] +
                                 (d1[e] + asum[mi]) * hs[mi][4 + q];
          }
        } else if constexpr (kTensor) {
          // A fragments of the two halves h (rows: members g4, g4 + 8;
          // columns k = 8h + 2c + {0, 1}, i.e. t = 2c, 2c + 1 of half h)
          float w0[2], w1[2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            w0[mi] = kStage == kFeatA
                         ? 1.f
                         : axis_weight(2 * c, it_[mi], ft_[mi]) * vm[mi];
            w1[mi] = kStage == kFeatA
                         ? 1.f
                         : axis_weight(2 * c + 1, it_[mi], ft_[mi]) * vm[mi];
          }
          const uint32_t lo = pack_bf16(w0[0], w1[0]);
          const uint32_t hi = pack_bf16(w0[1], w1[1]);
          const uint32_t a0[4] = {lo, hi, 0u, 0u};
          const uint32_t a1[4] = {0u, 0u, lo, hi};
          // ldmatrix row of this lane: matrix lane / 8 is (half (lane / 8)
          // % 2, column tile + lane / 16), its row t = lane % 8
          const int mh = (lane >> 3) & 1, mt = lane & 7, mn = lane >> 4;
#pragma unroll
          for (int nt = 0; nt < 16; nt += 2) {
            const int ntile = nt + mn;
            uint32_t bfr[4];
            ldmatrix_x4_trans(
                bfr, W + tile_off(mt, 4 * mh + (ntile >> 2), (ntile & 3) * 8));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int ntt = nt + hh;
              float d0[4], d1[4];
              mma_bf16(d0, a0, bfr[2 * hh], bfr[2 * hh + 1]);
              mma_bf16(d1, a1, bfr[2 * hh], bfr[2 * hh + 1]);
              const int q = ntt >> 2;
              const int k = (ntt & 3) * 2;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                sg[0][k + e] += d0[e] * hs[0][q] + d1[e] * hs[0][4 + q];
                sg[1][k + e] +=
                    d0[2 + e] * hs[1][q] + d1[2 + e] * hs[1][4 + q];
              }
            }
          }
        } else {
          float wt[2][8];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int t = 0; t < 8; ++t)
              wt[mi][t] = kStage == kFeatA
                              ? 1.f
                              : axis_weight(t, it_[mi], ft_[mi]) * vm[mi];
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int q = nt >> 2, f = (nt & 3) * 8 + 2 * c;
            float d0[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
            float d1[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const float2 we = tile_pair(W, t, q, f);
              const float2 wo = tile_pair(W, t, 4 + q, f);
#pragma unroll
              for (int mi = 0; mi < 2; ++mi) {
                d0[mi][0] += wt[mi][t] * we.x;
                d0[mi][1] += wt[mi][t] * we.y;
                d1[mi][0] += wt[mi][t] * wo.x;
                d1[mi][1] += wt[mi][t] * wo.y;
              }
            }
            const int k = (nt & 3) * 2;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sg[mi][k + e] += d0[mi][e] * hs[mi][q] +
                                 d1[mi][e] * hs[mi][4 + q];
          }
        }
        // every lane is done with the slot: refill it kStages tiles on
        __syncwarp();
        if (it + kStages < n_it) issue(it + kStages);
        else cp_async_commit();

        if (kLogit && lane < kM) {
          float logit = v_lane * bil;
          if (clamp) logit = fminf(fmaxf(logit, -2.f), 5.f);
          cw *= 1.f / (1.f + expf(-logit));
        }
      }
      if (lane < kM) s_candw[(g * kM + lane) * kUnits + warp] = cw;
      const float cwv = cw * v_lane;
      const float c0 = __shfl_sync(kAll, cwv, g4);
      const float c1 = __shfl_sync(kAll, cwv, g4 + 8);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[0][k] += c0 * sg[0][k];
        acc[1][k] += c1 * sg[1][k];
      }
    }
  }
  __syncthreads();   // every warp is done with the ring
  // channel of acc[.][k]: f = (k / 2) * 8 + 2c + k % 2
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      s_feat[((k >> 1) * 8 + 2 * c + (k & 1)) * kPitch +
             (g4 + 8 * mi) * kUnits + warp] = acc[mi][k];
  __syncthreads();

  // feature (B, F, n): point (patch * M + j) * S + s of unit u = patch * S + s
  const int64_t n = (int64_t)U * kM;
  for (int e = threadIdx.x; e < kF * kM * kUnits; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int f = e / (kUnits * kM);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    feature[((int64_t)b * kF + f) * n + ((int64_t)patch * kM + j) * S + s] =
        s_feat[f * kPitch + j * kUnits + w];
  }
  // cand_w (B, Mp, n_patch, M, S)
  for (int e = threadIdx.x; e < slot_n; e += blockDim.x) {
    const int w = e % kUnits;
    const int j = (e / kUnits) % kM;
    const int g = e / (kUnits * kM);
    const int uu = u0 + w;
    if (uu >= U) continue;
    const int patch = uu / S;
    const int s = uu - patch * S;
    cand_w[((int64_t)b * Mp + g) * n + ((int64_t)patch * kM + j) * S + s] =
        s_candw[e];
  }
}

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

// The tensor map of the tiles: a bf16 tensor (planes, ns, nt, lanes),
// lanes innermost, with the byte strides st of t, ss of s and sp of a
// plane, read in boxes of (32 lanes, 8 t, 8 s, 1 plane) with the 64-byte
// swizzle; loads fill what lies outside it with zeros. The map lists t
// before s whatever their strides, so a box lands [s][t][lane] (tile_off).
// Returns 0, or 10000 + the driver's error.
int tile_map(CUtensorMap* map, const void* ptr, uint64_t lanes, uint64_t nt,
             uint64_t ns, uint64_t planes, uint64_t st, uint64_t ss,
             uint64_t sp) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {lanes, nt, ns, planes};
  const cuuint64_t strides[3] = {st, ss, sp};
  const cuuint32_t box[4] = {kF, kWin, kWin, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_64B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <bool kTensor, int kFetch, int kStage = kFull>
int launch(const CUtensorMap& map, const void* mask, const void* win,
           const void* sel, const void* xt, const void* xs, const void* valid,
           void* feature, void* cand_w, int B, int Hp, int Wp, int Mp, int U,
           int S, int clamp, cudaStream_t stream) {
  const auto kernel = tilewin_combine_modes_kernel<kTensor, kFetch, kStage>;
  const size_t smem = smem_bytes(Mp);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // two blocks an SM need the largest carveout of shared memory, which the
  // driver does not take by itself
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((U + kUnits - 1) / kUnits, B);
  kernel<<<grid, kUnits * 32, smem, stream>>>(
      map, (const __nv_bfloat16*)mask, (const int32_t*)win,
      (const int32_t*)sel, (const float*)xt, (const float*)xs,
      (const float*)valid, (float*)feature, (float*)cand_w, Hp, Wp, Mp, U, S,
      clamp);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Dynamic shared memory of one block, in bytes (for the wrapper's report).
extern "C" int tilewin_combine_modes_smem_bytes(int Mp) {
  return (int)smem_bytes(Mp);
}

// Plain C entry point (loaded with ctypes); kernel 2's arguments
// (tilewin_combine.cu) at M = 16, all contiguous:
//   texels (B, 3, H+2, W+2, 64) bf16, on 16 bytes; bases (B, 3, Mp, U)
//   int32 window base texels over the whole table; bones (B, Mp, U) int32
//   in [0, 32); xt, xs (B, 3, Mp, 16, U) f32 in [0, 7); valid
//   (B, Mp, 16, U) f32 -> feature (B, 32, U*16) f32, cand_w
//   (B, Mp, U/S, 16, S) f32.
// tensor = 1 runs the "dot"/"bdiag" tensor-core path, 0 the "vpu" path.
// S divides U. Launches on `stream` and returns cudaGetLastError(), or
// 10000 + the driver's error if the table's tensor map cannot be encoded.
extern "C" int tilewin_combine_modes_bf16(
    const void* texels, const void* bases, const void* bones, const void* xt,
    const void* xs, const void* valid, void* feature, void* cand_w, int B,
    int H, int W, int Mp, int U, int S, int clamp, int tensor, void* stream) {
  if (!aligned16(texels)) return (int)cudaErrorMisalignedAddress;
  const uint64_t Hp = H + 2, Wp = W + 2, line = kTexel * 2;
  CUtensorMap map;
  const int bad = tile_map(&map, texels, kTexel, Hp, Wp, (uint64_t)B * 3,
                           Wp * line, line, Hp * Wp * line);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor)
    return launch<true, kTexels>(map, texels, bases, bones, xt, xs, valid,
                                 feature, cand_w, B, (int)Hp, (int)Wp, Mp, U,
                                 S, clamp, st);
  return launch<false, kTexels>(map, texels, bases, bones, xt, xs, valid,
                                feature, cand_w, B, (int)Hp, (int)Wp, Mp, U,
                                S, clamp, st);
}

#ifdef TILEWIN_STAGE_ENTRY
namespace {
template <bool kTensor>
int launch_stage(int stage, const CUtensorMap& map, const void* mask_table,
                 const void* frows, const void* mrows, const void* xt,
                 const void* xs, const void* valid, void* feature,
                 void* cand_w, int B, int Mp, int U, int S, int clamp,
                 cudaStream_t st) {
#define MODES_STAGE_CASE(K)                                                  \
  case K:                                                                    \
    return launch<kTensor, kRows, K>(map, mask_table, frows, mrows, xt, xs,  \
                                     valid, feature, cand_w, B, 0, 0, Mp, U, \
                                     S, clamp, st);
  switch (stage) {
    MODES_STAGE_CASE(kFull)
    MODES_STAGE_CASE(kStream)
    MODES_STAGE_CASE(kFeatA)
    MODES_STAGE_CASE(kFeatD)
    MODES_STAGE_CASE(kFeatB)
    MODES_STAGE_CASE(kFeat)
    MODES_STAGE_CASE(kMask)
  }
#undef MODES_STAGE_CASE
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// The stage ablations on the TPU's window rows: feat_table (R, 16, 128)
// bf16 (64 texels x 32 channels a row, on 16 bytes), mask_table (Rm, 64)
// bf16, frows, mrows (B, 3, Mp, U) int32 global rows, then
// tilewin_combine_modes_bf16's coordinates and outputs, with `stage` one of
// Stage (0 full, 1 stream, 2 featA, 3 featD, 4 featB, 5 feat, 6 mask).
extern "C" int tilewin_combine_modes_stage_bf16(
    const void* feat_table, const void* mask_table, const void* frows,
    const void* mrows, const void* xt, const void* xs, const void* valid,
    void* feature, void* cand_w, int R, int B, int Mp, int U, int S,
    int clamp, int tensor, int stage, void* stream) {
  if (!aligned16(feat_table)) return (int)cudaErrorMisalignedAddress;
  // row r's texel (t, s) lies at lanes (8t + s) * 32: t strides 512
  // bytes, s 64, a row 4 KB
  CUtensorMap map;
  const int bad = tile_map(&map, feat_table, kF, kWin, kWin, (uint64_t)R,
                           kWin * kF * 2, kF * 2, kTileBytes);
  if (bad) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (tensor)
    return launch_stage<true>(stage, map, mask_table, frows, mrows, xt, xs,
                              valid, feature, cand_w, B, Mp, U, S, clamp, st);
  return launch_stage<false>(stage, map, mask_table, frows, mrows, xt, xs,
                             valid, feature, cand_w, B, Mp, U, S, clamp, st);
}
#endif  // TILEWIN_STAGE_ENTRY
