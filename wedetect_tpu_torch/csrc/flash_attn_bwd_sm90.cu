// K3's backward in bf16 for Hopper (sm_90a): wgmma tiles fed by a TMA
// ring. Kernels K3-bwd-dq and K3-bwd-dkv.
//
// Replaces the two kernels of the stock Pallas TPU flash attention's
// custom VJP (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dq, kernel :1146, `pallas_call` :1456, and
// _flash_attention_bwd_dkv, kernel :796, `pallas_call` :1121), which the
// Qwen3-VL ViT reaches through wedetect_tpu/ops/attention.py:
// _flash_attention, for bf16 inputs at D = 64; f32 inputs and other bf16
// head dims take the SIMT kernels of csrc/flash_attn_bwd.cu
// (ops/flash_attention.py:bwd_route). The contract is theirs
// (ops/flash_attention.py:flash_attention_bwd_plain): q, k, v, dO, dq,
// dk, dv (B, L, H, 64) bf16 read and written in place; lse and delta =
// rowsum(dO * O) f32 (B, H, L); segment ids (B, L) int32 for the queries
// and the keys, or none (one segment). A key whose segment differs from
// the query's has logit -1e30 (replaced, not added); with `causal`, keys
// after the query are absent (p = 0). p = exp(s - lse) as 2^((s - lse)
// log2 e), the subtraction first: at the -1e30 fill of a row that sees no
// key of its own segment, s - lse is exactly 0 and p = 1, as in the stock
// kernels (a whole tile, below, has no fill and takes 2^(s' log2 e -
// lse log2 e), s' = q.k * scale, in one FMA). ds = p * (dO.V^T - delta)
// * scale; p rounded to bf16 before p^T.dO, ds before ds.K and ds^T.Q;
// f32 sums. dq loops over keys, dk/dv over query rows: each block owns
// its outputs, so there are no atomics and the gradients repeat bit for
// bit.
//
// Bound on the H100: 6 * H * D (dq) and 8 * H * D (dk/dv) FLOPs per
// scanned (query, key) pair at 989 TFLOP/s bf16, against q, k, v, dO,
// lse and delta read once and the gradients written once at 3.35 TB/s.
// At the training path's ViT shape (1, 4224, 16, 64) with 80 pad tokens
// the FLOPs bound both: 0.107 ms (dq), 0.142 ms (dk/dv).
//
// Design (csrc/flash_gqa_bwd_sm90.cu's, with G = 1, D = 64 and segment
// ids): one producer warpgroup issues TMA loads into a 3-stage ring
// signalled by mbarriers and gives its registers to two consumer
// warpgroups through setmaxnreg (40 against 232 a thread). At D = 64 a
// tile row is one 128-byte swizzled line, so a 64 x 64 tile is one 8 KB
// box of the map (64, H, L, B). The consumers run every product on
// wgmma (sm90_common.cuh): S = Q.K^T and dP = dO.V^T (S^T = K.Q^T and
// dP^T = V.dO^T) on wgmma_qk, m64n64k16 with both operands K-major in
// shared memory; dQ += dS.K, dV += P^T.dO and dK += dS^T.Q on wgmma_pv64,
// m64n64k16 with A from registers and B MN-major through the transpose
// bit. p and ds stay in registers: an m64n64 accumulator fragment,
// rounded to bf16 pairs, is the A operand of the next product as it
// stands. The producer's first warp writes each tile's 64 segment ids
// (dq: the keys'; dk/dv: the rows', with their lse and delta) beside the
// boxes, released by the same mbarrier, with a flag saying whether the
// 64 ids are one value. A tile's S and dP are issued behind the
// previous tile's last products (dQ; dV and dK), whose A operands wait
// in registers, so the tensor cores get one batch of work per tile; the
// first tile is peeled off, so no wgmma is issued under a branch, and
// every commit group is retired within its tile: with a product left in
// flight across the loop's back edge ptxas copies its registers there
// and serialises the wgmmas (C7511, C7515), which measured slower on the
// H100, as did a ping-pong of the two consumer warpgroups on named
// barriers.
//
// dq: a block owns 128 query rows of one (batch, head), 64 per consumer
// warpgroup; grid (H, ceil(L / 128), B), the last rows' blocks (the
// longest key walks when causal) launched first. Q and dO load once as
// 128-row boxes; 64-key tiles of K and V stream through the ring up to
// L (causal: up to the block's last row). Per tile: the previous tile's
// dQ += dS.K (K as the MN-major B), S and dP (p is taken while dP is in
// flight), p and ds in registers. Registers: dQ, S and dP, 32 + 32
// + 32 f32 a thread, and dS, 16 bf16 pairs.
//
// dk/dv: a block owns 128 keys of one (batch, head), 64 per consumer
// warpgroup; grid (H, ceil(L / 128), B), the first keys' blocks (the
// longest row walks when causal) launched first. K and V load once;
// 64-row tiles of Q and dO stream in, from the first tile that reaches
// the block's first key (causal) to L. Per tile: the previous tile's
// dV += P^T.dO and dK += dS^T.Q, S^T and dP^T, P^T and dS^T in
// registers (lse, delta and the ids indexed by column). Registers: dK,
// dV, S^T and dP^T, 4 x 32 f32, and P^T and dS^T, 2 x 16 bf16 pairs.
// Shared memory of either kernel: 32 KB of Q and dO (K and V), a ring
// of 3 x 16 KB.
//
// TMA zero-fills rows and keys past L: such rows get p = 0 (dk/dv) or
// are never stored (dq), such keys p = 0 (dq) or are never stored
// (dk/dv); lse, delta and the ids are never read there. Where the masks
// are skipped: a tile whose 64 ids are one value, equal to every id of
// the warp's own 16 rows (dq) or keys (dk/dv), with every element inside
// L and, when causal, visible, takes neither the segment select nor the
// bounds test; the test is uniform over the warp. At the ViT's shape only
// the tiles that touch the first pad token take the per-element path.
// No tile is skipped by segment: p there is exp(-1e30 - lse), 0 only for
// rows that see some key of their own segment.

#include <type_traits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kStages = 3;
constexpr int kTile = 64;                        // keys (dq) / rows (dk/dv)
constexpr int kTileBytes = kTile * kHalf * 2;    // 8 KB: one 64 x 64 box
constexpr int kStageBytes = 2 * kTileBytes;      // two tensors
constexpr int kBlock = 128;                      // rows (dq) / keys (dk/dv)
constexpr int kBlockBytes = kBlock * kHalf * 2;  // 16 KB
constexpr int kSmemBytes = 2 * kBlockBytes + kStages * kStageBytes + 1024;
constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kThreads = kConsumers + 128;       // and a producer warpgroup
constexpr int kIds = kTile + 2;  // a stage's ids, then "one value", pad

struct Params {
  const int* q_seg;   // (B, L), or null: one segment
  const int* kv_seg;  // (B, L), or null
  const float* lse;   // (B, H, L)
  const float* delta; // (B, H, L)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int l, h, causal;
  float sm_scale;
};

// segment id of position i < L of batch row bi (0 without ids)
__device__ __forceinline__ int seg_at(const int* seg, int l, int bi, int i) {
  return seg ? seg[static_cast<int64_t>(bi) * l + i] : 0;
}

// The producer warp's ids of a ring stage: positions [p0, p0 + 64)
// (past L, the last position's), then whether all 64 are one value
__device__ __forceinline__ void stage_ids(int* ids, const int* seg, int l,
                                          int bi, int p0, int lane) {
  const int lo = seg_at(seg, l, bi, min(p0 + lane, l - 1));
  const int hi = seg_at(seg, l, bi, min(p0 + 32 + lane, l - 1));
  ids[lane] = lo;
  ids[32 + lane] = hi;
  const int first = __shfl_sync(0xffffffffu, lo, 0);
  const bool one = __all_sync(0xffffffffu, lo == first && hi == first);
  if (lane == 0) ids[kTile] = one;
}

// x (64 x 64 accumulator) += A (64 rows at a0, K-major) . B^T (64 rows
// at b0, K-major) over D = 64: 4 steps of 16
__device__ __forceinline__ void product_d64(float (&x)[32], uint32_t a0,
                                            uint32_t b0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_qk(x, desc_sw128(a0 + kk * 32, 16, 1024),
             desc_sw128(b0 + kk * 32, 16, 1024));
}

// d (64 x 64) += A (bf16 pairs in registers, 64 x 64) . B (a 64-row
// tile at b0, MN-major: 16-row steps 2 KB apart)
__device__ __forceinline__ void product_t64(float (&d)[32],
                                            const uint32_t (&a)[16],
                                            uint32_t b0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv64(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
               desc_sw128(b0 + kk * 16 * (kHalf * 2), kTileBytes, 1024));
}

// ------------------------------------------------------------------ dq
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  __shared__ __align__(8) int kv_ids[kStages][kIds];
  // Q at +0, dO at +16 KB; stage st at 32 KB + st * 16 KB: K at +0, V at
  // +8 KB (1024-aligned: the swizzle atoms)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * kBlockBytes;
  const uint32_t bar_rows = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, bi = blockIdx.z;
  // the last row blocks scan the most keys (causal): they start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  const int last = min(row0 + kBlock, a.l) - 1;
  const int ntiles = ((a.causal ? last + 1 : a.l) + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar_rows, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; its
    // first warp feeds the ring: lane 0 issues the loads, every lane
    // writes two of the tile's key ids and arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - kConsumers;
    if (p < 32) {
      if (p == 0) {
        mbar_expect_tx(bar_rows, 2 * kBlockBytes);
        tma_load(base, &qmap, bar_rows, 0, hd, row0, bi);
        tma_load(base + kBlockBytes, &domap, bar_rows, 0, hd, row0, bi);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * st, (t / kStages - 1) & 1);
        stage_ids(kv_ids[st], a.kv_seg, a.l, bi, t * kTile, p);
        const uint32_t full = bar_full + 8 * st;
        if (p == 0) {
          const uint32_t dst = ring + st * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load(dst, &kmap, full, 0, hd, t * kTile, bi);
          tma_load(dst + kTileBytes, &vmap, full, 0, hd, t * kTile, bi);
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumers: warpgroup wg holds block rows 64 wg .. 64 wg + 63; a
    // thread holds rows rl and rl + 8, keys (columns) 8 j + 2 quad + {0, 1}
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int wrow = row0 + wg * 64 + warp * 16;  // the warp's first row
    int gr[2], qs[2];
    float lse[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      gr[i] = wrow + lane / 4 + 8 * i;
      // rows past L are zeros, computed like the last row, never stored
      qs[i] = seg_at(a.q_seg, a.l, bi, min(gr[i], a.l - 1));
      const int64_t at = (static_cast<int64_t>(bi) * a.h + hd) * a.l + gr[i];
      lse[i] = gr[i] < a.l ? a.lse[at] : 0.f;
      dlt[i] = gr[i] < a.l ? a.delta[at] : 0.f;
    }
    // whether the warp's 16 rows are all of one segment
    const int wseg = __shfl_sync(0xffffffffu, qs[0], 0);
    const bool wone =
        __all_sync(0xffffffffu, qs[0] == wseg && qs[1] == wseg);
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    const uint32_t q_wg = base + wg * 64 * (kHalf * 2);
    const uint32_t do_wg = q_wg + kBlockBytes;
    const float scale = a.sm_scale;
    // the whole-tile path's exponent in one FMA: s * scale log2 e -
    // lse log2 e (no -1e30 fill there)
    const float scale2 = scale * kLog2e;
    const float lse2[2] = {lse[0] * kLog2e, lse[1] * kLog2e};

    // dS of the previous tile in bf16, the A operand of its dQ product:
    // key slice kk is da[4 kk .. 4 kk + 3]
    uint32_t da[16];
    // one tile; `first` (std::true_type for tile 0) drops the previous
    // tile's product, so no wgmma is issued under a branch
    auto tile = [&](int t, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      const int st = t % kStages;
      const int k0 = t * kTile;
      const uint32_t ks = ring + st * kStageBytes;
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);

      // the previous tile's dQ += dS.K (K's 16-key steps 2 KB apart),
      // then S = Q.K^T and dP = dO.V^T: three commit groups, so p is
      // taken while dP is in flight
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dq);
      if constexpr (!kFirst) {
        product_t64(dq, da, ring + ((t - 1) % kStages) * kStageBytes);
        wgmma_commit();
      }
      product_d64(sc, q_wg, ks);
      wgmma_commit();
      product_d64(dp, do_wg, ks + kTileBytes);
      wgmma_commit();
      wgmma_wait1();
      fence_regs(sc);
      fence_regs(dq);
      // the previous tile's K and V are read: its stage goes back
      if constexpr (!kFirst) mbar_arrive(bar_empty + 8 * ((t - 1) % kStages));

      // x = 4 j + 2 i + e: row gr[i], key k0 + 8 j + 2 quad + e. p
      // replaces sc in place
      const int* ids = kv_ids[st];
      const bool whole = wone && ids[kTile] && ids[0] == wseg &&
                         k0 + kTile <= a.l &&
                         (!a.causal || k0 + kTile - 1 <= wrow);
      if (whole) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          sc[x] = exp2_approx(sc[x] * scale2 - lse2[(x >> 1) & 1]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kid = *reinterpret_cast<const int2*>(ids + 8 * j +
                                                          2 * quad);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * i + e;
              const int key = k0 + 8 * j + 2 * quad + e;
              const float val =
                  qs[i] == (e ? kid.y : kid.x) ? sc[x] * scale : kNeg;
              sc[x] = key < a.l && (!a.causal || key <= gr[i])
                          ? exp2_approx((val - lse[i]) * kLog2e)
                          : 0.f;
            }
        }
      }
      wgmma_wait0();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 16; ++x)
        da[x] = pack_bf16(sc[2 * x] * (dp[2 * x] - dlt[x & 1]) * scale,
                          sc[2 * x + 1] * (dp[2 * x + 1] - dlt[x & 1]) *
                              scale);
    };

    mbar_wait(bar_rows, 0);
    tile(0, std::true_type{});
    for (int t = 1; t < ntiles; ++t) tile(t, std::false_type{});
    // the last tile's dQ
    wgmma_fence();
    fence_regs(dq);
    product_t64(dq, da, ring + ((ntiles - 1) % kStages) * kStageBytes);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);

    // dq[4 j + 2 i + e] is row gr[i], column 8 j + 2 quad + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (gr[i] >= a.l) continue;
      __nv_bfloat16* out =
          a.dq + ((static_cast<int64_t>(bi) * a.l + gr[i]) * a.h + hd) * kHalf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
  }
}

// --------------------------------------------------------------- dk/dv
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // each stage's rows: lse, delta, and their ids
  __shared__ __align__(16) float row_lse[kStages][kTile];
  __shared__ __align__(16) float row_dlt[kStages][kTile];
  __shared__ __align__(8) int row_ids[kStages][kIds];
  // K at +0, V at +16 KB; stage st at 32 KB + st * 16 KB: Q at +0, dO at
  // +8 KB
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * kBlockBytes;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, bi = blockIdx.z;
  // the first key blocks take the most rows (causal): they start first
  const int k0 = blockIdx.y * kBlock;
  const int ntiles = (a.l + kTile - 1) / kTile;
  // causal: the rows before k0 see none of the block's keys
  const int t0 = a.causal ? k0 / kTile : 0;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; its
    // first warp feeds the ring: lane 0 issues the loads, every lane
    // writes lse, delta and the ids of two of the tile's rows and arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - kConsumers;
    if (p < 32) {
      if (p == 0) {
        mbar_expect_tx(bar_kv, 2 * kBlockBytes);
        tma_load(base, &kmap, bar_kv, 0, hd, k0, bi);
        tma_load(base + kBlockBytes, &vmap, bar_kv, 0, hd, k0, bi);
      }
      const int64_t at = (static_cast<int64_t>(bi) * a.h + hd) * a.l;
      for (int t = t0; t < ntiles; ++t) {
        const int u = t - t0, st = u % kStages;
        if (u >= kStages)
          mbar_wait(bar_empty + 8 * st, (u / kStages - 1) & 1);
        for (int r = p; r < kTile; r += 32) {
          const int row = t * kTile + r;
          row_lse[st][r] = row < a.l ? a.lse[at + row] : 0.f;
          row_dlt[st][r] = row < a.l ? a.delta[at + row] : 0.f;
        }
        stage_ids(row_ids[st], a.q_seg, a.l, bi, t * kTile, p);
        const uint32_t full = bar_full + 8 * st;
        if (p == 0) {
          const uint32_t dst = ring + st * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load(dst, &qmap, full, 0, hd, t * kTile, bi);
          tma_load(dst + kTileBytes, &domap, full, 0, hd, t * kTile, bi);
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumers: warpgroup wg holds block keys 64 wg .. 64 wg + 63; a
    // thread holds keys key[0] and key[1] = key[0] + 8, tile rows
    // (columns) 8 j + 2 quad + {0, 1}
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int wkey = k0 + wg * 64 + warp * 16;  // the warp's first key
    int key[2], ks[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      key[i] = wkey + lane / 4 + 8 * i;
      // keys past L are zeros, never stored
      ks[i] = seg_at(a.kv_seg, a.l, bi, min(key[i], a.l - 1));
    }
    // whether the warp's 16 keys are all of one segment
    const int wseg = __shfl_sync(0xffffffffu, ks[0], 0);
    const bool wone =
        __all_sync(0xffffffffu, ks[0] == wseg && ks[1] == wseg);
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_wg = base + wg * 64 * (kHalf * 2);
    const uint32_t v_wg = k_wg + kBlockBytes;
    const float scale = a.sm_scale;
    const float scale2 = scale * kLog2e;  // the whole-tile path's, as dq's

    // P^T and dS^T of the previous tile in bf16, the A operands of its dV
    // and dK products (row slice kk is pa[4 kk .. 4 kk + 3])
    uint32_t pa[16], da[16];
    // one tile, tile t0 first (`first`, as in dq)
    auto tile = [&](int t, auto first) {
      constexpr bool kFirst = decltype(first)::value;
      const int u = t - t0, st = u % kStages;
      const int row0 = t * kTile;
      const uint32_t qs = ring + st * kStageBytes;
      const uint32_t dos = qs + kTileBytes;
      mbar_wait(bar_full + 8 * st, (u / kStages) & 1);

      // the previous tile's dV += P^T.dO and dK += dS^T.Q (dO and Q
      // MN-major), then S^T = K.Q^T and dP^T = V.dO^T: three commit
      // groups, so P^T is taken while dP^T is in flight
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dv);
      fence_regs(dk);
      if constexpr (!kFirst) {
        const uint32_t prev = ring + ((u - 1) % kStages) * kStageBytes;
        product_t64(dv, pa, prev + kTileBytes);
        product_t64(dk, da, prev);
        wgmma_commit();
      }
      product_d64(sc, k_wg, qs);
      wgmma_commit();
      product_d64(dp, v_wg, dos);
      wgmma_commit();
      wgmma_wait1();
      fence_regs(sc);
      fence_regs(dv);
      fence_regs(dk);
      // the previous tile's Q and dO are read: its stage goes back
      if constexpr (!kFirst) mbar_arrive(bar_empty + 8 * ((u - 1) % kStages));

      // x = 4 j + 2 i + e: key key[i], row row0 + c, c = 8 j + 2 quad + e.
      // p replaces sc in place
      const float* ls = row_lse[st];
      const float* ds = row_dlt[st];
      const int* ids = row_ids[st];
      const bool whole = wone && ids[kTile] && ids[0] == wseg &&
                         row0 + kTile <= a.l &&
                         (!a.causal || wkey + 15 <= row0);
      if (whole) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * quad + (x & 1);
          sc[x] = exp2_approx(sc[x] * scale2 - ls[c] * kLog2e);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * quad + (x & 1);
          const int row = row0 + c;
          const float val = ks[i] == ids[c] ? sc[x] * scale : kNeg;
          sc[x] = row < a.l && (!a.causal || key[i] <= row)
                      ? exp2_approx((val - ls[c]) * kLog2e)
                      : 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < 16; ++x) pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
      wgmma_wait0();
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int c = 8 * (x >> 1) + 2 * quad;
        da[x] = pack_bf16(sc[2 * x] * (dp[2 * x] - ds[c]) * scale,
                          sc[2 * x + 1] * (dp[2 * x + 1] - ds[c + 1]) * scale);
      }
    };

    mbar_wait(bar_kv, 0);
    tile(t0, std::true_type{});
    for (int t = t0 + 1; t < ntiles; ++t) tile(t, std::false_type{});
    // the last tile's dV and dK
    const uint32_t last = ring + ((ntiles - 1 - t0) % kStages) * kStageBytes;
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
    product_t64(dv, pa, last + kTileBytes);
    product_t64(dk, da, last);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);

    // dk[4 j + 2 i + e] is key key[i], column 8 j + 2 quad + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= a.l) continue;
      const int64_t at =
          ((static_cast<int64_t>(bi) * a.l + key[i]) * a.h + hd) * kHalf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * quad;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + at + col) =
            __floats2bfloat162_rn(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + at + col) =
            __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

// The shared checks and tensor maps of both entry points: q and dO as
// boxes of `box_rows` rows, k and v of `box_keys` keys. Returns 0 or
// cudaErrorInvalidValue for input the kernels do not take.
int prepare(const void* q, const void* k, const void* v, const void* dout,
            int b, int l, int h, int box_rows, int box_keys,
            CUtensorMap* maps) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || l <= 0 || h <= 0) return bad;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16 != 0)
    return bad;
  if (!make_map(&maps[0], q, b, l, h, kHalf, 1, box_rows) ||
      !make_map(&maps[1], dout, b, l, h, kHalf, 1, box_rows) ||
      !make_map(&maps[2], k, b, l, h, kHalf, 1, box_keys) ||
      !make_map(&maps[3], v, b, l, h, kHalf, 1, box_keys))
    return bad;
  return 0;
}

template <typename Kernel>
int configure(Kernel kern, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

}  // namespace

// K3-bwd-dq in bf16 at D = 64. q, k, v, dout, dq (B, L, H, 64) bf16,
// q, k, v and dout 16-byte aligned (TMA); q_seg, kv_seg (B, L) int32 or
// null (one segment); lse, delta (B, H, L) f32. Launches on `stream`;
// returns cudaGetLastError() (0 = ok), cudaErrorInvalidValue for input
// it does not take.
extern "C" int flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const int* q_seg,
    const int* kv_seg, const void* dout, const float* lse,
    const float* delta, void* dq, int b, int l, int h, int causal,
    float sm_scale, void* stream) {
  CUtensorMap maps[4];
  int err = prepare(q, k, v, dout, b, l, h, kBlock, kTile, maps);
  static bool configured = false;
  if (err == 0) err = configure(fa_bwd_dq_sm90_kernel, &configured);
  if (err != 0) return err;
  Params p{q_seg, kv_seg, lse, delta, static_cast<__nv_bfloat16*>(dq),
           nullptr, nullptr, l, h, causal, sm_scale};
  dim3 grid(h, (l + kBlock - 1) / kBlock, b);
  fa_bwd_dq_sm90_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// K3-bwd-dkv in bf16 at D = 64. As flash_attention_bwd_dq_sm90; dk, dv
// (B, L, H, 64) bf16.
extern "C" int flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const int* q_seg,
    const int* kv_seg, const void* dout, const float* lse,
    const float* delta, void* dk, void* dv, int b, int l, int h, int causal,
    float sm_scale, void* stream) {
  CUtensorMap maps[4];
  int err = prepare(q, k, v, dout, b, l, h, kTile, kBlock, maps);
  static bool configured = false;
  if (err == 0) err = configure(fa_bwd_dkv_sm90_kernel, &configured);
  if (err != 0) return err;
  Params p{q_seg, kv_seg, lse, delta, nullptr,
           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
           l, h, causal, sm_scale};
  dim3 grid(h, (l + kBlock - 1) / kBlock, b);
  fa_bwd_dkv_sm90_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}
