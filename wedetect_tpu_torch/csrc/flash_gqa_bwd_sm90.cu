// K2's backward in bf16 for Hopper (sm_90a): wgmma tiles fed by a TMA
// ring. Kernels K2-bwd-dq and K2-bwd-dkdv.
//
// Replaces wedetect_tpu/ops/flash_gqa.py:_dq_kernel and :_dkdv_kernel
// (the Pallas TPU kernels of the grouped-KV flash attention's custom
// VJP, `pallas_call` at :287 and :308, reached through _bwd_grouped) for
// bf16 inputs at D = 128 with G dividing 64; f32 inputs and other bf16
// shapes take the SIMT kernels of csrc/flash_attn_bwd.cu
// (ops/flash_gqa.py:bwd_route). The contract is theirs
// (ops/flash_gqa.py:gqa_flash_attention_bwd_plain): q, dO, dq
// (B, S, H, D) and k, v, dk, dv (B, Lk, KVH, D) read and written in
// place, D = 128; folded row r is query r / G, head kvh * G + r % G; lse
// and delta = rowsum(dO * O) f32 (B, KVH, S * G) in folded order; each
// row scans keys [0, F) with the forward's frontier F and -1e30 for a
// masked key below F (flash_common.cuh); p = exp(s - lse) on scanned
// keys and 0 past F; ds = p * (dO.V^T - delta) * scale; p rounded to
// bf16 before p^T.dO, ds before ds.K and ds^T.Q; f32 sums. dq loops over
// query rows, dk/dv over keys: each block owns its outputs, so there are
// no atomics and the gradients repeat bit for bit.
//
// Bound on the H100: 6 * H * D (dq) and 8 * H * D (dk/dv) FLOPs per
// visible (query, key) pair at 989 TFLOP/s bf16, against q, k, v, dO,
// lse and delta read once and the gradients written once at 3.35 TB/s.
// At the training path's decoder shape (1, 2048, 16, 128 | 2048, 8),
// 1253 valid keys, the FLOPs bound both: 0.022 ms (dq), 0.030 ms (dk/dv).
//
// Design (the forward's, csrc/flash_gqa_sm90.cu): one producer issues
// TMA loads of 128-byte swizzled bf16 boxes into a 2-stage ring signalled
// by mbarriers. It sits in a third warpgroup, which gives its registers
// to the consumers through setmaxnreg (40 against 232 a thread: dk and
// dv hold 64 + 64 f32 a thread, S^T and dP^T 32 + 32; dq 64, S and dP
// 32 + 32). The two consumer warpgroups run every product on wgmma
// (sm90_common.cuh: wgmma_qk, m64n64k16 with both operands in shared
// memory, K-major; wgmma_pv, m64n128k16 with A from registers and B
// MN-major through the transpose bit) and keep p and ds in registers: an
// m64n64 accumulator fragment, rounded to bf16 pairs, is the A operand
// of the next product as it stands.
//
// dq: a block owns 128 folded rows of one (batch, kv head), 64 per
// consumer warpgroup; grid (KVH, ceil(S * G / 128), B), the last rows'
// blocks (the longest key walks when causal) launched first. Q
// and dO load once as (64, G, 128 / G, 1) boxes of the maps (D, H, S, B)
// (rows past S zero-filled, never stored); K and V stream as 64-key
// tiles up to the largest F among the block's rows. Per tile: S = Q.K^T
// and dP = dO.V^T (wgmma_qk), p and ds in registers, dQ += dS.K
// (wgmma_pv, K as the MN-major B). Shared memory: Q and dO 64 KB, ring
// 2 x 32 KB.
//
// dk/dv: a block owns 128 keys of one (batch, kv head), 64 per consumer
// warpgroup; grid (KVH, Lk / 128, B), the first keys' blocks (the
// longest row walks when causal) launched first. K and V load
// once; row tiles of 64 folded rows stream in as (64, G, 64 / G, 1)
// boxes of Q and dO, their 64 lse and delta values written beside them
// by the producer warp. The walk starts at the first tile whose last
// row's frontier reaches the block's first key (JAX's j0). Per tile:
// S^T = K.Q^T and dP^T = V.dO^T (wgmma_qk), P^T and dS^T in registers
// (lse and delta indexed by column; rows past S * G get p = 0), dV +=
// P^T.dO and dK += dS^T.Q (wgmma_pv); the row walk sums the G folded
// heads. Shared memory: K and V 64 KB, ring 2 x 32 KB.
//
// Where the masks are skipped: a tile that a warp's elements see whole
// (every element causally visible and below its row's F; for dk/dv also
// every row below S * G) takes only the key-validity select; the test is
// uniform over the warp. Rows of one tile may have different F (F moves
// every bq * G folded rows, which can be below 64), so other tiles test
// each element. exp(x - lse) is 2^((x - lse) log2 e), the subtraction
// first: at the -1e30 fill of a row with no visible valid key, x - lse
// is exactly 0 (p = 1), as in the Pallas kernels.

#include <math_constants.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kTile = 64;                     // keys (dq) / rows (dk/dv)
constexpr int kTileHalf = kTile * kHalf * 2;  // 8 KB: a tile, 64 of D
constexpr int kStageBytes = 4 * kTileHalf;    // two tensors, two halves each
constexpr int kBlock = 128;                   // rows (dq) / keys (dk/dv)
constexpr int kBlockHalf = kBlock * kHalf * 2;  // 16 KB
constexpr int kBlockBytes = 2 * kBlockHalf;     // one tensor of the block
constexpr int kSmemBytes = 2 * kBlockBytes + kStages * kStageBytes + 1024;
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup

struct Params {
  const int* kv_valid;  // (B, Lk) 0/1
  const float* lse;     // (B, KVH, S * G)
  const float* delta;   // (B, KVH, S * G)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int s, lk, h, kvh, g, causal, off, bq, bk;
  float sm_scale;
};

__device__ __forceinline__ int row_frontier(const Params& a, int qi) {
  return a.causal ? gqa_frontier(qi, a.lk, a.off, a.bq, a.bk) : a.lk;
}

// x (64 x 64 accumulator) += A (64 rows at a0, K-major, halves of D
// a_step apart) . B^T (64 rows at b0, K-major, halves kTileHalf apart)
// over D = 128: 8 steps of 16, 4 in each 64-wide half
__device__ __forceinline__ void product_d128(float (&x)[32], uint32_t a0,
                                             uint32_t a_step, uint32_t b0) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t step = (kk & 3) * 32;
    wgmma_qk(x, desc_sw128(a0 + (kk >> 2) * a_step + step, 16, 1024),
             desc_sw128(b0 + (kk >> 2) * kTileHalf + step, 16, 1024));
  }
}

// d (64 x 128) += A (bf16 pairs in registers, 64 x 64) . B (a 64-row
// tile at b0, MN-major: 16-row steps 2 KB apart, halves kTileHalf apart)
__device__ __forceinline__ void product_t64(float (&d)[64],
                                            const uint32_t (&a)[16],
                                            uint32_t b0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             desc_sw128(b0 + kk * 16 * (kHalf * 2), kTileHalf, 1024));
}

// ------------------------------------------------------------------ dq
__global__ void __launch_bounds__(kThreads, 1)
gqa_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap domap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // Q halves at +0 and +16 KB, dO halves at +32 KB and +48 KB; stage st
  // at 64 KB + st * 32 KB: K halves at +0 and +8 KB, V halves at +16 KB
  // and +24 KB (1024-aligned: the swizzle atoms)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * kBlockBytes;
  const uint32_t bar_rows = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, bi = blockIdx.z;
  const int rows = a.s * a.g;
  // the last row blocks scan the most keys (causal): they start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kBlock;
  // F grows with the row: the key loop ends at the last live row's
  const int last = min(row0 + kBlock, rows) - 1;
  const int ntiles = (row_frontier(a, last / a.g) + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar_rows, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == kConsumers) {
      mbar_expect_tx(bar_rows, 2 * kBlockBytes);
      for (int hf = 0; hf < 2; ++hf) {
        tma_load(base + hf * kBlockHalf, &qmap, bar_rows, hf * kHalf,
                 hk * a.g, row0 / a.g, bi);
        tma_load(base + kBlockBytes + hf * kBlockHalf, &domap, bar_rows,
                 hf * kHalf, hk * a.g, row0 / a.g, bi);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * st, (t / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t dst = ring + st * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load(dst + hf * kTileHalf, &kmap, full, hf * kHalf, hk,
                   t * kTile, bi);
          tma_load(dst + (2 + hf) * kTileHalf, &vmap, full, hf * kHalf, hk,
                   t * kTile, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumers: warpgroup wg holds block rows 64 wg .. 64 wg + 63; a
    // thread holds rows rl and rl + 8, keys (columns) 8 j + 2 quad + {0, 1}
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int rl = wg * 64 + warp * 16 + lane / 4;
    int gr[2], qpos[2], fr[2];
    float lse[2], dlt[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      gr[i] = row0 + rl + 8 * i;
      // rows past S * G are zeros, computed like the last row, never stored
      const int qi = min(gr[i], rows - 1) / a.g;
      qpos[i] = a.off + qi;
      fr[i] = row_frontier(a, qi);
      const int64_t at = (static_cast<int64_t>(bi) * a.kvh + hk) * rows + gr[i];
      lse[i] = gr[i] < rows ? a.lse[at] : 0.f;
      dlt[i] = gr[i] < rows ? a.delta[at] : 0.f;
    }
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    const int* valid = a.kv_valid + static_cast<int64_t>(bi) * a.lk;
    const uint32_t q_wg = base + wg * 64 * (kHalf * 2);
    const uint32_t do_wg = q_wg + kBlockBytes;
    const float scale = a.sm_scale;

    mbar_wait(bar_rows, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      const int k0 = t * kTile;
      const uint32_t ks = ring + st * kStageBytes;
      const uint32_t vs = ks + 2 * kTileHalf;
      int ok[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ok[2 * j] = valid[k0 + 8 * j + 2 * quad];
        ok[2 * j + 1] = valid[k0 + 8 * j + 2 * quad + 1];
      }
      mbar_wait(bar_full + 8 * st, (t / kStages) & 1);

      // S = Q.K^T and dP = dO.V^T, two commit groups: p is taken while
      // dP is in flight
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      product_d128(sc, q_wg, kBlockHalf, ks);
      wgmma_commit();
      product_d128(dp, do_wg, kBlockHalf, vs);
      wgmma_commit();
      wgmma_wait1();
      fence_regs(sc);

      // x = 4 j + 2 i + e: row rl + 8 i, key k0 + 8 j + 2 quad + e. p
      // replaces sc in place. Rows grow, so row rl is the strictest test
      const bool whole = __all_sync(
          0xffffffffu, k0 + kTile <= fr[0] &&
                           (!a.causal || k0 + kTile - 1 <= qpos[0]));
      if (whole) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const float val =
              ok[2 * (x >> 2) + (x & 1)] ? sc[x] * scale : kNeg;
          sc[x] = exp2_approx((val - lse[(x >> 1) & 1]) * kLog2e);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1, e = x & 1, j = x >> 2;
          const int key = k0 + 8 * j + 2 * quad + e;
          const float val = gqa_key_ok(ok[2 * j + e], key, qpos[i], a.causal)
                                ? sc[x] * scale
                                : kNeg;
          sc[x] = key < fr[i] ? exp2_approx((val - lse[i]) * kLog2e) : 0.f;
        }
      }
      wgmma_wait0();
      fence_regs(dp);
      // ds replaces dp in place
#pragma unroll
      for (int x = 0; x < 32; ++x)
        dp[x] = sc[x] * (dp[x] - dlt[(x >> 1) & 1]) * scale;
      // ds in bf16 as the A operand: key slice kk is dp[8 kk .. 8 kk + 7]
      uint32_t da[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) da[x] = pack_bf16(dp[2 * x], dp[2 * x + 1]);

      // dQ += dS.K: K's 16-key steps 2 KB apart, its halves of D 8 KB apart
      wgmma_fence();
      fence_regs(dq);
      product_t64(dq, da, ks);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dq);
      mbar_arrive(bar_empty + 8 * st);
    }

    // dq[4 j + 2 i + e] is row rl + 8 i, column 8 j + 2 quad + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (gr[i] >= rows) continue;
      const int qi = gr[i] / a.g;
      const int head = hk * a.g + gr[i] % a.g;
      __nv_bfloat16* out =
          a.dq + ((static_cast<int64_t>(bi) * a.s + qi) * a.h + head) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * quad) =
            __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
  }
}

// --------------------------------------------------------------- dk/dv
__global__ void __launch_bounds__(kThreads, 1)
gqa_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // each stage's rows: lse at [0, 64), delta at [64, 128)
  __shared__ float rowstat[kStages][2 * kTile];
  // K halves at +0 and +16 KB, V halves at +32 KB and +48 KB; stage st
  // at 64 KB + st * 32 KB: Q halves at +0 and +8 KB, dO halves at +16 KB
  // and +24 KB
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + 2 * kBlockBytes;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hk = blockIdx.x, bi = blockIdx.z;
  const int rows = a.s * a.g;
  // the first key blocks take the most rows (causal): they start first
  const int k0 = blockIdx.y * kBlock;
  const int ntiles = (rows + kTile - 1) / kTile;
  // F grows with the row: skip the tiles whose last row's F does not
  // reach this block's first key
  int t0 = 0;
  while (t0 < ntiles &&
         row_frontier(a, (min((t0 + 1) * kTile, rows) - 1) / a.g) <= k0)
    ++t0;

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
    // writes lse and delta of two of the tile's rows and arrives
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int p = tid - kConsumers;
    if (p < 32) {
      if (p == 0) {
        mbar_expect_tx(bar_kv, 2 * kBlockBytes);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load(base + hf * kBlockHalf, &kmap, bar_kv, hf * kHalf, hk, k0,
                   bi);
          tma_load(base + kBlockBytes + hf * kBlockHalf, &vmap, bar_kv,
                   hf * kHalf, hk, k0, bi);
        }
      }
      const int64_t at = (static_cast<int64_t>(bi) * a.kvh + hk) * rows;
      for (int t = t0; t < ntiles; ++t) {
        const int u = t - t0, st = u % kStages;
        if (u >= kStages)
          mbar_wait(bar_empty + 8 * st, (u / kStages - 1) & 1);
        for (int r = p; r < kTile; r += 32) {
          const int row = t * kTile + r;
          rowstat[st][r] = row < rows ? a.lse[at + row] : 0.f;
          rowstat[st][kTile + r] = row < rows ? a.delta[at + row] : 0.f;
        }
        const uint32_t full = bar_full + 8 * st;
        if (p == 0) {
          const uint32_t dst = ring + st * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          for (int hf = 0; hf < 2; ++hf) {
            tma_load(dst + hf * kTileHalf, &qmap, full, hf * kHalf, hk * a.g,
                     t * kTile / a.g, bi);
            tma_load(dst + (2 + hf) * kTileHalf, &domap, full, hf * kHalf,
                     hk * a.g, t * kTile / a.g, bi);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    // consumers: warpgroup wg holds block keys 64 wg .. 64 wg + 63; a
    // thread holds keys kl and kl + 8, tile rows (columns) 8 j + 2 quad +
    // {0, 1}
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int kl = wg * 64 + warp * 16 + lane / 4;
    int key[2], kok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      key[i] = k0 + kl + 8 * i;
      kok[i] = a.kv_valid[static_cast<int64_t>(bi) * a.lk + key[i]];
    }
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_wg = base + wg * 64 * (kHalf * 2);
    const uint32_t v_wg = k_wg + kBlockBytes;
    const float scale = a.sm_scale;

    mbar_wait(bar_kv, 0);
    for (int t = t0; t < ntiles; ++t) {
      const int u = t - t0, st = u % kStages;
      const int row0 = t * kTile;
      const uint32_t qs = ring + st * kStageBytes;
      const uint32_t dos = qs + 2 * kTileHalf;
      mbar_wait(bar_full + 8 * st, (u / kStages) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T, two commit groups: P^T is taken
      // while dP^T is in flight, dS^T while dV's product is. The K and V
      // addresses are opaque to the compiler, so it builds their
      // descriptors per tile instead of holding 16 of them in registers
      uint32_t kb = k_wg, vb = v_wg;
      asm volatile("" : "+r"(kb), "+r"(vb));
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      wgmma_fence();
      fence_regs(sc);
      fence_regs(dp);
      product_d128(sc, kb, kBlockHalf, qs);
      wgmma_commit();
      product_d128(dp, vb, kBlockHalf, dos);
      wgmma_commit();
      wgmma_wait1();
      fence_regs(sc);

      // x = 4 j + 2 i + e: key key[i], row row0 + 8 j + 2 quad + e. p
      // replaces sc in place. Rows grow, so row0 is the strictest test
      // and key[1] the thread's last key
      const float* ls = rowstat[st];
      const float* ds = rowstat[st] + kTile;
      const int q0 = row0 / a.g;
      const bool whole = __all_sync(
          0xffffffffu,
          row0 + kTile <= rows && key[1] < row_frontier(a, q0) &&
              (!a.causal || key[1] <= a.off + q0));
      if (whole) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int c = 8 * (x >> 2) + 2 * quad + (x & 1);
          const float val = kok[(x >> 1) & 1] ? sc[x] * scale : kNeg;
          sc[x] = exp2_approx((val - ls[c]) * kLog2e);
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int i = (x >> 1) & 1, c = 8 * (x >> 2) + 2 * quad + (x & 1);
          const int row = row0 + c;
          const int qi = min(row, rows - 1) / a.g;
          const float val = gqa_key_ok(kok[i], key[i], a.off + qi, a.causal)
                                ? sc[x] * scale
                                : kNeg;
          sc[x] = row < rows && key[i] < row_frontier(a, qi)
                      ? exp2_approx((val - ls[c]) * kLog2e)
                      : 0.f;
        }
      }
      // P^T in bf16 as the A operand (row slice kk is x in [8 kk,
      // 8 kk + 8)); dV += P^T.dO, dO MN-major
      uint32_t pa[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
      wgmma_fence();
      fence_regs(dv);
      product_t64(dv, pa, dos);
      wgmma_commit();

      // dP^T done (dV's group may still run): dS^T replaces dp in place
      wgmma_wait1();
      fence_regs(dp);
      uint32_t da[16];
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int c = 8 * (x >> 1) + 2 * quad;
        da[x] = pack_bf16(sc[2 * x] * (dp[2 * x] - ds[c]) * scale,
                          sc[2 * x + 1] * (dp[2 * x + 1] - ds[c + 1]) * scale);
      }
      // dK += dS^T.Q, Q MN-major
      wgmma_fence();
      fence_regs(dk);
      product_t64(dk, da, qs);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(bar_empty + 8 * st);
    }

    // dk[4 j + 2 i + e] is key key[i], column 8 j + 2 quad + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t at =
          ((static_cast<int64_t>(bi) * a.lk + key[i]) * a.kvh + hk) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
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
// boxes of `box_rows` folded rows, k and v of `box_keys` keys. Returns 0
// or cudaErrorInvalidValue for input the kernels do not take.
int prepare(const void* q, const void* k, const void* v, const void* dout,
            int b, int s, int lk, int h, int kvh, int d, int causal, int bq,
            int bk, int box_rows, int box_keys, CUtensorMap* maps) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (d != kD || kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0 ||
      lk % kBlock != 0 || (causal && lk < s))
    return bad;
  const int g = h / kvh;
  if (box_rows % g != 0) return bad;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
      16 != 0)
    return bad;
  if (!make_map(&maps[0], q, b, s, h, kD, g, box_rows / g) ||
      !make_map(&maps[1], dout, b, s, h, kD, g, box_rows / g) ||
      !make_map(&maps[2], k, b, lk, kvh, kD, 1, box_keys) ||
      !make_map(&maps[3], v, b, lk, kvh, kD, 1, box_keys))
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

// K2-bwd-dq in bf16. q, dout, dq (B, S, H, D) bf16; k, v (B, Lk, KVH, D)
// bf16; D = 128, G = H / KVH dividing 128, Lk a multiple of 128, q, k, v
// and dout 16-byte aligned (TMA); kv_valid (B, Lk) int32; lse, delta
// (B, KVH, S * G) f32. bq, bk: the Pallas kernel's query and key blocks,
// which fix each row's frontier. Launches on `stream`; returns
// cudaGetLastError() (0 = ok), cudaErrorInvalidValue for input it does
// not take.
extern "C" int gqa_flash_bwd_dq_sm90(const void* q, const void* k,
                                     const void* v, const int* kv_valid,
                                     const void* dout, const float* lse,
                                     const float* delta, void* dq, int b,
                                     int s, int lk, int h, int kvh, int d,
                                     int causal, int bq, int bk,
                                     float sm_scale, void* stream) {
  CUtensorMap maps[4];
  int err = prepare(q, k, v, dout, b, s, lk, h, kvh, d, causal, bq, bk,
                    kBlock, kTile, maps);
  static bool configured = false;
  if (err == 0) err = configure(gqa_bwd_dq_sm90_kernel, &configured);
  if (err != 0) return err;
  const int g = h / kvh;
  Params p{kv_valid, lse, delta, static_cast<__nv_bfloat16*>(dq), nullptr,
           nullptr, s, lk, h, kvh, g, causal, causal ? lk - s : 0, bq, bk,
           sm_scale};
  dim3 grid(kvh, (s * g + kBlock - 1) / kBlock, b);
  gqa_bwd_dq_sm90_kernel<<<grid, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// K2-bwd-dkdv in bf16. As gqa_flash_bwd_dq_sm90, with G dividing 64; dk,
// dv (B, Lk, KVH, D) bf16.
extern "C" int gqa_flash_bwd_dkdv_sm90(const void* q, const void* k,
                                       const void* v, const int* kv_valid,
                                       const void* dout, const float* lse,
                                       const float* delta, void* dk,
                                       void* dv, int b, int s, int lk, int h,
                                       int kvh, int d, int causal, int bq,
                                       int bk, float sm_scale, void* stream) {
  CUtensorMap maps[4];
  int err = prepare(q, k, v, dout, b, s, lk, h, kvh, d, causal, bq, bk,
                    kTile, kBlock, maps);
  static bool configured = false;
  if (err == 0) err = configure(gqa_bwd_dkdv_sm90_kernel, &configured);
  if (err != 0) return err;
  Params p{kv_valid, lse, delta, nullptr, static_cast<__nv_bfloat16*>(dk),
           static_cast<__nv_bfloat16*>(dv), s, lk, h, kvh, h / kvh, causal,
           causal ? lk - s : 0, bq, bk, sm_scale};
  dim3 grid(kvh, lk / kBlock, b);
  gqa_bwd_dkdv_sm90_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}
