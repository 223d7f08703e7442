// K3's forward in bf16 for Hopper (sm_90a): wgmma tiles fed by a TMA
// ring, at D = 64, with segment ids.
//
// Replaces the stock Pallas TPU flash attention forward
// (jax/experimental/pallas/ops/tpu/flash_attention.py, `pallas_call`
// :758), which the Qwen3-VL ViT reaches through
// wedetect_tpu/ops/attention.py:_flash_attention, for bf16 inputs at
// D = 64; f32 inputs and bf16 at D = 128 or 256 take the SIMT template
// of csrc/flash_attn.cu (ops/flash_attention.py:fwd_route). The contract
// is ops/flash_attention.py:flash_attention_plain's: q, k, v and O
// (B, L, H, 64) bf16 read and written in place; segment ids (B, L)
// int32 for the queries and the keys, or none (one segment). Logits
// q.k * scale in f32; a key whose segment differs from the query's has
// logit -1e30 (replaced, not added); with `causal`, keys after the query
// are absent (weight 0), as are keys at or past L. f32 online softmax,
// exp(x - m) as 2^((x - m) log2 e), the subtraction first, so at the
// -1e30 fill of a row that sees no key of its own segment x - m is
// exactly 0 and p = 1, as in the stock kernel; p rounded to bf16 before
// p.V, l summing the unrounded p; O in bf16 and lse = m + log(l) in f32,
// (B, H, L).
//
// Bound on the H100: 4 * H * D FLOPs per visible (query, key) pair at
// 989 TFLOP/s bf16, against q, k, v read once and O and lse written once
// at 3.35 TB/s. At the ViT's shape (1, 1280, 16, 64) with 80 pad tokens
// the FLOPs bound it: 0.006 ms. At D = 64 the softmax costs about as
// much as the products (one 2^x on the special-function unit, 16 a
// clock per SM, per 256 tensor-core FLOPs), so a block's time goes to
// both.
//
// Design (csrc/flash_gqa_sm90.cu's, with G = 1, D = 64 and segment ids
// as in csrc/flash_attn_bwd_sm90.cu). A block holds kRows = 64 *
// kWarpgroups query rows of one (batch, head): kWarpgroups consumer
// warpgroups of 64 rows and one producer warp; grid (H, ceil(L /
// kRows), B), the last row blocks (the longest key walks when causal)
// launched first. The producer loads the Q tile once (one box of the
// map (64, H, L, B)) and streams 64-key tiles of K and V through a ring
// of kStages stages (at D = 64 a tile row is one 128-byte swizzled
// line, so a tile is one 8 KB box), signalled by mbarriers; its lanes
// write each tile's 64 key ids beside the boxes with a flag saying
// whether they are one value, released by the same mbarrier. Each
// consumer warpgroup computes S = Q.K^T on wgmma_qk (m64n64k16, both
// operands K-major), masks and softmaxes the accumulator fragment in
// registers (a thread holds rows lane / 4 and lane / 4 + 8 of its
// warp's 16; the row max reduces over the quad, the row sum once at
// the end), rounds p to bf16 pairs in place as the A operand, and adds
// P.V on wgmma_pv64 (m64n64k16, A from registers, V MN-major through
// the transpose bit). The previous tile's P.V is issued behind this
// tile's S, so its product runs while this tile's exponentials do; O
// is rescaled once it has landed. The first tile is peeled off, so no
// wgmma is issued under a branch, and every commit group is retired
// within its tile (ptxas serialises the wgmmas otherwise: C7511,
// C7515). Small blocks at several a SM fill the card at the ViT's 16
// heads: see kWarpgroups.
//
// Masks. A tile whose 64 ids are one value, equal to every id of the
// warp's 16 rows, with every key below L and, when causal, visible to
// every row, is only scaled; the test is uniform over the warp. Other
// tiles take the per-element select. TMA zero-fills rows and keys past
// L: such keys are absent (a zero K row would give logit 0), such rows
// are computed like the last row's segment and never stored. No tile is
// skipped by segment: p there is exp(-1e30 - m), 0 only for rows that
// see some key of their own segment.

#include <math_constants.h>

#include <type_traits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

// one consumer warpgroup (64 query rows) a block, at three blocks an SM,
// and a ring of four stages: the fastest shape on the H100 (PERF.md
// section 6: two warpgroups spill at two blocks an SM; three make 112
// blocks at the ViT's shape, 20 SMs idle; three stages time the same
// within the spread)
constexpr int kWarpgroups = 1;
constexpr int kStages = 4;
constexpr int kMinBlocks = 3;  // blocks an SM: it caps the registers
constexpr int kTile = 64;                       // keys per ring tile
constexpr int kTileBytes = kTile * kHalf * 2;   // 8 KB: one 64 x 64 box
constexpr int kStageBytes = 2 * kTileBytes;     // K then V
constexpr int kRows = 64 * kWarpgroups;         // query rows a block
constexpr int kQBytes = kRows * kHalf * 2;
constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;       // and one producer warp
constexpr int kIds = kTile + 2;  // a stage's ids, then "one value", pad

struct Params {
  const int* q_seg;   // (B, L), or null: one segment
  const int* kv_seg;  // (B, L), or null
  __nv_bfloat16* o;
  float* lse;         // (B, H, L)
  int l, h, causal;
  float sm_scale;
};

// segment id of position i < L of batch row bi (0 without ids)
__device__ __forceinline__ int seg_id(const int* seg, int l, int bi, int i) {
  return seg ? seg[static_cast<int64_t>(bi) * l + i] : 0;
}

// The producer warp's ids of a ring stage: keys [k0, k0 + 64) (past L,
// the last key's), then whether all 64 are one value
__device__ __forceinline__ void tile_ids(int* ids, const int* seg, int l,
                                         int bi, int k0, int lane) {
  const int lo = seg_id(seg, l, bi, min(k0 + lane, l - 1));
  const int hi = seg_id(seg, l, bi, min(k0 + 32 + lane, l - 1));
  ids[lane] = lo;
  ids[32 + lane] = hi;
  const int first = __shfl_sync(0xffffffffu, lo, 0);
  const bool one = __all_sync(0xffffffffu, lo == first && hi == first);
  if (lane == 0) ids[kTile] = one;
}

// s (64 x 64) += Q (64 rows at q0, K-major) . K^T (64 keys at k0,
// K-major) over D = 64: 4 steps of 16
__device__ __forceinline__ void product_qk(float (&s)[32], uint32_t q0,
                                           uint32_t k0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_qk(s, desc_sw128(q0 + kk * 32, 16, 1024),
             desc_sw128(k0 + kk * 32, 16, 1024));
}

// o (64 x 64) += P (bf16 pairs in registers, 64 x 64) . V (64 keys at
// v0, MN-major: 16-key steps 2 KB apart)
__device__ __forceinline__ void product_pv(float (&o)[32],
                                           const uint32_t (&p)[16],
                                           uint32_t v0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_pv64(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               desc_sw128(v0 + kk * 16 * (kHalf * 2), kTileBytes, 1024));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  __shared__ __align__(8) int kv_ids[kStages][kIds];
  // Q at +0 (64 rows = 8 KB a warpgroup); stage st at kQBytes + st *
  // 16 KB: K at +0, V at +8 KB (1024-aligned: the swizzle atoms)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + kQBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hd = blockIdx.x, bi = blockIdx.z;
  // the last row blocks scan the most keys (causal): they start first
  const int row0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int last = min(row0 + kRows, a.l) - 1;
  const int ntiles = ((a.causal ? last + 1 : a.l) + kTile - 1) / kTile;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: lane 0 issues the loads, every lane writes two
    // of the tile's key ids and arrives
    const int p = tid - kConsumers;
    if (p == 0) {
      mbar_expect_tx(bar_q, kQBytes);
      tma_load(base, &qmap, bar_q, 0, hd, row0, bi);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      if (t >= kStages)
        mbar_wait(bar_empty + 8 * st, (t / kStages - 1) & 1);
      tile_ids(kv_ids[st], a.kv_seg, a.l, bi, t * kTile, p);
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
    return;
  }

  // consumers: warpgroup wg holds block rows 64 wg .. 64 wg + 63; a
  // thread holds rows gr[0] and gr[1] = gr[0] + 8, keys (columns)
  // 8 j + 2 quad + {0, 1}
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int wrow = row0 + wg * 64 + warp * 16;  // the warp's first row
  int gr[2], qs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gr[i] = wrow + lane / 4 + 8 * i;
    // rows past L are zeros, computed like the last row, never stored
    qs[i] = seg_id(a.q_seg, a.l, bi, min(gr[i], a.l - 1));
  }
  // whether the warp's 16 rows are all of one segment
  const int wseg = __shfl_sync(0xffffffffu, qs[0], 0);
  const bool wone = __all_sync(0xffffffffu, qs[0] == wseg && qs[1] == wseg);
  // m: the row max (natural units); l: this thread's share of the row
  // sum, over its 16 keys a tile (the quad's shares add up at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  const uint32_t q_wg = base + wg * 64 * (kHalf * 2);
  const float scale = a.sm_scale;
  const float scale2 = scale * kLog2e;

  // P of the previous tile in bf16, the A operand of its P.V: key slice
  // kk is pa[4 kk .. 4 kk + 3]
  uint32_t pa[16];
  // one tile; `first` (std::true_type for tile 0) drops the previous
  // tile's product, so no wgmma is issued under a branch
  auto tile = [&](int t, auto first) {
    constexpr bool kFirst = decltype(first)::value;
    const int st = t % kStages;
    const int k0 = t * kTile;
    mbar_wait(bar_full + 8 * st, (t / kStages) & 1);

    // S = Q.K^T, then the previous tile's O += P.V (V 8 KB into its
    // stage): two commit groups, so the exponentials run while P.V is
    // in flight
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
    fence_regs(o);
    product_qk(sc, q_wg, ring + st * kStageBytes);
    wgmma_commit();
    if constexpr (!kFirst) {
      product_pv(o, pa,
                 ring + ((t - 1) % kStages) * kStageBytes + kTileBytes);
      wgmma_commit();
      wgmma_wait1();
    } else {
      wgmma_wait0();
    }
    fence_regs(sc);

    // logits: sc[4 j + 2 i + e] is row gr[i], key k0 + 8 j + 2 quad + e.
    // A whole tile keeps the raw products (scale > 0 keeps their order);
    // the others hold the scaled logits with the fills
    const int* ids = kv_ids[st];
    const bool whole = wone && ids[kTile] && ids[0] == wseg &&
                       k0 + kTile <= a.l &&
                       (!a.causal || k0 + kTile - 1 <= wrow) && scale > 0.f;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (whole) {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
      mx[0] *= scale;
      mx[1] *= scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 kid =
            *reinterpret_cast<const int2*>(ids + 8 * j + 2 * quad);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * j + 2 * i + e;
            const int key = k0 + 8 * j + 2 * quad + e;
            float val = qs[i] == (e ? kid.y : kid.x) ? sc[x] * scale : kNeg;
            val = key < a.l && (!a.causal || key <= gr[i]) ? val
                                                           : -CUDART_INF_F;
            sc[x] = val;
            mx[i] = fmaxf(mx[i], val);
          }
      }
    }
    // online softmax; the quad holds a row. exp(x - m) as
    // 2^((x - m) log2 e): x - m is exact at the -1e30 fill (0, so p = 1);
    // a whole tile has no fill and takes 2^(s scale log2 e - m log2 e) in
    // one FMA
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    if (whole) {
      const float mb[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        sc[x] = exp2_approx(fmaf(sc[x], scale2, -mb[(x >> 1) & 1]));
        l[(x >> 1) & 1] += sc[x];
      }
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        sc[x] = exp2_approx((sc[x] - m[(x >> 1) & 1]) * kLog2e);
        l[(x >> 1) & 1] += sc[x];
      }
    }

    if constexpr (!kFirst) {
      // the previous tile's P.V has landed: its stage goes back
      wgmma_wait0();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * ((t - 1) % kStages));
    }
    // rescale O unless no row of the warp moved its max
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
    }
    // p in bf16 as the A operand: key slice kk is accumulator columns
    // 16 kk .. 16 kk + 15, i.e. sc[8 kk .. 8 kk + 7] in A's order
#pragma unroll
    for (int x = 0; x < 16; ++x) pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);
  };

  mbar_wait(bar_q, 0);
  tile(0, std::true_type{});
  for (int t = 1; t < ntiles; ++t) tile(t, std::false_type{});
  // the last tile's P.V
  wgmma_fence();
  fence_regs(o);
  product_pv(o, pa,
             ring + ((ntiles - 1) % kStages) * kStageBytes + kTileBytes);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(o);

  // the row sums over the quad; o[4 j + 2 i + e] is row gr[i], column
  // 8 j + 2 quad + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (gr[i] >= a.l) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    const float inv = l[i] > 0.f ? 1.f / safe_l : 0.f;
    __nv_bfloat16* out =
        a.o + ((static_cast<int64_t>(bi) * a.l + gr[i]) * a.h + hd) * kHalf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
    if (quad == 0)
      a.lse[(static_cast<int64_t>(bi) * a.h + hd) * a.l + gr[i]] =
          m[i] + logf(safe_l);
  }
}

// the kernel's dynamic shared memory, set once: 0 or the CUDA error
int configure() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

}  // namespace

// K3 in bf16 at D = 64. q, k, v, o (B, L, H, 64) bf16, each 16-byte
// aligned (TMA); q_seg, kv_seg (B, L) int32 or both null (one segment);
// lse (B, H, L) f32. Launches on `stream`; returns cudaGetLastError()
// (0 = ok), cudaErrorInvalidValue for input it does not take.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, const int* q_seg,
                                        const int* kv_seg, void* o,
                                        float* lse, int b, int l, int h,
                                        int d, int causal, float sm_scale,
                                        void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || l <= 0 || h <= 0 || d != kHalf) return bad;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16 != 0)
    return bad;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, b, l, h, kHalf, 1, kRows) ||
      !make_map(&kmap, k, b, l, h, kHalf, 1, kTile) ||
      !make_map(&vmap, v, b, l, h, kHalf, 1, kTile))
    return bad;
  const int err = configure();
  if (err != 0) return err;
  Params p{q_seg, kv_seg, static_cast<__nv_bfloat16*>(o), lse, l, h, causal,
           sm_scale};
  dim3 grid(h, (l + kRows - 1) / kRows, b);
  fa_fwd_sm90_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(qmap, kmap, vmap,
                                                            p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks of the kernel an SM holds, from the CUDA occupancy
// calculator on the compiled kernel's registers and shared memory, into
// *n; returns 0 or the CUDA error.
extern "C" int flash_attention_fwd_sm90_blocks_per_sm(int* n) {
  const int err = configure();
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, fa_fwd_sm90_kernel, kThreads, kSmemBytes));
}
