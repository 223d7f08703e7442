// K2's forward in bf16 for Hopper (sm_90a): wgmma tiles fed by a TMA
// ring.
//
// Replaces wedetect_tpu/ops/flash_gqa.py:_fwd_kernel (the Pallas TPU
// kernel behind gqa_flash_attention, `pallas_call` at :145) for bf16
// inputs; f32 inputs take csrc/flash_attn.cu:gqa_flash_fwd. It computes
// the function of ops/flash_gqa.py:gqa_flash_attention_plain: q, o
// (B, S, H, D) and k, v (B, Lk, KVH, D) read and written in place,
// D = 128; the G = H / KVH query heads of a kv head fold into the row
// axis (folded row r is query r / G, head kvh * G + r % G); end-aligned
// rectangular causal (query i at key Lk - S + i); each row scans keys
// [0, F) with the Pallas kernel's frontier F and -1e30 for a masked key
// below F (flash_common.cuh); f32 logits and online softmax; p rounded
// to bf16 before p.V, l summing the unrounded p; O in bf16 (0 where
// l = 0) and lse = m + log(l) in f32, (B, KVH, S * G) folded order.
//
// Bound on the H100: 4 * H * D FLOPs per visible (query, key) pair at
// 989 TFLOP/s bf16, against q, k, v read once and O and lse written
// once at 3.35 TB/s. At the Ref suffix shape (8, 256, 16, 128 | 640, 8)
// the bytes bound it: 0.0113 ms (the FLOPs 0.0083 ms).
//
// Design. The products run on the tensor cores and the loads on the
// TMA, so the SMs' own issue slots go to the softmax alone. A block
// holds 128 folded rows of one (batch, kv head): two consumer
// warpgroups of 64 rows and one producer warp (288 threads); the grid
// is (ceil(S * G / 128), KVH, B). The producer loads the Q tile once
// (a (64, G, 128 / G, 1) box of the 4-D map (D, H, S, B), rows past S
// filled with zeros) and streams K and V through a 2-stage ring of
// 64-key tiles (boxes (64, 1, 64, 1) of the maps (D, KVH, Lk, B), two
// per tile and tensor since a 128-byte swizzled box is 64 bf16 wide),
// signalled by mbarriers. Each consumer warpgroup computes S = Q.K^T
// with wgmma.m64n64k16 (K is the K-major B operand), masks and
// softmaxes the accumulator fragment in registers (a thread holds rows
// lane / 4 and lane / 4 + 8 of its warp's 16; row max and sum reduce
// over the quad), rounds p to bf16 in place as the A operand, and adds
// P.V with wgmma.m64n128k16 (A from registers, V MN-major from shared
// memory via the transpose bit). The key loop runs to the largest F
// among the block's rows, 64 keys a tile (64 divides every JAX bk, so
// F never splits a tile). Shared memory: Q 32 KB + 2 x (K 16 KB +
// V 16 KB). Not yet: ping-pong between the warpgroups, softmax
// overlapped with the next product, persistent blocks, clusters. The
// mbarrier, TMA and wgmma helpers are csrc/sm90_common.cuh's.

#include <math_constants.h>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kRows = 128;                 // folded rows per block
constexpr int kKeys = 64;                  // keys per ring tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kQHalf = kRows * kHalf * 2;  // 16 KB: Q, 64 of D
constexpr int kKVHalf = kKeys * kHalf * 2; // 8 KB: K or V tile, 64 of D
constexpr int kQBytes = 2 * kQHalf;
constexpr int kStageBytes = 4 * kKVHalf;   // K then V, two halves each
constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + 1024;

struct Params {
  const int* kv_valid;  // (B, Lk) 0/1
  __nv_bfloat16* o;
  float* lse;
  int s, lk, h, kvh, g, causal, off, bq, bk;
  float sm_scale;
};

__global__ void __launch_bounds__(kThreads, 1)
gqa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const Params a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // Q halves at +0 and +16 KB; stage st at kQBytes + st * 32 KB: K
  // halves at +0 and +8 KB, V halves at +16 KB and +24 KB (1024-aligned:
  // the swizzle atoms)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);              // + 8 st
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);   // + 8 st

  const int tid = threadIdx.x;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int rows = a.s * a.g;
  const int row0 = blockIdx.x * kRows;
  // F grows with the row: the block's key loop ends at its last live row's
  const int last = min(row0 + kRows, rows) - 1;
  const int fmax =
      a.causal ? gqa_frontier(last / a.g, a.lk, a.off, a.bq, a.bk) : a.lk;
  const int ntiles = (fmax + kKeys - 1) / kKeys;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: one thread issues every load
    if (tid == kConsumers) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int hf = 0; hf < 2; ++hf)
        tma_load(base + hf * kQHalf, &qmap, bar_q, hf * kHalf, hk * a.g,
                 row0 / a.g, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * st, (t / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t dst = base + kQBytes + st * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        for (int hf = 0; hf < 2; ++hf) {
          tma_load(dst + hf * kKVHalf, &kmap, full, hf * kHalf, hk,
                   t * kKeys, bi);
          tma_load(dst + (2 + hf) * kKVHalf, &vmap, full, hf * kHalf, hk,
                   t * kKeys, bi);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg holds block rows 64 wg .. 64 wg + 63; a
  // thread holds rows rl and rl + 8, keys (columns) 8 j + 2 quad + {0, 1}
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int rl = wg * 64 + warp * 16 + lane / 4;
  int gr[2], qpos[2], fr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    gr[i] = row0 + rl + 8 * i;
    // rows past S * G are zeros, computed like the last row, never stored
    const int qi = min(gr[i], rows - 1) / a.g;
    qpos[i] = a.off + qi;
    fr[i] = a.causal ? gqa_frontier(qi, a.lk, a.off, a.bq, a.bk) : a.lk;
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  const int* valid = a.kv_valid + static_cast<int64_t>(bi) * a.lk;
  const uint32_t q_wg = base + wg * 64 * (kHalf * 2);

  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    const int k0 = t * kKeys;
    const uint32_t ks = base + kQBytes + st * kStageBytes;
    const uint32_t vs = ks + 2 * kKVHalf;
    int ok[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ok[2 * j] = valid[k0 + 8 * j + 2 * quad];
      ok[2 * j + 1] = valid[k0 + 8 * j + 2 * quad + 1];
    }
    mbar_wait(bar_full + 8 * st, (t / kStages) & 1);

    // S = Q . K^T over D = 128: 8 steps of 16, 4 in each 64-wide half
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t step = (kk & 3) * 32;
      wgmma_qk(sc, desc_sw128(q_wg + (kk >> 2) * kQHalf + step, 16, 1024),
               desc_sw128(ks + (kk >> 2) * kKVHalf + step, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // logits: sc[4 j + 2 i + e] is row rl + 8 i, key k0 + 8 j + 2 quad +
    // e. A tile the warp's rows see whole (every key valid, causally
    // earlier and below F; rows grow, so row rl is the strictest) is
    // only scaled; the branch is uniform over the warp
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    int all_ok = 1;
#pragma unroll
    for (int x = 0; x < 16; ++x) all_ok &= ok[x] != 0;
    const bool whole = __all_sync(
        0xffffffffu, all_ok && k0 + kKeys <= fr[0] &&
                         (!a.causal || k0 + kKeys - 1 <= qpos[0]));
    if (whole) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        sc[x] *= a.sm_scale;
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = x >> 1, e = x & 1;
          const int key = k0 + 8 * j + 2 * quad + e;
          float val = gqa_key_ok(ok[2 * j + e], key, qpos[i], a.causal)
                          ? sc[4 * j + x] * a.sm_scale
                          : kNeg;
          val = key < fr[i] ? val : -CUDART_INF_F;
          sc[4 * j + x] = val;
          mx[i] = fmaxf(mx[i], val);
        }
      }
    }
    // online softmax; the quad holds a row. exp(x - m) as
    // 2^((x - m) log2 e): x - m is exact at the -1e30 fill (0, so p = 1)
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2_approx((m[i] - m_new) * kLog2e);
      m[i] = m_new;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float p = exp2_approx((sc[x] - m[(x >> 1) & 1]) * kLog2e);
      sc[x] = p;
      sum[(x >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
    // rescale O unless no row of the warp moved its max
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int x = 0; x < 64; ++x) o[x] *= alpha[(x >> 1) & 1];
    }
    // p in bf16 as the A operand: key slice kk is accumulator columns
    // 16 kk .. 16 kk + 15, i.e. sc[8 kk .. 8 kk + 7] in A's order
    uint32_t pa[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) pa[x] = pack_bf16(sc[2 * x], sc[2 * x + 1]);

    // O += P . V: 4 steps of 16 keys; V's 8-key groups 1024 B apart, its
    // two 64-wide halves of D 8 KB apart
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               desc_sw128(vs + kk * 16 * (kHalf * 2), kKVHalf, 1024));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * st);
  }

  // o[4 j + 2 i + e] is row rl + 8 i, column 8 j + 2 quad + e
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (gr[i] >= rows) continue;
    const float li = l[i];
    const float safe_l = li > 0.f ? li : 1.f;
    const int qi = gr[i] / a.g;
    const int head = hk * a.g + gr[i] % a.g;
    __nv_bfloat16* orow =
        a.o + ((static_cast<int64_t>(bi) * a.s + qi) * a.h + head) * kD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v0 = li > 0.f ? o[4 * j + 2 * i] / safe_l : 0.f;
      const float v1 = li > 0.f ? o[4 * j + 2 * i + 1] / safe_l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * quad) =
          __floats2bfloat162_rn(v0, v1);
    }
    if (quad == 0)
      a.lse[(static_cast<int64_t>(bi) * a.kvh + hk) * rows + gr[i]] =
          m[i] + logf(safe_l);
  }
}

}  // namespace

// K2 in bf16. q, o (B, S, H, D) bf16; k, v (B, Lk, KVH, D) bf16; D = 128,
// G = H / KVH dividing 128, Lk a multiple of 64, q, k, v and o 16-byte
// aligned (TMA); kv_valid (B, Lk) int32; lse (B, KVH, S * G) f32. bq,
// bk: the Pallas kernel's query and key blocks. Launches on `stream`;
// returns cudaGetLastError() (0 = ok), cudaErrorInvalidValue for input
// it does not take.
extern "C" int gqa_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                  const int* kv_valid, void* o, float* lse,
                                  int b, int s, int lk, int h, int kvh, int d,
                                  int causal, int bq, int bk, float sm_scale,
                                  void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (d != kD || kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0 ||
      lk % kKeys != 0 || (causal && lk < s))
    return bad;
  const int g = h / kvh;
  if (kRows % g != 0) return bad;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16 != 0)
    return bad;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, b, s, h, kD, g, kRows / g) ||
      !make_map(&kmap, k, b, lk, kvh, kD, 1, kKeys) ||
      !make_map(&vmap, v, b, lk, kvh, kD, 1, kKeys))
    return bad;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gqa_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Params p{kv_valid, static_cast<__nv_bfloat16*>(o), lse, s, lk, h, kvh, g,
           causal, causal ? lk - s : 0, bq, bk, sm_scale};
  dim3 grid((s * g + kRows - 1) / kRows, kvh, b);
  gqa_fwd_sm90_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(qmap, kmap, vmap,
                                                             p);
  return static_cast<int>(cudaGetLastError());
}
