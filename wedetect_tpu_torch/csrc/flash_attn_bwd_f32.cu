// K3's backward in f32 for Hopper (sm_90a): register tiles on FFMA fed
// by 128-bit shared-memory loads and a cp.async ring. Kernels
// K3-bwd-dkv and K3-bwd-dq, f32 at D = 64 (the Qwen3-VL ViT's head dim).
//
// Replace the stock Pallas TPU kernels _flash_attention_dkv_kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:796, `pallas_call`
// at :1121) and _flash_attention_dq_kernel (:1146, `pallas_call` at
// :1456), the custom VJP of the flash attention that
// wedetect_tpu/ops/attention.py:_flash_attention calls, for f32 inputs at
// D = 64 (ops/flash_attention.py:dkv_route, :dq_route). Other head dims
// stay on the SIMT kernels of csrc/flash_attn_bwd.cu, bf16 at D = 64 on
// csrc/flash_attn_bwd_sm90.cu. The contract is theirs
// (ops/flash_attention.py:flash_attention_bwd_plain): q, k, v, dO, dq,
// dk, dv (B, L, H, D) read and written in place; lse and delta =
// rowsum(dO * O) f32 (B, H, L); optional segment ids (B, L) for the rows
// and the keys. Row r sees keys [0, F_r) with F_r = r + 1 under `causal`,
// else L; a key of another segment has logit -1e30. p = exp(s - lse) with
// s = q.k * scale (or -1e30) on keys below F_r and 0 past it; ds = p *
// (dO.V^T - delta) * scale; dv = sum p^T.dO, dk = sum ds^T.Q over the
// rows, dq = sum ds.K over the keys, all in f32. A block owns its outputs
// (dk/dv: its keys; dq: its rows): no atomics, and every gradient
// repeats bit for bit.
//
// Bound on the H100: 8 * D (dk/dv) and 6 * D (dq) FLOPs per visible
// (row, key) pair and head at 67 TFLOP/s f32 (FFMA; no TF32, so the f32
// limits hold), against q, k, v, dO, lse and delta read once and the
// gradients written once at 3.35 TB/s. At the training path's ViT shape
// (1, 4224, 16, 64), 4144 real tokens and 80 pad tokens in segment 0,
// the FLOPs bound both: 2.100 ms (dk/dv), 1.575 ms (dq).
//
// The skip rule both kernels walk by (ops/flash_attention.py:
// dkv_tile_walked): a (row tile, key tile) pair is walked when some row
// of it lies below L (and, under causal, at or after the key tile's first
// key) and either shares its segment with a key of the tile below L
// (causal: one at or before the row) or has lse <= -1e29. Any other pair
// has p = 0 (past F_r) or p = exp(-1e30 - lse) = +0, and ds = +-0, so it
// changes no gradient; a row with lse <= -1e29 (no key of its segment:
// p = 1 on every key below F_r) keeps its tiles. The kernel reads the
// resident side (dk/dv: the block's keys; dq: the block's rows) once as
// runs of one segment id (segments.cuh:segment_runs, shared with K3's
// f32 forward), and one warp tests each tile
// of the other side against them with a ballot before the walk. With a
// non-null `walked`, each block also writes how many tiles it walked (a
// check of the rule; null on the main path).
//
// K3-bwd-dkv. A block owns 128 keys of one (batch, head) and walks the
// rows in tiles of 64; 256 threads, one block an SM.
// - Operands. K, V (128 keys) and each row tile's Q, dO are staged
//   row-major with D contiguous at a pitch of 68 floats: a multiple of 4,
//   so every operand is one LDS.128, and 4 banks apart from row to row,
//   so eight threads on eight consecutive rows read 32 distinct banks.
//   S = Q.K^T runs on warps 0-3 and dP = dO.V^T on warps 4-7, each over
//   all of D; a thread holds an 8 x 8 tile (rows ry + 8 i, keys
//   kx + 16 j): per 4 of D, 16 LDS.128 for 256 FFMA. S and dP go to
//   shared memory ([row][key], pitch 144: the two rows a warp writes are
//   16 banks apart), and all 256 threads then turn 32 elements each into
//   p and ds in place (eight rows, four consecutive keys), the
//   exponential on the MUFU unit alone (flash_common.cuh:exp2_approx).
//   dV += P^T.dO runs on warps 0-3 and dK += dS^T.Q on warps 4-7, a
//   thread 8 consecutive keys x 8 of D (two runs of 4, 32 apart), kept
//   in registers for the whole walk: per row, 4 LDS.128 for 64 FFMA. The
//   S / dP loop is unrolled by 8 of its 16 steps, the dV / dK loop by 16
//   of its 64 rows; 254 registers, no spills.
// - Ring. While a tile's products run, cp.async copies the next walked
//   tile's Q and dO (256-byte rows in 16-byte chunks, rows past L
//   zero-filled) and its lse, delta and segment ids (4-byte copies) into
//   the other of two stages. Shared memory, in floats: K and V
//   2 x 128 x 68 = 17408 (69.6 KB), Q and dO 2 stages x 2 x 64 x 68 =
//   17408 (69.6 KB), S / p and dP / ds 2 x 64 x 144 = 18432 (73.7 KB),
//   row data 2 x 3 x 64 = 384 (1.5 KB); 214.5 KB, plus one byte a row tile
//   for the walk.
// - The walk: the row tiles the rule keeps for the block's keys; a block
//   that walks nothing writes zeros. At the training shape the rule skips
//   the pad rows' tile for every block of real keys only: 2146 of 2178
//   tiles a head are walked.
// - Grid (B * H, ceil(L / 128)): 528 blocks at the training shape, four
//   waves of 132. With 64 keys a block (8 x 4 tiles, 1056 blocks: 10.7
//   FFMA a load, and twice the row-tile passes) the kernel took 8% longer
//   (PERF.md §6, tools/time_k3_bwd.py --variant).
//
// K3-bwd-dq: the same loops with rows and keys swapped. A block owns
// kQR = 128 rows of one (batch, head) and walks the keys in tiles of
// kQK = 64; 256 threads, one block an SM.
// - Operands. Q and dO (the block's rows, resident) and each key tile's K
//   and V at pitch 68 as above. S = Q.K^T on warps 0-3 and dP = dO.V^T on
//   warps 4-7 over all of D, a thread's 8 x 8 tile at rows y + 16 i, keys
//   x + 8 j (x = u % 8, y = u / 8 for thread u of the half): per 4 of D,
//   16 LDS.128 for 256 FFMA. S and dP go to shared memory ([row][key],
//   pitch 72: the four rows a warp writes are 8 banks apart), and all
//   256 threads then turn 32 elements each (eight rows, four consecutive
//   keys) into ds in place of dP, the exponential on exp2_approx.
//   dQ += dS.K splits the tile's keys into two groups of 32, one a half
//   of the block; each thread of a group holds an 8 x 8 tile of dQ (rows
//   y + 16 i, D columns 4 x + c and 32 + 4 x + c) for the whole walk: per
//   4 keys, 8 LDS.128 of ds (row-major: 4 keys a load) and 8 of K for
//   256 FFMA. At the end the groups' sums meet in shared memory (the
//   ring, free by then) and are added in group order, so dq repeats bit
//   for bit. The S / dP loop is unrolled by 8 of its 16 steps, the dQ
//   loop by 4 of its 8; 253 registers, no spills. Probes in turns with
//   this kernel (PERF.md §6, tools/time_k3_bwd.py --kernel dq
//   --variant): 64-row blocks (kQR = 64: 4 x 8 tiles, 10.7 FFMA a load,
//   twice the blocks) took 18% longer, dQ split by D instead of keys
//   (8 x 4 tiles, no final sum) 3% longer, the dQ loop unrolled by 2 of
//   8 steps 1% longer; three stages need 250.9 KB, over a block's 227.
// - Ring. While a tile's products run, cp.async copies the next walked
//   key tile's K and V (256-byte rows in 16-byte chunks, keys past L
//   zero-filled) and its segment ids into the other of two stages.
//   Shared memory, in floats: Q and dO 2 x 128 x 68 = 17408 (69.6 KB), K
//   and V 2 stages x 2 x 64 x 68 = 17408 (69.6 KB), S and dP / ds
//   2 x 128 x 72 = 18432 (73.7 KB), the rows' lse, delta and segment ids
//   3 x 128, the keys' segment ids 2 x 64, the row runs 2 x 128 and the
//   ballots 8 (3.1 KB); 216.1 KB, plus one byte a key tile for the walk.
// - The walk: the key tiles the rule keeps for the block's rows, in
//   order; inside a walked tile p is still 0 past each row's own F_r. At
//   the training shape the rule skips the pad keys' tile for every block
//   of real rows only: 32 x 65 + 66 = 2146 of the 2178 tiles a head.
// - Order. Grid (B * H, ceil(L / 128)), the last row block first: under
//   causal masking the longest walks start first and the tail is short.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"
#include "segments.cuh"

namespace {

constexpr int kD = 64;
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, dO, K, V pitch (floats)
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLseNone = -1e29f;         // lse above it: p = +0 at kNeg
constexpr float kLog2e = 1.4426950408889634f;

// K3-bwd-dkv's tiles
constexpr int kBK = 128;                   // keys a block (DKV_F32_KEYS)
constexpr int kBR = 64;                    // rows a tile
constexpr int kPP = kBK + 16;              // p, ds pitch (floats)
constexpr int kCJ = kBK / 16;              // S / dP keys a thread
constexpr int kEG = kBK / 4;               // elementwise: 4-key groups a row
constexpr int kER = kThreads / kEG;        // elementwise: rows a pass
constexpr int kNZ = kBK / 64;              // dV / dK: float4 runs of D
constexpr int kTX = 16 / kNZ;              // dV / dK: threads across D
constexpr int kKVFloats = 2 * kBK * kP;
constexpr int kStageFloats = 2 * kBR * kP;
// per stage: lse, delta (f32) and each row's segment id (int)
constexpr int kRowMeta = 3 * kBR;
constexpr int kSmemFloats = kKVFloats + 2 * kStageFloats + 2 * kBR * kPP
                            + 2 * kRowMeta;
constexpr size_t kSmemFixed = kSmemFloats * sizeof(float);

// K3-bwd-dq's tiles
constexpr int kQR = 128;                   // rows a block (DQ_F32_ROWS)
static_assert(kQR == 64 || kQR == 128, "K3-bwd-dq f32: 64 or 128 rows");
constexpr int kQK = 64;                    // keys a tile (DQ_F32_KEYS)
constexpr int kQRI = kQR / 16;             // S / dP, dQ: rows a thread
constexpr int kQPP = kQK + 8;              // S, dP / ds pitch (floats)
constexpr int kQEG = kQK / 4;              // elementwise: 4-key groups a row
constexpr int kQER = kThreads / kQEG;      // elementwise: rows a pass
constexpr int kQKG = kQK / 2;              // dQ: keys a group
constexpr int kQRowFloats = 2 * kQR * kP;
constexpr int kQStageFloats = 2 * kQK * kP;
// lse, delta and segment id of each row; the keys' segment ids (2
// stages); the row runs' ids and first rows; the run-start and
// lse <= -1e29 ballots
constexpr int kQMeta = 3 * kQR + 2 * kQK + 2 * kQR + 2 * (kQR / 32);
constexpr int kQSmemFloats = kQRowFloats + 2 * kQStageFloats
                             + 2 * kQR * kQPP + kQMeta;
constexpr size_t kQSmemFixed = kQSmemFloats * sizeof(float);
static_assert(kQSmemFixed + 64 <= kSmemMax,
              "K3-bwd-dq f32: the tiles fit in a block's shared memory");
static_assert(2 * kQR * kP <= 2 * kQStageFloats,
              "the key groups' dQ sums fit in the ring");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;     // (B, H, L)
  const float* delta;   // (B, H, L)
  const int* q_seg;     // (B, L), or null (one segment)
  const int* kv_seg;
  float* dk;
  float* dv;
  float* dq;
  int* walked;          // tiles walked a block (B * H, blocks), or null
  int b, l, h, causal;
  float sm_scale;
};

// Element offset of row (or key) r of head hi, batch bi, in (B, L, H, D).
__device__ __forceinline__ int64_t row_offset(const Args& a, int bi, int hi,
                                              int r) {
  return ((static_cast<int64_t>(bi) * a.l + r) * a.h + hi) * kD;
}

// Copy row tile t's Q, dO, lse, delta and segment ids into one stage
// (cp.async; rows past L zero-filled).
__device__ __forceinline__ void load_tile(const Args& a, int bi, int hi,
                                          int t, float* Qs, float* dOs,
                                          float* meta) {
  const int tid = threadIdx.x;
  const int row0 = t * kBR;
#pragma unroll
  for (int m = 0; m < kBR * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < a.l;
    int64_t off = in ? row_offset(a, bi, hi, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
    cp_async16(dOs + r * kP + ch * 4, a.dout + off, in);
  }
  if (tid < 3 * kBR) {
    const int which = tid / kBR, gr = row0 + tid % kBR;
    const bool in = gr < a.l;
    const int rr = in ? gr : 0;
    if (which < 2) {
      int64_t st = (static_cast<int64_t>(bi) * a.h + hi) * a.l + rr;
      cp_async4(meta + tid, (which == 0 ? a.lse : a.delta) + st, in);
    } else if (a.q_seg) {
      cp_async4(meta + tid, reinterpret_cast<const float*>(
                                a.q_seg + static_cast<int64_t>(bi) * a.l + rr),
                in);
    } else {
      reinterpret_cast<int*>(meta)[tid] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // [kBK][kP]
  float* Vs = Ks + kBK * kP;                 // [kBK][kP]
  float* stage0 = smem + kKVFloats;          // 2 x {Q, dO} [kBR][kP]
  float* Ps = stage0 + 2 * kStageFloats;     // [kBR][kPP]
  float* DSs = Ps + kBR * kPP;               // [kBR][kPP]
  float* s_meta = DSs + kBR * kPP;           // 2 x [kRowMeta]
  unsigned char* walk = reinterpret_cast<unsigned char*>(s_meta
                                                         + 2 * kRowMeta);
  __shared__ int s_kseg[kBK];                // the keys' segment ids
  __shared__ int s_run_seg[kBK], s_run_first[kBK];
  __shared__ unsigned s_starts[kBK / 32];    // run starts, one bit a key

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hi = blockIdx.x % a.h;
  const int bi = blockIdx.x / a.h;
  const int k0 = blockIdx.y * kBK;
  const int ntiles = (a.l + kBR - 1) / kBR;
  const int64_t seg_base = static_cast<int64_t>(bi) * a.l;

  // the block's keys below L as runs of one segment id
  const int n_runs = segment_runs<kBK>(a.kv_seg, seg_base, k0, a.l, s_kseg,
                                       s_run_seg, s_run_first, s_starts);

  // the walk: warp w tests tiles w, w + 8, ...; a row below L (and, under
  // causal, at or after k0) keeps its tile when it has lse <= -1e29 or a
  // run of its segment starts in the block (causal: at or before it)
  const float* lse_bh = a.lse + (static_cast<int64_t>(bi) * a.h + hi) * a.l;
  for (int t = warp; t < ntiles; t += kThreads / 32) {
    bool keep = false;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = t * kBR + 32 * half + lane;
      if (r < a.l && (!a.causal || r >= k0)) {
        if (lse_bh[r] <= kLseNone) {
          keep = true;
        } else {
          const int qs = a.q_seg ? a.q_seg[seg_base + r] : 0;
          for (int i = 0; i < n_runs; ++i)
            keep |= s_run_seg[i] == qs && (!a.causal || s_run_first[i] <= r);
        }
      }
    }
    unsigned any = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) walk[t] = any != 0;
  }
  __syncthreads();
  count_walked(a.walked, static_cast<int64_t>(blockIdx.x) * gridDim.y
                             + blockIdx.y, walk, ntiles);

  int t = next_walked(walk, 0, ntiles);
  if (t < ntiles) {
    // K and V once, with the first walked tile (keys past L zero-filled)
    for (int c = tid; c < kBK * (kD / 4); c += kThreads) {
      int kk = c / (kD / 4), ch = c % (kD / 4);
      int key = k0 + kk;
      bool in = key < a.l;
      int64_t off = in ? row_offset(a, bi, hi, key) + ch * 4 : 0;
      cp_async16(Ks + kk * kP + ch * 4, a.k + off, in);
      cp_async16(Vs + kk * kP + ch * 4, a.v + off, in);
    }
    load_tile(a, bi, hi, t, stage0, stage0 + kBR * kP, s_meta);
  }
  cp_async_commit();

  // warps 0-3 run S and then dV, warps 4-7 dP and then dK
  const bool dp_half = tid >= kThreads / 2;
  const int u = tid & (kThreads / 2 - 1);
  // the S / dP products: rows ry + 8 i, keys kx + 16 j
  const int kx = u & 15, ry = u >> 4;
  // the elementwise pass: rows er + kER m, keys ec + c
  const int er = tid / kEG, ec = 4 * (tid % kEG);
  int ksegs[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) ksegs[c] = s_kseg[ec + c];
  // dV (dK) accumulators: keys 8 ky + i, D columns 64 / kNZ * z + 4 tx + c
  const int tx = u % kTX, ky = u / kTX;
  float acc_kv[8][4 * kNZ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kNZ; ++j) acc_kv[i][j] = 0.f;
  int stage = 0;
  while (t < ntiles) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const int tn = next_walked(walk, t + 1, ntiles);
    float* Qs = stage0 + stage * kStageFloats;
    float* dOs = Qs + kBR * kP;
    const float* s_lse = s_meta + stage * kRowMeta;
    const float* s_delta = s_lse + kBR;
    const int* s_qseg = reinterpret_cast<const int*>(s_delta + kBR);
    if (tn < ntiles) {
      float* nQ = stage0 + (stage ^ 1) * kStageFloats;
      load_tile(a, bi, hi, tn, nQ, nQ + kBR * kP,
                s_meta + (stage ^ 1) * kRowMeta);
    }
    cp_async_commit();

    const float* X = dp_half ? dOs : Qs;
    const float* Y = dp_half ? Vs : Ks;
    float acc[8][kCJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; d += 4) {
      float4 xa[8], yb[kCJ];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xa[i] = *reinterpret_cast<const float4*>(X + (ry + 8 * i) * kP + d);
#pragma unroll
      for (int j = 0; j < kCJ; ++j)
        yb[j] = *reinterpret_cast<const float4*>(Y + (kx + 16 * j) * kP + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kCJ; ++j) {
          acc[i][j] = fmaf(xa[i].x, yb[j].x, acc[i][j]);
          acc[i][j] = fmaf(xa[i].y, yb[j].y, acc[i][j]);
          acc[i][j] = fmaf(xa[i].z, yb[j].z, acc[i][j]);
          acc[i][j] = fmaf(xa[i].w, yb[j].w, acc[i][j]);
        }
    }
    float* SP = dp_half ? DSs : Ps;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j)
        SP[(ry + 8 * i) * kPP + kx + 16 * j] = acc[i][j];
    __syncthreads();  // S and dP written

    // p = exp(s - lse) = 2^((s - lse) log2 e), the subtraction first,
    // below the row's frontier (0 past it); ds = p * (dp - delta) * scale
    const int row0 = t * kBR;
#pragma unroll
    for (int m = 0; m < kBR / kER; ++m) {
      const int r = er + kER * m, gr = row0 + r;
      const int f = gr < a.l ? (a.causal ? gr + 1 : a.l) : 0;
      const float l = s_lse[r], dl = s_delta[r];
      const int qs = s_qseg[r];
      float4* pe = reinterpret_cast<float4*>(Ps + r * kPP + ec);
      float4* de = reinterpret_cast<float4*>(DSs + r * kPP + ec);
      float4 sv = *pe, dv = *de;
      float* sa = reinterpret_cast<float*>(&sv);
      float* da = reinterpret_cast<float*>(&dv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = ksegs[c] == qs ? sa[c] * a.sm_scale : kNeg;
        float pv = k0 + ec + c < f ? exp2_approx((x - l) * kLog2e) : 0.f;
        sa[c] = pv;
        da[c] = pv * (da[c] - dl) * a.sm_scale;
      }
      *pe = sv;
      *de = dv;
    }
    __syncthreads();  // p and ds written

    // dV += P^T.dO (warps 0-3), dK += dS^T.Q (warps 4-7) over the
    // tile's rows
    const float* W = dp_half ? DSs : Ps;
    const float* Z = dp_half ? Qs : dOs;
#pragma unroll 16
    for (int r = 0; r < kBR; ++r) {
      float4 w0 = *reinterpret_cast<const float4*>(W + r * kPP + 8 * ky);
      float4 w1 = *reinterpret_cast<const float4*>(W + r * kPP + 8 * ky + 4);
      float4 z[kNZ];
#pragma unroll
      for (int n = 0; n < kNZ; ++n)
        z[n] = *reinterpret_cast<const float4*>(Z + r * kP + kD / kNZ * n
                                                + 4 * tx);
      const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float* za = reinterpret_cast<const float*>(z);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kNZ; ++j)
          acc_kv[i][j] = fmaf(wa[i], za[j], acc_kv[i][j]);
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait_all();

  float* out = dp_half ? a.dk : a.dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * ky + i;
    if (key >= a.l) continue;
#pragma unroll
    for (int n = 0; n < kNZ; ++n) {
      const float* x = acc_kv[i] + 4 * n;
      *reinterpret_cast<float4*>(out + row_offset(a, bi, hi, key)
                                 + kD / kNZ * n + 4 * tx) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// Copy the block's kQR rows from row0 on: Q and dO (cp.async, rows past L
// zero-filled), lse and delta (cp.async).
__device__ __forceinline__ void load_dq_rows(const Args& a, int bi, int hi,
                                             int row0, float* Qs, float* dOs,
                                             float* s_lse) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < kQR * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < a.l;
    int64_t off = in ? row_offset(a, bi, hi, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
    cp_async16(dOs + r * kP + ch * 4, a.dout + off, in);
  }
  // threads 0 to kQR - 1 copy lse, the next kQR delta
  if (tid < 2 * kQR) {
    const int gr = row0 + tid % kQR;
    const bool in = gr < a.l;
    int64_t st = (static_cast<int64_t>(bi) * a.h + hi) * a.l
                 + (in ? gr : 0);
    cp_async4(s_lse + tid, (tid < kQR ? a.lse : a.delta) + st, in);
  }
}

// Copy key tile kt's K, V (cp.async, keys past L zero-filled) and segment
// ids into one stage.
__device__ __forceinline__ void load_key_tile(const Args& a, int bi, int hi,
                                              int kt, float* Ks, int* kseg) {
  const int tid = threadIdx.x;
  const int k0 = kt * kQK;
  float* Vs = Ks + kQK * kP;
#pragma unroll
  for (int m = 0; m < kQK * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int kk = c / (kD / 4), ch = c % (kD / 4);
    int key = k0 + kk;
    bool in = key < a.l;
    int64_t off = in ? row_offset(a, bi, hi, key) + ch * 4 : 0;
    cp_async16(Ks + kk * kP + ch * 4, a.k + off, in);
    cp_async16(Vs + kk * kP + ch * 4, a.v + off, in);
  }
  if (tid < kQK) {
    const int key = k0 + tid;
    const bool in = key < a.l;
    if (a.kv_seg)
      cp_async4(reinterpret_cast<float*>(kseg + tid),
                reinterpret_cast<const float*>(
                    a.kv_seg + static_cast<int64_t>(bi) * a.l
                    + (in ? key : 0)),
                in);
    else
      kseg[tid] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [kQR][kP]
  float* dOs = Qs + kQR * kP;                // [kQR][kP]
  float* ring = smem + kQRowFloats;          // 2 x {K, V} [kQK][kP]
  float* Ss = ring + 2 * kQStageFloats;      // S [kQR][kQPP]
  float* DSs = Ss + kQR * kQPP;              // dP, then ds [kQR][kQPP]
  float* s_lse = DSs + kQR * kQPP;           // [kQR]
  float* s_delta = s_lse + kQR;              // [kQR]
  int* s_qseg = reinterpret_cast<int*>(s_delta + kQR);  // [kQR]
  int* s_kseg = s_qseg + kQR;                // 2 x [kQK]
  int* s_run_seg = s_kseg + 2 * kQK;         // [kQR]
  int* s_run_first = s_run_seg + kQR;        // [kQR]
  unsigned* s_starts = reinterpret_cast<unsigned*>(s_run_first + kQR);
  unsigned* s_dead = s_starts + kQR / 32;    // lse <= -1e29, one bit a row
  unsigned char* walk = reinterpret_cast<unsigned char*>(s_dead + kQR / 32);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hi = blockIdx.x % a.h;
  const int bi = blockIdx.x / a.h;
  const int nrb = gridDim.y;
  const int rb = nrb - 1 - blockIdx.y;       // the last rows first
  const int row0 = rb * kQR;
  const int nkt = (a.l + kQK - 1) / kQK;
  const int64_t seg_base = static_cast<int64_t>(bi) * a.l;

  load_dq_rows(a, bi, hi, row0, Qs, dOs, s_lse);
  cp_async_commit();

  // the rows with lse <= -1e29, and the block's rows below L as runs of
  // one segment id
  if (warp < kQR / 32) {
    const int r = row0 + tid;
    const float* lse_bh = a.lse + (static_cast<int64_t>(bi) * a.h + hi)
                                      * a.l;
    unsigned m = __ballot_sync(0xffffffffu,
                               r < a.l && lse_bh[r] <= kLseNone);
    if (lane == 0) s_dead[warp] = m;
  }
  const int n_runs = segment_runs<kQR>(a.q_seg, seg_base, row0, a.l, s_qseg,
                                       s_run_seg, s_run_first, s_starts);
  // the last row with lse <= -1e29 (-1: none), one past the last row
  int dead_last = -1;
#pragma unroll
  for (int w = 0; w < kQR / 32; ++w)
    if (s_dead[w]) dead_last = row0 + 32 * w + 31 - __clz(s_dead[w]);
  const int rows_end = min(row0 + kQR, a.l);

  // the walk: warp w tests key tiles w, w + 8, ...; a tile is kept when
  // a row with lse <= -1e29 lies in the block (causal: at or after its
  // first key), or a key of it below L shares its segment with a run of
  // the block's rows (causal: a run that ends at or after the key)
  for (int kt = warp; kt < nkt; kt += kThreads / 32) {
    const int k0 = kt * kQK;
    bool keep = dead_last >= (a.causal ? k0 : 0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + 32 * half + lane;
      if (key < a.l) {
        const int ks = a.kv_seg ? a.kv_seg[seg_base + key] : 0;
        for (int i = 0; i < n_runs; ++i) {
          const int last = (i + 1 < n_runs ? s_run_first[i + 1] : rows_end)
                           - 1;
          keep |= s_run_seg[i] == ks && (!a.causal || last >= key);
        }
      }
    }
    unsigned any = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) walk[kt] = any != 0;
  }
  __syncthreads();
  count_walked(a.walked, static_cast<int64_t>(blockIdx.x) * nrb + rb, walk,
               nkt);

  int t = next_walked(walk, 0, nkt);
  if (t < nkt) load_key_tile(a, bi, hi, t, ring, s_kseg);
  cp_async_commit();

  // warps 0-3 run S, warps 4-7 dP; then dQ in two key groups, one a half
  const bool dp_half = tid >= kThreads / 2;
  const int u = tid & (kThreads / 2 - 1);
  // S / dP: rows y + 16 i, keys x + 8 j; dQ: rows y + 16 i, D columns
  // 4 x + c and 32 + 4 x + c
  const int x = u & 7, y = u >> 3;
  // the elementwise pass: rows er + kQER m, keys ec + c
  const int er = tid / kQEG, ec = 4 * (tid % kQEG);
  float acc[kQRI][8];
#pragma unroll
  for (int i = 0; i < kQRI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int stage = 0;
  while (t < nkt) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const int tn = next_walked(walk, t + 1, nkt);
    const float* Ks = ring + stage * kQStageFloats;
    const float* Vs = Ks + kQK * kP;
    const int* kseg = s_kseg + stage * kQK;
    if (tn < nkt)
      load_key_tile(a, bi, hi, tn, ring + (stage ^ 1) * kQStageFloats,
                    s_kseg + (stage ^ 1) * kQK);
    cp_async_commit();

    // S (into Ss) and dP (into DSs)
    {
      const float* X = dp_half ? dOs : Qs;
      const float* Y = dp_half ? Vs : Ks;
      float sp[kQRI][8];
#pragma unroll
      for (int i = 0; i < kQRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; d += 4) {
        float4 xa[kQRI], yb[8];
#pragma unroll
        for (int i = 0; i < kQRI; ++i)
          xa[i] = *reinterpret_cast<const float4*>(X + (y + 16 * i) * kP + d);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          yb[j] = *reinterpret_cast<const float4*>(Y + (x + 8 * j) * kP + d);
#pragma unroll
        for (int i = 0; i < kQRI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sp[i][j] = fmaf(xa[i].x, yb[j].x, sp[i][j]);
            sp[i][j] = fmaf(xa[i].y, yb[j].y, sp[i][j]);
            sp[i][j] = fmaf(xa[i].z, yb[j].z, sp[i][j]);
            sp[i][j] = fmaf(xa[i].w, yb[j].w, sp[i][j]);
          }
      }
      float* SP = dp_half ? DSs : Ss;
#pragma unroll
      for (int i = 0; i < kQRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          SP[(y + 16 * i) * kQPP + x + 8 * j] = sp[i][j];
    }
    __syncthreads();  // S and dP written

    // ds = p * (dp - delta) * scale with p = 2^((s - lse) log2 e), the
    // subtraction first, below the row's frontier (0 past it); in place
    // of dP
    {
      const int k0 = t * kQK;
      const int4 ks4 = *reinterpret_cast<const int4*>(kseg + ec);
      const int ks[4] = {ks4.x, ks4.y, ks4.z, ks4.w};
#pragma unroll
      for (int m = 0; m < kQR / kQER; ++m) {
        const int r = er + kQER * m, gr = row0 + r;
        const int f = gr < a.l ? (a.causal ? gr + 1 : a.l) : 0;
        const float l = s_lse[r], dl = s_delta[r];
        const int qs = s_qseg[r];
        const float4 sv = *reinterpret_cast<const float4*>(Ss + r * kQPP
                                                           + ec);
        float4* de = reinterpret_cast<float4*>(DSs + r * kQPP + ec);
        float4 dv = *de;
        const float* sa = reinterpret_cast<const float*>(&sv);
        float* da = reinterpret_cast<float*>(&dv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float xv = ks[c] == qs ? sa[c] * a.sm_scale : kNeg;
          float pv = k0 + ec + c < f ? exp2_approx((xv - l) * kLog2e) : 0.f;
          da[c] = pv * (da[c] - dl) * a.sm_scale;
        }
        *de = dv;
      }
    }
    __syncthreads();  // ds written

    // dQ += dS.K over the key group's keys: warps 0-3 keys [0, 32),
    // warps 4-7 [32, 64)
    {
      const int g0 = dp_half ? kQKG : 0;
      const float* Kg = Ks + g0 * kP + 4 * x;
      const float* Dg = DSs + y * kQPP + g0;
#pragma unroll 4
      for (int c = 0; c < kQKG; c += 4) {
        float4 w[kQRI], z[4][2];
#pragma unroll
        for (int i = 0; i < kQRI; ++i)
          w[i] = *reinterpret_cast<const float4*>(Dg + 16 * i * kQPP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          z[cc][0] = *reinterpret_cast<const float4*>(Kg + (c + cc) * kP);
          z[cc][1] = *reinterpret_cast<const float4*>(Kg + (c + cc) * kP
                                                      + 32);
        }
#pragma unroll
        for (int i = 0; i < kQRI; ++i) {
          const float wa[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float* za = reinterpret_cast<const float*>(z[cc]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(wa[cc], za[j], acc[i][j]);
          }
        }
      }
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: the groups' sums meet there

  float* red = ring;                         // [2][kQR][kP]
  const int g = dp_half ? 1 : 0;
#pragma unroll
  for (int i = 0; i < kQRI; ++i) {
    float* xr = red + (g * kQR + y + 16 * i) * kP + 4 * x;
    reinterpret_cast<float4*>(xr)[0] = make_float4(acc[i][0], acc[i][1],
                                                   acc[i][2], acc[i][3]);
    reinterpret_cast<float4*>(xr + 32)[0] =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  // each of the block's rows below L: group 0's sum plus group 1's
  for (int c = tid; c < kQR * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), ch = c % (kD / 4);
    const int gr = row0 + r;
    if (gr >= a.l) continue;
    float4 s0 = *reinterpret_cast<const float4*>(red + r * kP + 4 * ch);
    const float4 s1 = *reinterpret_cast<const float4*>(red + (kQR + r) * kP
                                                       + 4 * ch);
    s0.x += s1.x;
    s0.y += s1.y;
    s0.z += s1.z;
    s0.w += s1.w;
    *reinterpret_cast<float4*>(a.dq + row_offset(a, bi, hi, gr) + 4 * ch) =
        s0;
  }
}

// Shared memory of one block for `fixed` bytes of tiles and n tiles to
// walk (bytes).
size_t smem_bytes(size_t fixed, int n) {
  return fixed + ((static_cast<size_t>(n) + 15) / 16) * 16;
}

// The checks both entries share: cudaSuccess, or the error to return.
int check_args(int d, int b, int l, int h, int block, const int* q_seg,
               const int* kv_seg, const void* const* ptrs, int nptrs) {
  if (d != kD || b <= 0 || l <= 0 || h <= 0
      || (q_seg == nullptr) != (kv_seg == nullptr)
      || (l + block - 1) / block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(cudaSuccess);
}

// Allow `kernel` `smem` bytes of dynamic shared memory (once per size
// above the last one allowed); cudaSuccess or the error.
template <typename Kernel>
int allow_smem(Kernel* kernel, size_t smem, size_t* configured) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > *configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    *configured = smem;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

// K3-bwd-dkv, f32 at D = 64. q, k, v, dout, dk, dv (B, L, H, 64), each
// 16-byte aligned; q_seg, kv_seg (B, L) int32 or both null; lse, delta
// (B, H, L) f32. walked: null, or (B * H, ceil(L / 128)) int32 that gets
// each key block's count of walked row tiles. Launches on `stream`;
// returns cudaGetLastError() (0 = ok).
extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                           const float* v, const int* q_seg,
                                           const int* kv_seg,
                                           const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int b, int l, int h,
                                           int d, int causal, float sm_scale,
                                           int* walked, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  int err = check_args(d, b, l, h, kBK, q_seg, kv_seg, ptrs, 6);
  if (err) return err;
  static size_t configured = 0;  // the dynamic shared memory allowed
  size_t smem = smem_bytes(kSmemFixed, (l + kBR - 1) / kBR);
  err = allow_smem(flash_bwd_dkv_f32_kernel, smem, &configured);
  if (err) return err;
  Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, nullptr, walked,
         b, l, h, causal, sm_scale};
  dim3 grid(b * h, (l + kBK - 1) / kBK);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3-bwd-dq, f32 at D = 64. q, k, v, dout, dq (B, L, H, 64), each 16-byte
// aligned; q_seg, kv_seg, lse, delta as flash_attention_bwd_dkv_f32.
// walked: null, or (B * H, ceil(L / 128)) int32 that gets each row
// block's count of walked key tiles. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int flash_attention_bwd_dq_f32(const float* q, const float* k,
                                          const float* v, const int* q_seg,
                                          const int* kv_seg,
                                          const float* dout,
                                          const float* lse,
                                          const float* delta, float* dq,
                                          int b, int l, int h, int d,
                                          int causal, float sm_scale,
                                          int* walked, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dq};
  int err = check_args(d, b, l, h, kQR, q_seg, kv_seg, ptrs, 5);
  if (err) return err;
  static size_t configured = 0;  // the dynamic shared memory allowed
  size_t smem = smem_bytes(kQSmemFixed, (l + kQK - 1) / kQK);
  err = allow_smem(flash_bwd_dq_f32_kernel, smem, &configured);
  if (err) return err;
  Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, nullptr, nullptr, dq,
         walked, b, l, h, causal, sm_scale};
  dim3 grid(b * h, (l + kQR - 1) / kQR);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
