// K2's backward in f32 for Hopper (sm_90a): register tiles on FFMA fed
// by 128-bit shared-memory loads and a cp.async ring. Kernels
// K2-bwd-dkdv and K2-bwd-dq, f32 at D = 128.
//
// Replace wedetect_tpu/ops/flash_gqa.py:_dkdv_kernel and :_dq_kernel
// (the Pallas TPU kernels of the grouped-KV flash attention's custom VJP,
// `pallas_call` at :308 and :287, reached through _bwd_grouped) for f32
// inputs at D = 128 (ops/flash_gqa.py:dkdv_route, :dq_route). dk/dv and
// dq at D = 64, 256, 384 or 512 and bf16 outside
// csrc/flash_gqa_bwd_sm90.cu stay on the SIMT kernels of
// csrc/flash_attn_bwd.cu. The contract is theirs
// (ops/flash_gqa.py:gqa_flash_attention_bwd_plain): q, dO, dq (B, S, H, D)
// and k, v, dk, dv (B, Lk, KVH, D) read and written in place; folded row
// r is query r / G, head kvh * G + r % G; lse and delta = rowsum(dO * O)
// f32 (B, KVH, S * G) in folded order; each row scans keys [0, F) with
// the forward's frontier F and -1e30 for a masked key below F
// (flash_common.cuh); p = exp(s - lse) on scanned keys and 0 past F;
// ds = p * (dO.V^T - delta) * scale; dv = sum p^T.dO, dk = sum ds^T.Q
// over the rows (the G folded heads summed), dq = sum ds.K over the keys,
// all in f32. A block owns its outputs (dk/dv: its keys; dq: its rows):
// no atomics, and every gradient repeats bit for bit.
//
// Bound on the H100: 8 * H * D (dk/dv) and 6 * H * D (dq) FLOPs per
// visible (query, key) pair at 67 TFLOP/s f32 (FFMA; no TF32, so the f32
// limits hold), against q, k, v, dO, lse and delta read once and the
// gradients written once at 3.35 TB/s. At the training path's decoder
// shape (1, 2048, 16, 128 | 2048, 8), 1253 valid keys, the FLOPs bound
// both: 0.436 ms (dk/dv), 0.327 ms (dq).
//
// The skip rule both kernels walk by: a (row tile, key tile) pair is
// walked when some row of the tile has its frontier F past the key tile's
// first key and sees a valid key of the tile (causal: one at or before
// its position) or has lse <= -1e29 (no visible valid key anywhere: p = 1
// on its scanned keys). Any other pair has p = 0 (past F) or
// exp(-1e30 - lse) = +0, and ds = +-0, so it adds nothing to any
// gradient. ops/flash_gqa.py:dkdv_tile_walked is the same rule
// (row_keeps below). One warp tests a tile's rows with a ballot before
// the walk.
//
// K2-bwd-dkdv. A block owns 64 keys of one (batch, kv head) and walks
// the folded rows in tiles of 32; 256 threads, one block an SM.
// - Operands. K, V (64 keys) and each row tile's Q, dO are staged
//   row-major with D contiguous at a pitch of 132 floats: a multiple of
//   4, so every operand is one LDS.128, and 4 banks apart from row to
//   row, so eight threads on eight consecutive rows read 32 distinct
//   banks. S = Q.K^T runs on warps 0-3 and dP = dO.V^T on warps 4-7,
//   the first two warps of each over D [0, 64), the other two over
//   [64, 128); a thread holds an 8 x 4 tile (rows ry + 4 i, keys
//   kx + 16 j): per 4 of D, 12 LDS.128 for 128 FFMA. The upper halves'
//   sums go to shared memory ([row][key], pitch 80), the lower halves
//   add theirs, and all 256 threads then turn 8 elements each into p and
//   ds in place. dV += P^T.dO runs on warps 0-3 and dK += dS^T.Q on
//   warps 4-7, a thread 8 consecutive keys x 8 of D (two runs of 4, 64
//   apart): per row, 4 LDS.128 for 64 FFMA.
// - Ring. While a tile's products run, cp.async copies the next walked
//   tile's Q and dO (512-byte rows in 16-byte chunks, rows past S * G
//   zero-filled) and its lse and delta (4-byte copies) into the other of
//   two stages, and one warp writes the tile's row frontiers and
//   positions beside them. Shared memory, in floats: K and V
//   2 x 64 x 132 = 16896 (67.6 KB), Q and dO 2 stages x 2 x 32 x 132 =
//   16896 (67.6 KB), S / p and dP / ds 2 x 32 x 80 = 5120 (20.5 KB), row
//   data 2 x 4 x 32 = 256 (1 KB); 156.7 KB, plus one byte a row tile for
//   the walk. 64-row tiles in two stages would need 135.2 KB for Q and dO
//   alone and 244 KB in all, over the 227 KB a block may hold.
// - The walk: the row tiles the rule keeps for the block's keys; a
//   block that walks nothing writes zeros. With a non-null `walked`,
//   each block also writes how many tiles it walked (a check of the
//   rule; null on the main path).
// - Order. Grid (B * KVH, Lk / 64): key block 0 of every (batch, head)
//   launches before key block 1 of any, so the longest causal walks
//   start first.
//
// K2-bwd-dq. A block owns kQR = 64 folded rows of one (batch, kv head)
// and walks the keys in tiles of kQK = 32; 256 threads, one block an SM.
// - Operands. Q and dO (the block's rows, resident) and each key tile's
//   K and V are staged as in K2-bwd-dkdv (pitch 132), and S = Q.K^T and
//   dP = dO.V^T are its first loop (8 x 4 tiles, rows ry + 8 i, keys
//   kx + 8 j, D in halves: 10.7 FFMA a load), into [row][key] at pitch
//   kQK + kQK / 4 = 40. The elementwise pass gives each thread one key
//   and 8 consecutive rows: it reads S and dP a row at a time (a warp on
//   32 consecutive keys), and stores ds transposed, key-major at pitch
//   kQR + 4 = 68, as two STS.128. dQ += dS.K splits the tile's keys into
//   128 / kQR = 2 groups of 16, each group's 128 threads holding 8 x 8
//   tiles of dQ (rows 8 qy + i, D columns 4 tx + c and 64 + 4 tx + c)
//   for the whole walk: per key, 2 LDS.128 of ds and 2 of K for 64
//   FFMA. At the end the groups' sums meet in shared memory and are
//   added in group order, so dq repeats bit for bit. The S / dP loop is
//   unrolled by 8 of its 16 steps, the dQ loop by 8 of its 16 keys: 222
//   registers, no spills. Unrolled fully, the two took 1.6% less time
//   but leave no loop for the SASS check to read (PERF.md §6).
// - Ring. While a tile's products run, cp.async copies the next walked
//   key tile's K and V (512-byte rows in 16-byte chunks) and its valid
//   flags into the other of two stages. Shared memory, in floats: Q and
//   dO 2 x 64 x 132 = 16896 (67.6 KB), K and V 2 stages x 2 x 32 x 132
//   = 16896 (67.6 KB), S and dP 2 x 64 x 40 = 5120 (20.5 KB), ds^T
//   32 x 68 = 2176 (8.7 KB), row data 4 x 64 and key flags 2 x 32
//   (1.3 KB); 165.6 KB, plus one byte a key tile for the walk. The other
//   shape a tile of 2048 (row, key) pairs allows, 32 rows x 64 keys
//   (kQR = 32: four key groups, 199.7 KB), took 5.5% longer
//   at the training shape (PERF.md §6, tools/time_k2_bwd.py --variant):
//   twice the blocks, each reading a key tile's 64 KB for half the rows.
// - The walk: the key tiles the rule keeps for the block's rows, in
//   order; inside a walked tile p is still 0 past each row's own F.
//   With a non-null `walked`, each block also writes how many tiles it
//   walked (a check of the rule; null on the main path).
// - Order. Grid (B * KVH, ceil(S * G / kQR)), the last row block first:
//   under causal masking the longest walks start first and the tail is
//   short.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, dO, K, V pitch (floats)
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLseNone = -1e29f;         // lse above it: p = +0 at kNeg
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNone = 0x7fffffff;          // no valid key

// K2-bwd-dkdv's tiles
constexpr int kBK = 64;                    // keys a block
constexpr int kBR = 32;                    // folded rows a tile
constexpr int kPP = kBK + 16;              // p, ds pitch (floats)
constexpr int kKVFloats = 2 * kBK * kP;
constexpr int kStageFloats = 2 * kBR * kP;
// per stage: lse, delta (f32) and each row's frontier and position (int)
constexpr int kRowMeta = 4 * kBR;
constexpr int kSmemFloats = kKVFloats + 2 * kStageFloats + 2 * kBR * kPP
                            + 2 * kRowMeta;
constexpr size_t kSmemFixed = kSmemFloats * sizeof(float);

// K2-bwd-dq's tiles: kQR folded rows a block, kQK keys a tile, 2048
// (row, key) pairs a tile either way
constexpr int kQR = 64;
static_assert(kQR == 32 || kQR == 64, "K2-bwd-dq f32: 32 or 64 rows");
constexpr int kQK = 2048 / kQR;
constexpr int kQKX = kQK / 4;              // S / dP: threads across keys
constexpr int kQRY = kQR / 8;              // S / dP: rows ry + kQRY i
constexpr int kQPP = kQK + kQKX;           // S, dP pitch (floats)
constexpr int kQPT = kQR + 4;              // ds^T pitch (floats)
constexpr int kQSplit = 128 / kQR;         // dQ: key groups
constexpr int kQKG = kQK / kQSplit;        // dQ: keys a group (16)
constexpr int kQSdpUnroll = 8;             // S / dP: steps of D unrolled
constexpr int kQRowFloats = 2 * kQR * kP;
constexpr int kQStageFloats = 2 * kQK * kP;
constexpr int kQSmemFloats = kQRowFloats + 2 * kQStageFloats
                             + 2 * kQR * kQPP + kQK * kQPT + 4 * kQR
                             + 2 * kQK;
constexpr size_t kQSmemFixed = kQSmemFloats * sizeof(float);
static_assert(kQSplit * kQR * kP <= 2 * kQStageFloats,
              "the key groups' dQ sums fit in the ring");

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;     // (B, KVH, S * G)
  const float* delta;   // (B, KVH, S * G)
  const int* kv_valid;  // (B, Lk) 0/1
  float* dk;
  float* dv;
  float* dq;
  int* walked;          // tiles walked a block, or null: dq (B * KVH, row
                        // blocks), dk/dv (B * KVH, key blocks)
  int b, s, lk, h, kvh, g;
  int g_shift;          // log2 G when G is a power of two, else -1
  int causal, off, bq, bk;
  float sm_scale;
};

__device__ __forceinline__ int frontier(const Args& a, int qi) {
  return a.causal ? gqa_frontier(qi, a.lk, a.off, a.bq, a.bk) : a.lk;
}

// The query position of folded row gr.
__device__ __forceinline__ int row_query(const Args& a, int gr) {
  return a.g_shift >= 0 ? gr >> a.g_shift : gr / a.g;
}

// Element offset of folded row gr of kv head hk, batch bi, in (B, S, H, D).
__device__ __forceinline__ int64_t row_offset(const Args& a, int bi, int hk,
                                              int gr) {
  int qi = row_query(a, gr);
  int head = hk * a.g + gr - qi * a.g;
  return ((static_cast<int64_t>(bi) * a.s + qi) * a.h + head) * kD;
}

// Whether a row keeps a (row tile, key tile) pair (the skip rule): its
// frontier f passes the tile's first key k0, and it sees a valid key of
// the tile (causal: the tile's first valid key at or before its position
// qpos; kNone: the tile has none) or has lse <= -1e29.
__device__ __forceinline__ bool row_keeps(const Args& a, int f, int qpos,
                                          float lse, int first_valid,
                                          int k0) {
  if (f <= k0) return false;
  bool sees = a.causal ? first_valid <= qpos : first_valid != kNone;
  return sees || lse <= kLseNone;
}

// Copy R folded rows from row0 on into shared memory: Q and dO
// (cp.async, rows past S * G zero-filled), lse and delta (cp.async), and
// each row's frontier (0 past S * G) and position. meta holds
// [lse R][delta R][F R][position R].
template <int R>
__device__ __forceinline__ void load_rows(const Args& a, int bi, int hk,
                                          int row0, float* Qs, float* dOs,
                                          float* meta) {
  const int rows = a.s * a.g;
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < R * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < rows;
    int64_t off = in ? row_offset(a, bi, hk, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
    cp_async16(dOs + r * kP + ch * 4, a.dout + off, in);
  }
  const int r = tid % R;
  const int gr = row0 + r;
  const bool in = gr < rows;
  if (tid < 2 * R) {
    int64_t st = (static_cast<int64_t>(bi) * a.kvh + hk) * rows
                 + (in ? gr : 0);
    cp_async4(meta + tid, (tid < R ? a.lse : a.delta) + st, in);
  } else if (tid < 3 * R) {
    int qi = row_query(a, gr);
    int* m = reinterpret_cast<int*>(meta + 2 * R);
    m[r] = in ? frontier(a, qi) : 0;
    m[R + r] = a.off + qi;
  }
}

// Copy K keys' K and V rows from key k0 on into shared memory (cp.async).
template <int K>
__device__ __forceinline__ void load_keys(const Args& a, int bi, int hk,
                                          int k0, float* Ks, float* Vs) {
  for (int c = threadIdx.x; c < K * (kD / 4); c += kThreads) {
    int kk = c / (kD / 4), ch = c % (kD / 4);
    int64_t off = ((static_cast<int64_t>(bi) * a.lk + k0 + kk) * a.kvh
                   + hk) * kD + ch * 4;
    cp_async16(Ks + kk * kP + ch * 4, a.k + off, true);
    cp_async16(Vs + kk * kP + ch * 4, a.v + off, true);
  }
}

// S = Q.K^T (or dP = dO.V^T) over one half of D for a thread's 8 x 4
// tile: rows ry + RY i of X, keys kx + KX j of Y, both at pitch kP and
// offset to the half; per 4 of D, 12 LDS.128 for 128 FFMA. The loop over
// D is unrolled by U of its 16 steps.
template <int RY, int KX, int U>
__device__ __forceinline__ void half_products(const float* X, const float* Y,
                                              int ry, int kx,
                                              float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll(U)
  for (int d = 0; d < kD / 2; d += 4) {
    float4 xa[8], yb[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xa[i] = *reinterpret_cast<const float4*>(X + (ry + RY * i) * kP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yb[j] = *reinterpret_cast<const float4*>(Y + (kx + KX * j) * kP + d);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(xa[i].x, yb[j].x, acc[i][j]);
        acc[i][j] = fmaf(xa[i].y, yb[j].y, acc[i][j]);
        acc[i][j] = fmaf(xa[i].z, yb[j].z, acc[i][j]);
        acc[i][j] = fmaf(xa[i].w, yb[j].w, acc[i][j]);
      }
  }
}

// The two halves of D summed into SP ([row][key], pitch PP): the upper
// half's threads write theirs, the lower half's add their own. Every
// thread of the block passes both barriers; SP is complete after them.
template <int RY, int KX, int PP>
__device__ __forceinline__ void sum_halves(float* SP, bool d_hi, int ry,
                                           int kx,
                                           const float (&acc)[8][4]) {
  if (d_hi) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        SP[(ry + RY * i) * PP + kx + KX * j] = acc[i][j];
  }
  __syncthreads();  // upper halves written
  if (!d_hi) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* e = SP + (ry + RY * i) * PP + kx + KX * j;
        *e = acc[i][j] + *e;
      }
  }
  __syncthreads();  // sums written
}

__global__ void __launch_bounds__(kThreads, 1)
gqa_bwd_dkdv_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                          // [kBK][kP]
  float* Vs = Ks + kBK * kP;                 // [kBK][kP]
  float* stage0 = smem + kKVFloats;          // 2 x {Q, dO} [kBR][kP]
  float* Ps = stage0 + 2 * kStageFloats;     // [kBR][kPP]
  float* DSs = Ps + kBR * kPP;               // [kBR][kPP]
  float* s_meta = DSs + kBR * kPP;           // 2 x [kRowMeta]
  unsigned char* walk = reinterpret_cast<unsigned char*>(s_meta
                                                         + 2 * kRowMeta);
  __shared__ unsigned s_vmask[2];            // key validity, 64 bits

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x % a.kvh;
  const int bi = blockIdx.x / a.kvh;
  const int k0 = blockIdx.y * kBK;
  const int rows = a.s * a.g;
  const int ntiles = (rows + kBR - 1) / kBR;

  // the block's valid keys, and the first of them (kNone: none)
  if (warp < 2) {
    int key = k0 + tid;
    bool ok = a.kv_valid[static_cast<int64_t>(bi) * a.lk + key] != 0;
    unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_vmask[warp] = m;
  }
  __syncthreads();
  const unsigned vm0 = s_vmask[0], vm1 = s_vmask[1];
  const int first_valid = vm0 ? k0 + __ffs(vm0) - 1
                          : vm1 ? k0 + 32 + __ffs(vm1) - 1 : kNone;

  // the walk: warp w tests row tiles w, w + 8, ...
  const float* lse_bh = a.lse + (static_cast<int64_t>(bi) * a.kvh + hk)
                                    * rows;
  for (int t = warp; t < ntiles; t += kThreads / 32) {
    int gr = t * kBR + lane;
    bool keep = false;
    if (gr < rows) {
      int qi = row_query(a, gr);
      keep = row_keeps(a, frontier(a, qi), a.off + qi, lse_bh[gr],
                       first_valid, k0);
    }
    unsigned any = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) walk[t] = any != 0;
  }
  __syncthreads();
  count_walked(a.walked, static_cast<int64_t>(blockIdx.x) * gridDim.y
                             + blockIdx.y, walk, ntiles);

  int t = next_walked(walk, 0, ntiles);
  if (t < ntiles) {
    // K and V once, with the first walked tile
    load_keys<kBK>(a, bi, hk, k0, Ks, Vs);
    load_rows<kBR>(a, bi, hk, t * kBR, stage0, stage0 + kBR * kP, s_meta);
  }
  cp_async_commit();

  // warps 0-3 run S and then dV, warps 4-7 dP and then dK
  const bool dp_half = tid >= kThreads / 2;
  const int u = tid & (kThreads / 2 - 1);
  // the S / dP products: warps 0-1 (4-5) over D [0, 64), warps 2-3 (6-7)
  // over [64, 128); rows ry + 4 i, keys kx + 16 j
  const bool d_hi = u >= kThreads / 4;
  const int kx = u & 15, ry = (u >> 4) & 3;
  // the elementwise pass: row er, keys ec + m
  const int er = tid >> 3, ec = 8 * (tid & 7);
  const unsigned ebits = ((ec < 32 ? vm0 : vm1) >> (ec & 31)) & 0xffu;
  // dV (dK) accumulators: keys 8 ky + i, D columns 4 tx + c and
  // 64 + 4 tx + c
  const int tx = u & 15, ky = u >> 4;
  float acc_kv[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_kv[i][j] = 0.f;
  int stage = 0;
  while (t < ntiles) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const int tn = next_walked(walk, t + 1, ntiles);
    float* Qs = stage0 + stage * kStageFloats;
    float* dOs = Qs + kBR * kP;
    const float* s_lse = s_meta + stage * kRowMeta;
    const float* s_delta = s_lse + kBR;
    const int* s_f = reinterpret_cast<const int*>(s_delta + kBR);
    const int* s_qpos = s_f + kBR;
    if (tn < ntiles) {
      float* nQ = stage0 + (stage ^ 1) * kStageFloats;
      load_rows<kBR>(a, bi, hk, tn * kBR, nQ, nQ + kBR * kP,
                     s_meta + (stage ^ 1) * kRowMeta);
    }
    cp_async_commit();

    // S (into Ps) and dP (into DSs)
    {
      float acc[8][4];
      half_products<4, 16, 4>((dp_half ? dOs : Qs) + (d_hi ? kD / 2 : 0),
                           (dp_half ? Vs : Ks) + (d_hi ? kD / 2 : 0), ry,
                           kx, acc);
      sum_halves<4, 16, kPP>(dp_half ? DSs : Ps, d_hi, ry, kx, acc);
    }

    // p = exp(s - lse) = 2^((s - lse) log2 e), the subtraction first,
    // below the row's frontier (0 past it); ds = p * (dp - delta) * scale
    {
      const int f = s_f[er], qpos = s_qpos[er];
      const float l = s_lse[er], dl = s_delta[er];
      float* pe = Ps + er * kPP + ec;
      float* de = DSs + er * kPP + ec;
      float4 sv[2] = {reinterpret_cast<float4*>(pe)[0],
                      reinterpret_cast<float4*>(pe)[1]};
      float4 dv[2] = {reinterpret_cast<float4*>(de)[0],
                      reinterpret_cast<float4*>(de)[1]};
      float* sa = reinterpret_cast<float*>(sv);
      float* da = reinterpret_cast<float*>(dv);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        int key = k0 + ec + m;
        float x = gqa_key_ok((ebits >> m) & 1u, key, qpos, a.causal)
                      ? sa[m] * a.sm_scale : kNeg;
        float pv = key < f ? exp2f((x - l) * kLog2e) : 0.f;
        sa[m] = pv;
        da[m] = pv * (da[m] - dl) * a.sm_scale;
      }
      reinterpret_cast<float4*>(pe)[0] = sv[0];
      reinterpret_cast<float4*>(pe)[1] = sv[1];
      reinterpret_cast<float4*>(de)[0] = dv[0];
      reinterpret_cast<float4*>(de)[1] = dv[1];
    }
    __syncthreads();  // p and ds written

    // dV += P^T.dO (warps 0-3), dK += dS^T.Q (warps 4-7) over the
    // tile's rows
    const float* W = dp_half ? DSs : Ps;
    const float* Z = dp_half ? Qs : dOs;
#pragma unroll 4
    for (int r = 0; r < kBR; ++r) {
      float4 w0 = *reinterpret_cast<const float4*>(W + r * kPP + 8 * ky);
      float4 w1 = *reinterpret_cast<const float4*>(W + r * kPP + 8 * ky + 4);
      float4 z0 = *reinterpret_cast<const float4*>(Z + r * kP + 4 * tx);
      float4 z1 = *reinterpret_cast<const float4*>(Z + r * kP + 64 + 4 * tx);
      const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float za[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc_kv[i][j] = fmaf(wa[i], za[j], acc_kv[i][j]);
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait_all();

  float* out = dp_half ? a.dk : a.dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int64_t base = ((static_cast<int64_t>(bi) * a.lk + k0 + 8 * ky + i)
                    * a.kvh + hk) * kD + 4 * tx;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* x = acc_kv[i] + 4 * half;
      *reinterpret_cast<float4*>(out + base + 64 * half) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

// Copy key tile kt's K, V (cp.async) and valid flags into one stage.
__device__ __forceinline__ void load_key_tile(const Args& a, int bi, int hk,
                                              int kt, float* stage,
                                              int* valid) {
  const int k0 = kt * kQK;
  load_keys<kQK>(a, bi, hk, k0, stage, stage + kQK * kP);
  if (threadIdx.x < kQK)
    cp_async4(reinterpret_cast<float*>(valid + threadIdx.x),
              reinterpret_cast<const float*>(
                  a.kv_valid + static_cast<int64_t>(bi) * a.lk + k0
                  + threadIdx.x),
              true);
}

__global__ void __launch_bounds__(kThreads, 1)
gqa_bwd_dq_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [kQR][kP]
  float* dOs = Qs + kQR * kP;                // [kQR][kP]
  float* ring = smem + kQRowFloats;          // 2 x {K, V} [kQK][kP]
  float* Ss = ring + 2 * kQStageFloats;      // [kQR][kQPP]
  float* DPs = Ss + kQR * kQPP;              // [kQR][kQPP]
  float* DST = DPs + kQR * kQPP;             // ds^T [kQK][kQPT]
  float* meta = DST + kQK * kQPT;            // [lse, delta, F, qpos][kQR]
  int* kvalid = reinterpret_cast<int*>(meta + 4 * kQR);  // 2 x [kQK]
  unsigned char* walk = reinterpret_cast<unsigned char*>(kvalid + 2 * kQK);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x % a.kvh;
  const int bi = blockIdx.x / a.kvh;
  const int nrt = gridDim.y;
  const int rt = nrt - 1 - blockIdx.y;       // the last rows first
  const int row0 = rt * kQR;
  const int rows = a.s * a.g;
  const int nkt = a.lk / kQK;
  const int* s_f = reinterpret_cast<const int*>(meta + 2 * kQR);
  const int* s_qpos = s_f + kQR;

  load_rows<kQR>(a, bi, hk, row0, Qs, dOs, meta);
  __syncthreads();  // frontiers and positions written

  // the walk: warp w tests key tiles w, w + 8, ...; lane l holds rows
  // l + 32 h
  {
    const float* lse_bh = a.lse + (static_cast<int64_t>(bi) * a.kvh + hk)
                                      * rows;
    const int* valid_b = a.kv_valid + static_cast<int64_t>(bi) * a.lk;
    int rf[kQR / 32], rq[kQR / 32];
    float rl[kQR / 32];
#pragma unroll
    for (int h = 0; h < kQR / 32; ++h) {
      const int r = lane + 32 * h;
      rf[h] = s_f[r];
      rq[h] = s_qpos[r];
      rl[h] = row0 + r < rows ? lse_bh[row0 + r] : 0.f;
    }
    for (int kt = warp; kt < nkt; kt += kThreads / 32) {
      const int k0 = kt * kQK;
      int first = kNone;
#pragma unroll
      for (int h = kQK / 32 - 1; h >= 0; --h) {
        unsigned m = __ballot_sync(0xffffffffu,
                                   valid_b[k0 + 32 * h + lane] != 0);
        if (m) first = k0 + 32 * h + __ffs(m) - 1;
      }
      bool keep = false;
#pragma unroll
      for (int h = 0; h < kQR / 32; ++h)
        keep |= row_keeps(a, rf[h], rq[h], rl[h], first, k0);
      unsigned any = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) walk[kt] = any != 0;
    }
  }
  __syncthreads();
  if (a.walked) {
    int n = 0;
    for (int k = 0; k < nkt; k += kThreads)
      n += __syncthreads_count(k + tid < nkt && walk[k + tid]);
    if (tid == 0)
      a.walked[static_cast<int64_t>(blockIdx.x) * nrt + rt] = n;
  }

  int t = next_walked(walk, 0, nkt);
  if (t < nkt) load_key_tile(a, bi, hk, t, ring, kvalid);
  cp_async_commit();

  // S / dP: warps 0-3 S = Q.K^T, warps 4-7 dP = dO.V^T; the first two
  // warps of each over D [0, 64), the other two over [64, 128); rows
  // ry + kQRY i, keys kx + kQKX j
  const bool dp_half = tid >= kThreads / 2;
  const int u = tid & (kThreads / 2 - 1);
  const bool d_hi = u >= kThreads / 4;
  const int kx = u % kQKX, ry = (u / kQKX) % kQRY;
  // the elementwise pass: key ek, rows er + m
  const int ek = tid % kQK, er = 8 * (tid / kQK);
  // dQ: key group kg (keys kg * kQKG + c), rows 8 qy + i, D columns
  // 4 tx + c and 64 + 4 tx + c
  const int kg = tid / (2 * kQR);
  const int tx = tid & 15, qy = (tid % (2 * kQR)) >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int stage = 0;
  while (t < nkt) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const int tn = next_walked(walk, t + 1, nkt);
    const float* Ks = ring + stage * kQStageFloats;
    const float* Vs = Ks + kQK * kP;
    const int* kv = kvalid + stage * kQK;
    if (tn < nkt)
      load_key_tile(a, bi, hk, tn, ring + (stage ^ 1) * kQStageFloats,
                    kvalid + (stage ^ 1) * kQK);
    cp_async_commit();

    // S (into Ss) and dP (into DPs)
    {
      float sp[8][4];
      half_products<kQRY, kQKX, kQSdpUnroll>(
          (dp_half ? dOs : Qs) + (d_hi ? kD / 2 : 0),
          (dp_half ? Vs : Ks) + (d_hi ? kD / 2 : 0), ry, kx, sp);
      sum_halves<kQRY, kQKX, kQPP>(dp_half ? DPs : Ss, d_hi, ry, kx, sp);
    }

    // ds = p * (dp - delta) * scale with p = 2^((s - lse) log2 e), the
    // subtraction first, below the row's frontier (0 past it); stored
    // key-major
    {
      const int key = t * kQK + ek;
      const int ok = kv[ek];
      float4 l4[2], dl4[2];
      int4 f4[2], qp4[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = er + 4 * h;
        l4[h] = *reinterpret_cast<const float4*>(meta + o);
        dl4[h] = *reinterpret_cast<const float4*>(meta + kQR + o);
        f4[h] = *reinterpret_cast<const int4*>(s_f + o);
        qp4[h] = *reinterpret_cast<const int4*>(s_qpos + o);
      }
      const float* l = reinterpret_cast<const float*>(l4);
      const float* dl = reinterpret_cast<const float*>(dl4);
      const int* f = reinterpret_cast<const int*>(f4);
      const int* qp = reinterpret_cast<const int*>(qp4);
      float ds[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float sv = Ss[(er + m) * kQPP + ek];
        const float dp = DPs[(er + m) * kQPP + ek];
        float x = gqa_key_ok(ok, key, qp[m], a.causal) ? sv * a.sm_scale
                                                       : kNeg;
        float pv = key < f[m] ? exp2_approx((x - l[m]) * kLog2e) : 0.f;
        ds[m] = pv * (dp - dl[m]) * a.sm_scale;
      }
      float* de = DST + ek * kQPT + er;
      reinterpret_cast<float4*>(de)[0] = make_float4(ds[0], ds[1], ds[2],
                                                     ds[3]);
      reinterpret_cast<float4*>(de)[1] = make_float4(ds[4], ds[5], ds[6],
                                                     ds[7]);
    }
    __syncthreads();  // ds written

    // dQ += dS.K over the key group's keys
    const float* Kg = Ks + kg * kQKG * kP;
    const float* Dg = DST + kg * kQKG * kQPT + 8 * qy;
#pragma unroll 8
    for (int c = 0; c < kQKG; ++c) {
      float4 w0 = *reinterpret_cast<const float4*>(Dg + c * kQPT);
      float4 w1 = *reinterpret_cast<const float4*>(Dg + c * kQPT + 4);
      float4 z0 = *reinterpret_cast<const float4*>(Kg + c * kP + 4 * tx);
      float4 z1 = *reinterpret_cast<const float4*>(Kg + c * kP + 64
                                                   + 4 * tx);
      const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float za[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(wa[i], za[j], acc[i][j]);
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait_all();
  __syncthreads();  // the ring is free: the groups' sums meet there

  float* red = ring;                         // [kQSplit][kQR][kP]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* x = red + (kg * kQR + 8 * qy + i) * kP + 4 * tx;
    reinterpret_cast<float4*>(x)[0] = make_float4(acc[i][0], acc[i][1],
                                                  acc[i][2], acc[i][3]);
    reinterpret_cast<float4*>(x + 64)[0] =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  // each of the block's rows below S * G: the groups' sums in group order
  for (int c = tid; c < kQR * (kD / 4); c += kThreads) {
    const int r = c / (kD / 4), ch = c % (kD / 4);
    const int gr = row0 + r;
    if (gr >= rows) continue;
    float4 sum = *reinterpret_cast<const float4*>(red + r * kP + 4 * ch);
#pragma unroll
    for (int g = 1; g < kQSplit; ++g) {
      float4 x = *reinterpret_cast<const float4*>(red + (g * kQR + r) * kP
                                                  + 4 * ch);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(a.dq + row_offset(a, bi, hk, gr) + 4 * ch) =
        sum;
  }
}

// Shared memory of one dk/dv block for S * G folded rows (bytes).
size_t smem_bytes(int rows) {
  int ntiles = (rows + kBR - 1) / kBR;
  return kSmemFixed + ((static_cast<size_t>(ntiles) + 15) / 16) * 16;
}

// Shared memory of one dq block for Lk keys (bytes).
size_t dq_smem_bytes(int lk) {
  int ntiles = lk / kQK;
  return kQSmemFixed + ((static_cast<size_t>(ntiles) + 15) / 16) * 16;
}

// The checks both entries share: cudaSuccess, or the error to return.
int check_args(int d, int s, int lk, int h, int kvh, int causal, int bq,
               int bk, int key_tile, const void* const* ptrs, int nptrs) {
  if (d != kD || kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0
      || lk % key_tile != 0 || (causal && lk < s))
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

Args make_args(const float* q, const float* k, const float* v,
               const int* kv_valid, const float* dout, const float* lse,
               const float* delta, float* dk, float* dv, float* dq,
               int* walked, int b, int s, int lk, int h, int kvh, int causal,
               int bq, int bk, float sm_scale) {
  const int g = h / kvh;
  int g_shift = -1;
  for (int e = 0; e < 31; ++e)
    if ((1 << e) == g) g_shift = e;
  return Args{q, k, v, dout, lse, delta, kv_valid, dk, dv, dq, walked,
              b, s, lk, h, kvh, g, g_shift, causal, causal ? lk - s : 0,
              bq, bk, sm_scale};
}

}  // namespace

// K2-bwd-dkdv, f32 at D = 128. q, dout (B, S, H, D); k, v, dk, dv
// (B, Lk, KVH, D), each 16-byte aligned; kv_valid (B, Lk) int32; lse,
// delta (B, KVH, S * H / KVH) f32; bq, bk: the Pallas kernel's blocks,
// which fix each row's frontier. Lk must be a multiple of 64. walked:
// null, or (B * KVH, Lk / 64) int32 that gets each key block's count of
// walked row tiles. Launches on `stream`; returns cudaGetLastError()
// (0 = ok).
extern "C" int gqa_flash_bwd_dkdv_f32(const float* q, const float* k,
                                      const float* v, const int* kv_valid,
                                      const float* dout, const float* lse,
                                      const float* delta, float* dk,
                                      float* dv, int b, int s, int lk, int h,
                                      int kvh, int d, int causal, int bq,
                                      int bk, float sm_scale, int* walked,
                                      void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  int err = check_args(d, s, lk, h, kvh, causal, bq, bk, kBK, ptrs, 6);
  if (err) return err;
  static size_t configured = 0;  // the dynamic shared memory allowed
  size_t smem = smem_bytes(s * (h / kvh));
  err = allow_smem(gqa_bwd_dkdv_f32_kernel, smem, &configured);
  if (err) return err;
  Args a = make_args(q, k, v, kv_valid, dout, lse, delta, dk, dv, nullptr,
                     walked, b, s, lk, h, kvh, causal, bq, bk, sm_scale);
  dim3 grid(b * kvh, lk / kBK);
  gqa_bwd_dkdv_f32_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K2-bwd-dq, f32 at D = 128. q, dout, dq (B, S, H, D); k, v
// (B, Lk, KVH, D), each 16-byte aligned; kv_valid, lse, delta, bq, bk as
// gqa_flash_bwd_dkdv_f32. Lk must be a multiple of the key tile (32).
// walked: null, or (B * KVH, ceil(S * G / 64)) int32 that gets each row
// block's count of walked key tiles. Launches on `stream`; returns
// cudaGetLastError() (0 = ok).
extern "C" int gqa_flash_bwd_dq_f32(const float* q, const float* k,
                                    const float* v, const int* kv_valid,
                                    const float* dout, const float* lse,
                                    const float* delta, float* dq, int b,
                                    int s, int lk, int h, int kvh, int d,
                                    int causal, int bq, int bk,
                                    float sm_scale, int* walked,
                                    void* stream) {
  const void* ptrs[] = {q, k, v, dout, dq};
  int err = check_args(d, s, lk, h, kvh, causal, bq, bk, kQK, ptrs, 5);
  if (err) return err;
  const int nrt = (s * (h / kvh) + kQR - 1) / kQR;
  if (nrt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the dynamic shared memory allowed
  size_t smem = dq_smem_bytes(lk);
  err = allow_smem(gqa_bwd_dq_f32_kernel, smem, &configured);
  if (err) return err;
  Args a = make_args(q, k, v, kv_valid, dout, lse, delta, nullptr, nullptr,
                     dq, walked, b, s, lk, h, kvh, causal, bq, bk, sm_scale);
  dim3 grid(b * kvh, nrt);
  gqa_bwd_dq_f32_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
