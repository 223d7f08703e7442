// K2 in f32 for Hopper (sm_90a): register tiles on FFMA fed by 128-bit
// shared-memory loads and a cp.async ring. Kernel K2 (the grouped-KV
// flash attention forward), f32 at D = 128.
//
// Replaces wedetect_tpu/ops/flash_gqa.py:_fwd_kernel (:86; the Pallas TPU
// kernel behind gqa_flash_attention, `pallas_call` :145, reached through
// _fwd_grouped :134) for f32 inputs at D = 128 (ops/flash_gqa.py:
// fwd_route). f32 at D = 256, 384 and 512 and bf16 off the wgmma shapes
// stay on the SIMT template of csrc/flash_attn.cu; bf16 at D = 128 is
// csrc/flash_gqa_sm90.cu. The contract is theirs
// (ops/flash_gqa.py:gqa_flash_attention_plain): q, o (B, S, H, D) and
// k, v (B, Lk, KVH, D) read and written in place; kv_valid (B, Lk) int32;
// folded row r is query r / G, head kvh * G + r % G; lse f32
// (B, KVH, S * G) in folded order, natural log. Each row scans keys
// [0, F) with JAX's tile frontier F (flash_common.cuh); a masked key
// below F has logit -1e30, a key at F or past it is absent; so a row
// whose scanned keys are all masked returns the mean of V over them and
// keeps lse <= -1e29 (K2-bwd's skip rule reads that), and O = 0 where
// l = 0.
//
// Bound on the H100: 4 * H * D FLOPs per visible (query, key) pair at
// 67 TFLOP/s f32 (FFMA; no TF32, so the f32 limits hold), against q, k,
// v read once and O and lse written once at 3.35 TB/s. At the training
// path's decoder shape (1, 2048, 16, 128 | 2048, 8), 1253 valid keys,
// the FLOPs bound it: 0.218 ms; at the Ref suffix (8, 256, 16, 128 |
// 640, 8) 0.1145 ms.
//
// The skip rule (ops/flash_gqa.py:fwd_tile_walked): a (row tile, key
// tile) pair is walked when some row of the tile has its frontier F past
// the key tile's first key and either sees a valid key of the tile
// (causal: one at or before its position) or has no visible valid key at
// all (the first valid key of its batch lies past its position; not
// causal: the batch has none), and then needs every key below F for the
// mean of V. For a row with a visible valid key, a skipped tile holds
// only keys at -1e30 or past F: before that key they are erased by
// alpha = exp(-1e30 - m) = 0, after it they add exp(-1e30 - m) = +0. So
// the walk changes the time and nothing else. The prologue finds the
// batch's first valid key with a ballot over kv_valid; one warp a key
// tile then tests the block's rows with a ballot.
//
// Design. A block owns R folded rows of one (batch, kv head) and walks
// the keys in tiles of K; 256 threads, one block an SM. Two tiles: the
// wide one, R = 64 x K = 32, and for grids of wide blocks that would not
// fill the card (the Ref prefix: 96 blocks on 132 SMs) the narrow one,
// 32 x 64, with twice the blocks (ops/flash_gqa.py:fwd_f32_tile). In the
// wide tile:
// - Operands. Q (the block's rows, resident) and each key tile's K and V
//   are staged row-major with D contiguous at a pitch of 132 floats: a
//   multiple of 4, so every operand is one LDS.128, and 4 banks apart
//   from row to row. S = Q.K^T runs on 8 x 4 register tiles (rows ry + 8 i,
//   keys kx + 8 j) with D in four parts of 32, one a group of 64 threads:
//   per 4 of D, 12 LDS.128 for 128 FFMA. Each part writes its sums to
//   its own buffer ([row][key], pitch 40), and the softmax adds the four
//   in part order.
// - Online softmax. Four threads own a row and 8 of the tile's keys
//   each (float2 reads): the row max takes 2 shfl_xor steps, m stays in
//   registers, each thread keeps its own share of l (summed once at the
//   end), and alpha goes to shared memory once a tile. p = 2^((x - m)
//   log2 e) on ex2.approx.ftz, m (and so lse) in natural units. P is
//   stored key-major ([key][row], pitch 68, conflict-free).
// - O += P.V splits the tile's keys into 128 / R = 2 groups of 16, each
//   group's 128 threads holding 8 x 8 tiles of O (rows 8 qy + i, D
//   columns 4 tx + c and 64 + 4 tx + c) for the whole walk, rescaled by
//   alpha each tile: per key, 2 LDS.128 of P^T and 2 of V for 64 FFMA.
//   At the end the groups' sums meet in shared memory and are added in
//   group order, so O repeats bit for bit.
// - Ring. While a tile's products run, cp.async copies the next walked
//   key tile's K and V (512-byte rows in 16-byte chunks) and its valid
//   flags into the other of kStages = 2 stages. Shared memory, in floats:
//   Q 64 x 132 = 8448 (33.8 KB), K and V 2 stages x 2 x 32 x 132 = 16896
//   (67.6 KB), the S parts 4 x 64 x 40 = 10240 (41 KB), P^T 32 x 68 =
//   2176 (8.7 KB), row data 4 x 64 and key flags 2 x 32 (1.3 KB); 152.4
//   KB, plus one byte a key tile for the walk.
// The narrow tile keeps the same loops: S on 8 x 4 tiles (rows ry + 4 i,
// keys kx + 16 j, D in four parts), eight threads a row in the softmax,
// P.V in four key groups of 16 (203.3 KB). Probes (PERF.md §6,
// tools/time_k2.py --variant): 64 x 64 tiles took 6.6% less at K2_TRAIN
// and 1.7% more at the suffix; three stages 0.7-1.2% less; neither was
// adopted.
// - The walk: the key tiles the rule keeps for the block's rows, in
//   order; inside a walked tile a key is still absent past each row's own
//   F. With a non-null `walked`, each block also writes how many tiles it
//   walked (a check of the rule; null on the main path).
// - Order. Grid (B * KVH, ceil(S * G / R)), the last row block first:
//   under causal masking the longest walks start first and the tail is
//   short.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, K, V pitch (floats)
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNone = 0x7fffffff;          // no valid key

// The two tiles, folded rows a block x keys a tile: the wide one for
// grids that fill the card, the narrow one for smaller grids
// (ops/flash_gqa.py:fwd_f32_tile)
constexpr int kWideR = 64, kWideK = 32;
constexpr int kNarrowR = 32, kNarrowK = 64;
constexpr int kStages = 2;                 // cp.async ring depth
constexpr int kSUnroll = 4;                // S: steps of D unrolled
constexpr int kPVUnroll = 8;               // P.V: keys unrolled

// The shapes that follow from a tile of R folded rows x K keys.
template <int R, int K>
struct Tiles {
  static constexpr int kKX = K / 4;                 // S: threads across keys
  static constexpr int kRY = R / 8;                 // S: rows ry + kRY i
  static constexpr int kSThreads = kKX * kRY;       // S: threads a D part
  static constexpr int kParts = kThreads / kSThreads;
  static constexpr int kDPart = kD / kParts;        // S: D a part
  static constexpr int kSP = K + kKX;               // S parts' pitch
  static constexpr int kTPR = kThreads / R;         // softmax: threads a row
  static constexpr int kKPT = K / kTPR;             // softmax: keys a thread
  static constexpr int kPT = R + 4;                 // P^T pitch
  static constexpr int kSplit = 128 / R;            // P.V: key groups
  static constexpr int kKG = K / kSplit;            // P.V: keys a group
  static constexpr int kStage = 2 * K * kP;         // K and V of one tile
  static constexpr int kFloats = R * kP + kStages * kStage
                                 + kParts * R * kSP + K * kPT + 4 * R
                                 + kStages * K;
  static_assert(kParts * kSThreads == kThreads && kDPart % 4 == 0,
                "S: whole 8 x 4 tiles over whole steps of D");
  static_assert(kKPT % 2 == 0 && kKG >= 1, "softmax and P.V split");
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert((kSplit - 1) * R * kP <= kStages * kStage,
                "the key groups' O sums fit in the ring");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* kv_valid;  // (B, Lk) 0/1
  float* o;
  float* lse;           // (B, KVH, S * G)
  int* walked;          // tiles walked a block (B * KVH, row blocks)
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

// Whether a row keeps a key tile (the skip rule): its frontier f passes
// the tile's first key k0, and it sees a valid key of the tile (causal:
// the tile's first valid key at or before its position qpos; kNone: the
// tile has none) or has no visible valid key at all.
__device__ __forceinline__ bool row_keeps(const Args& a, int f, int qpos,
                                          bool none, int first_valid,
                                          int k0) {
  if (f <= k0) return false;
  bool sees = a.causal ? first_valid <= qpos : first_valid != kNone;
  return sees || none;
}

// Copy the block's R folded rows of Q from row0 on into shared memory
// (cp.async; rows past S * G zero-filled).
template <int R>
__device__ __forceinline__ void load_q(const Args& a, int bi, int hk,
                                       int row0, float* Qs) {
  const int rows = a.s * a.g;
#pragma unroll
  for (int m = 0; m < R * (kD / 4) / kThreads; ++m) {
    int c = threadIdx.x + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < rows;
    int64_t off = in ? row_offset(a, bi, hk, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
  }
}

// Copy key tile kt's K and V rows and valid flags into one stage
// (cp.async).
template <int K>
__device__ __forceinline__ void load_key_tile(const Args& a, int bi, int hk,
                                              int kt, float* stage,
                                              int* valid) {
  const int k0 = kt * K;
  float* Ks = stage;
  float* Vs = stage + K * kP;
  for (int c = threadIdx.x; c < K * (kD / 4); c += kThreads) {
    int kk = c / (kD / 4), ch = c % (kD / 4);
    int64_t off = ((static_cast<int64_t>(bi) * a.lk + k0 + kk) * a.kvh
                   + hk) * kD + ch * 4;
    cp_async16(Ks + kk * kP + ch * 4, a.k + off, true);
    cp_async16(Vs + kk * kP + ch * 4, a.v + off, true);
  }
  if (threadIdx.x < K)
    cp_async4(reinterpret_cast<float*>(valid + threadIdx.x),
              reinterpret_cast<const float*>(
                  a.kv_valid + static_cast<int64_t>(bi) * a.lk + k0
                  + threadIdx.x),
              true);
}

// S = Q.K^T over N of D for a thread's 8 x 4 tile: rows ry + RY i of X,
// keys kx + KX j of Y, both at pitch kP and offset to the part; per 4 of
// D, 12 LDS.128 for 128 FFMA. The loop over D is unrolled by U steps.
template <int RY, int KX, int N, int U>
__device__ __forceinline__ void part_products(const float* X, const float* Y,
                                              int ry, int kx,
                                              float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll(U)
  for (int d = 0; d < N; d += 4) {
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

template <int R, int K>
__global__ void __launch_bounds__(kThreads, 1)
gqa_fwd_f32_kernel(const Args a) {
  using T = Tiles<R, K>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // [R][kP]
  float* ring = Qs + R * kP;                     // stages x {K, V} [K][kP]
  float* Sp = ring + kStages * T::kStage;         // parts x [R][kSP]
  float* PT = Sp + T::kParts * R * T::kSP;       // P^T [K][kPT]
  float* s_alpha = PT + K * T::kPT;              // [R]
  float* s_inv = s_alpha + R;                    // [R] 1 / l
  int* s_f = reinterpret_cast<int*>(s_inv + R);  // [R] frontier
  int* s_qpos = s_f + R;                         // [R] key position
  int* kvalid = s_qpos + R;                      // stages x [K]
  unsigned char* walk = reinterpret_cast<unsigned char*>(kvalid
                                                         + kStages * K);
  __shared__ int s_first;                         // the batch's first valid

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x % a.kvh;
  const int bi = blockIdx.x / a.kvh;
  const int nrt = gridDim.y;
  const int rt = nrt - 1 - blockIdx.y;            // the last rows first
  const int row0 = rt * R;
  const int rows = a.s * a.g;
  const int nkt = a.lk / K;
  const int* valid_b = a.kv_valid + static_cast<int64_t>(bi) * a.lk;

  load_q<R>(a, bi, hk, row0, Qs);
  if (tid < R) {
    const int gr = row0 + tid;
    const int qi = row_query(a, gr);
    s_f[tid] = gr < rows ? frontier(a, qi) : 0;
    s_qpos[tid] = a.off + qi;
  }
  // the batch's first valid key (kNone: none), by the last warp
  if (warp == kThreads / 32 - 1) {
    int first = kNone;
    for (int c = 0; c < a.lk; c += 32) {
      unsigned m = __ballot_sync(0xffffffffu, valid_b[c + lane] != 0);
      if (m) {
        first = c + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) s_first = first;
  }
  __syncthreads();  // frontiers, positions and the first valid key written

  // the walk: warp w tests key tiles w, w + 8, ...; lane l holds rows
  // l + 32 h
  {
    const int first_b = s_first;
    int rf[R / 32], rq[R / 32];
    bool none[R / 32];
#pragma unroll
    for (int h = 0; h < R / 32; ++h) {
      const int r = lane + 32 * h;
      rf[h] = s_f[r];
      rq[h] = s_qpos[r];
      none[h] = first_b > (a.causal ? rq[h] : a.lk - 1);
    }
    for (int kt = warp; kt < nkt; kt += kThreads / 32) {
      const int k0 = kt * K;
      int first = kNone;
#pragma unroll
      for (int h = K / 32 - 1; h >= 0; --h) {
        unsigned m = __ballot_sync(0xffffffffu,
                                   valid_b[k0 + 32 * h + lane] != 0);
        if (m) first = k0 + 32 * h + __ffs(m) - 1;
      }
      bool keep = false;
#pragma unroll
      for (int h = 0; h < R / 32; ++h)
        keep |= row_keeps(a, rf[h], rq[h], none[h], first, k0);
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

  // the ring: the i-th walked tile in stage i % kStages, the next
  // kStages - 1 walked tiles in flight (one commit group each)
  int ahead = next_walked(walk, 0, nkt);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ahead < nkt) {
      load_key_tile<K>(a, bi, hk, ahead, ring + st * T::kStage,
                        kvalid + st * K);
      ahead = next_walked(walk, ahead + 1, nkt);
    }
    cp_async_commit();
  }
  int t = next_walked(walk, 0, nkt);

  // S: D part pd; rows ry + kRY i, keys kx + kKX j
  const int pd = tid / T::kSThreads;
  const int u = tid % T::kSThreads;
  const int kx = u % T::kKX, ry = u / T::kKX;
  // the softmax: row sr, keys 2 kTPR m + 2 sq + e
  const int sr = tid / T::kTPR, sq = tid % T::kTPR;
  const int f_r = s_f[sr], qpos_r = s_qpos[sr];
  float m_r = kNeg, l_r = 0.f;
  // O: key group kg (keys kg * kKG + c), rows 8 qy + i, D columns 4 tx + c
  // and 64 + 4 tx + c
  const int kg = tid / (2 * R);
  const int tx = tid & 15, qy = (tid % (2 * R)) >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int stage = 0;
  while (t < nkt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const float* Ks = ring + stage * T::kStage;
    const float* Vs = Ks + K * kP;
    const int* kv = kvalid + stage * K;
    if (ahead < nkt) {  // into the stage the previous tile used
      const int st = (stage + kStages - 1) % kStages;
      load_key_tile<K>(a, bi, hk, ahead, ring + st * T::kStage,
                        kvalid + st * K);
      ahead = next_walked(walk, ahead + 1, nkt);
    }
    cp_async_commit();

    // S over the thread's part of D, into its part's buffer
    {
      float sp[8][4];
      part_products<T::kRY, T::kKX, T::kDPart, kSUnroll>(
          Qs + pd * T::kDPart, Ks + pd * T::kDPart, ry, kx, sp);
      float* out = Sp + pd * R * T::kSP;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          out[(ry + T::kRY * i) * T::kSP + kx + T::kKX * j] = sp[i][j];
    }
    __syncthreads();  // the S parts written

    // the online softmax of row sr over the thread's keys: the parts
    // added in order, the logit x = s * scale below the row's frontier
    // (kNeg where masked, -inf past F), p = 2^((x - m) log2 e) into P^T
    {
      const int k0 = t * K;
      float x[T::kKPT];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int m = 0; m < T::kKPT / 2; ++m) {
        const int c = 2 * T::kTPR * m + 2 * sq;
        float2 s = *reinterpret_cast<const float2*>(Sp + sr * T::kSP + c);
#pragma unroll
        for (int p = 1; p < T::kParts; ++p) {
          float2 y = *reinterpret_cast<const float2*>(
              Sp + (p * R + sr) * T::kSP + c);
          s.x += y.x;
          s.y += y.y;
        }
        const int2 ok = *reinterpret_cast<const int2*>(kv + c);
        const float sv[2] = {s.x, s.y};
        const int okv[2] = {ok.x, ok.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + c + e;
          float xv = gqa_key_ok(okv[e], key, qpos_r, a.causal)
                         ? sv[e] * a.sm_scale : kNeg;
          xv = key < f_r ? xv : -CUDART_INF_F;
          x[2 * m + e] = xv;
          mx = fmaxf(mx, xv);
        }
      }
#pragma unroll
      for (int sh = 1; sh < T::kTPR; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m_r, mx);
      const float alpha = exp2_approx((m_r - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < T::kKPT / 2; ++m) {
        const int c = 2 * T::kTPR * m + 2 * sq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_approx((x[2 * m + e] - m_new) * kLog2e);
          PT[(c + e) * T::kPT + sr] = p;
          sum += p;
        }
      }
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if (sq == 0) s_alpha[sr] = alpha;
    }
    __syncthreads();  // P^T and alpha written

    // O = O * alpha + P.V over the key group's keys
    {
      const float4 a0 = *reinterpret_cast<const float4*>(s_alpha + 8 * qy);
      const float4 a1 = *reinterpret_cast<const float4*>(s_alpha + 8 * qy
                                                         + 4);
      const float al[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= al[i];
      const float* Vg = Vs + kg * T::kKG * kP;
      const float* Pg = PT + kg * T::kKG * T::kPT + 8 * qy;
#pragma unroll(kPVUnroll)
      for (int c = 0; c < T::kKG; ++c) {
        float4 w0 = *reinterpret_cast<const float4*>(Pg + c * T::kPT);
        float4 w1 = *reinterpret_cast<const float4*>(Pg + c * T::kPT + 4);
        float4 z0 = *reinterpret_cast<const float4*>(Vg + c * kP + 4 * tx);
        float4 z1 = *reinterpret_cast<const float4*>(Vg + c * kP + 64
                                                     + 4 * tx);
        const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float za[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(wa[i], za[j], acc[i][j]);
      }
    }
    t = next_walked(walk, t + 1, nkt);
    stage = (stage + 1) % kStages;
  }
  cp_async_wait_all();

  // each row's l (the threads' shares summed), lse = m + log l, and 1 / l
  // (0 where l = 0: O = 0 there)
  {
    float l = l_r;
#pragma unroll
    for (int sh = 1; sh < T::kTPR; sh <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, sh);
    if (sq == 0) {
      const int gr = row0 + sr;
      s_inv[sr] = l > 0.f ? 1.f / l : 0.f;
      if (gr < rows)
        a.lse[(static_cast<int64_t>(bi) * a.kvh + hk) * rows + gr] =
            m_r + logf(l > 0.f ? l : 1.f);
    }
  }
  __syncthreads();  // the ring is free, 1 / l written

  // the key groups' O sums meet in the ring; group 0 adds them in group
  // order and writes O for the block's rows below S * G
  float* red = ring;                              // [kSplit - 1][R][kP]
  if (kg > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* x = red + ((kg - 1) * R + 8 * qy + i) * kP + 4 * tx;
      reinterpret_cast<float4*>(x)[0] = make_float4(acc[i][0], acc[i][1],
                                                    acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(x + 64)[0] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * qy + i;
      const int gr = row0 + r;
      if (gr >= rows) continue;
      const float inv = s_inv[r];
      float* out = a.o + row_offset(a, bi, hk, gr) + 4 * tx;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 o = make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                               acc[i][4 * half + 2], acc[i][4 * half + 3]);
#pragma unroll
        for (int g = 1; g < T::kSplit; ++g) {
          float4 y = *reinterpret_cast<const float4*>(
              red + ((g - 1) * R + r) * kP + 64 * half + 4 * tx);
          o.x += y.x;
          o.y += y.y;
          o.z += y.z;
          o.w += y.w;
        }
        o.x *= inv;
        o.y *= inv;
        o.z *= inv;
        o.w *= inv;
        *reinterpret_cast<float4*>(out + 64 * half) = o;
      }
    }
  }
}

// Launch the kernel in tiles of R rows x K keys on `stream`; returns
// cudaGetLastError() (0 = ok).
template <int R, int K>
int launch(const Args& a, cudaStream_t stream) {
  const int nrt = (a.s * a.g + R - 1) / R;
  if (a.lk % K != 0 || nrt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the dynamic shared memory allowed
  const size_t smem = Tiles<R, K>::kFloats * sizeof(float)
                      + ((static_cast<size_t>(a.lk / K) + 15) / 16) * 16;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gqa_fwd_f32_kernel<R, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  dim3 grid(a.b * a.kvh, nrt);
  gqa_fwd_f32_kernel<R, K><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2, f32 at D = 128. q, o (B, S, H, D); k, v (B, Lk, KVH, D), each
// 16-byte aligned; kv_valid (B, Lk) int32; lse (B, KVH, S * H / KVH) f32;
// bq, bk: the Pallas kernel's blocks, which fix each row's frontier.
// rows: the tile, 64 (wide) or 32 (narrow) folded rows a block; Lk must
// be a multiple of its key tile (gqa_flash_fwd_f32_keys). walked: null,
// or (B * KVH, ceil(S * G / rows)) int32 that gets each row block's count
// of walked key tiles. Launches on `stream`; returns cudaGetLastError()
// (0 = ok).
extern "C" int gqa_flash_fwd_f32(const float* q, const float* k,
                                 const float* v, const int* kv_valid,
                                 float* o, float* lse, int b, int s, int lk,
                                 int h, int kvh, int d, int causal, int bq,
                                 int bk, float sm_scale, int rows,
                                 int* walked, void* stream) {
  if (d != kD || kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0
      || (causal && lk < s) || (rows != kWideR && rows != kNarrowR))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const int g = h / kvh;
  int g_shift = -1;
  for (int e = 0; e < 31; ++e)
    if ((1 << e) == g) g_shift = e;
  Args a{q, k, v, kv_valid, o, lse, walked, b, s, lk, h, kvh, g, g_shift,
         causal, causal ? lk - s : 0, bq, bk, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == kWideR ? launch<kWideR, kWideK>(a, st)
                        : launch<kNarrowR, kNarrowK>(a, st);
}

// The keys a tile of `rows` folded rows walks at a time (0: no such
// tile); ops/flash_gqa.py:FWD_F32_TILES.
extern "C" int gqa_flash_fwd_f32_keys(int rows) {
  return rows == kWideR ? kWideK : rows == kNarrowR ? kNarrowK : 0;
}
