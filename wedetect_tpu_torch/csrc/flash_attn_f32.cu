// K3 in f32 for Hopper (sm_90a): register tiles on FFMA fed by 128-bit
// shared-memory loads and a cp.async ring. Kernel K3 (the square flash
// attention forward with segment ids), f32 at D = 64 (the Qwen3-VL ViT's
// head dim).
//
// Replaces the stock Pallas TPU kernel _flash_attention_kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:331, `pallas_call`
// at :758 through _flash_attention_impl :589) that
// wedetect_tpu/ops/attention.py:_flash_attention (:126) calls, for f32
// inputs at D = 64 (ops/flash_attention.py:fwd_route). f32 at other head
// dims stays on the SIMT template of csrc/flash_attn.cu, bf16 at D = 64
// is csrc/flash_attn_sm90.cu. The contract is theirs
// (ops/flash_attention.py:flash_attention_plain): q, k, v, o (B, L, H, D)
// read and written in place; optional segment ids (B, L) int32 for the
// rows and the keys (they may differ); lse f32 (B, H, L), natural log.
// Row r scans keys [0, F_r), F_r = r + 1 under `causal`, else L; a
// scanned key of another segment has logit -1e30 and a key at or past
// F_r is absent. So a row whose segment no scanned key carries returns
// the mean of V over [0, F_r) with lse = -1e30 + log F_r <= -1e29
// (K3-bwd's skip rule reads that).
//
// Bound on the H100: 4 * D FLOPs per visible (row, key) pair and head at
// 67 TFLOP/s f32 (FFMA; no TF32, so the f32 limits hold), against q, k, v
// read once and O and lse written once at 3.35 TB/s. At the ViT shapes,
// 80 pad tokens in segment 0 not causal, the FLOPs bound it: 0.088 ms at
// (1, 1280, 16, 64) (1200 real tokens), 1.050 ms at (1, 4224, 16, 64)
// (4144 real tokens).
//
// The skip rule (ops/flash_attention.py:fwd_tile_walked): a (row block,
// key tile) pair is walked when some row of the block lies below L (and,
// under causal, at or after the tile's first key) and either shares its
// segment with a key of the tile below L (causal: one at or before the
// row) or has no key of its segment below its frontier at all (it needs
// every key below F_r for the mean of V). For a row that sees a key of
// its segment, a skipped tile holds only keys at -1e30 or past F_r:
// before that key they are erased by alpha = exp(-1e30 - m) = 0, after it
// they add exp(-1e30 - m) = +0. So the walk changes the time and nothing
// else. The prologue reads the block's rows once as runs of one segment
// id (segments.cuh:segment_runs); one warp a key tile then tests the
// tile's keys against the runs with ballots, and records each run's first
// key of its id on the way (a shared atomicMin), which gives the rows
// with no key of their segment below their frontier. With a non-null
// `walked`, each block also writes how many tiles it walked (a check of
// the rule; null on the main path).
//
// Design. A block owns R rows of one (batch, head) and walks the keys in
// tiles of kK = 64; 256 threads, one block an SM. Two tiles: the wide one,
// R = 128, and the narrow one, R = 64, for grids where the wide blocks'
// last wave would cost more than the narrow blocks' extra waves
// (ops/flash_attention.py:fwd_f32_tile; the ViT at a 480x640 image: 160
// wide blocks on 132 SMs). In the wide tile:
// - Operands. Q (the block's rows, resident) and each key tile's K and V
//   are staged row-major with D contiguous at a pitch of 68 floats: a
//   multiple of 4, so every operand is one LDS.128, and 4 banks apart from
//   row to row. S = Q.K^T splits D in two halves of 32, one a half of the
//   block; a thread holds an 8 x 8 tile (rows y + 16 i, keys x + 8 j, for
//   thread u of its half x = u % 8, y = u / 8): per 4 of D, 16 LDS.128 for
//   256 FFMA. Each half writes its sums to its own buffer ([row][key],
//   pitch 72: the four rows a warp writes are 8 banks apart), and the
//   softmax adds the two in half order.
// - Online softmax. Two threads own a row and 32 of the tile's keys each
//   (float4 reads, conflict-free): the row max takes one shfl_xor, m stays
//   in registers, each thread keeps its own share of l (summed once at the
//   end), and alpha goes to shared memory once a tile. p = 2^((x - m)
//   log2 e) on ex2.approx.ftz (flash_common.cuh:exp2_approx), m (and so
//   lse) in natural units. P is stored row-major in place of the first S
//   half (each element is read and written by the same thread).
// - O += P.V splits the tile's keys into two groups of 32, one a half of
//   the block; each thread of a group holds an 8 x 8 tile of O (rows
//   y + 16 i, D columns 4 x + c and 32 + 4 x + c) for the whole walk,
//   rescaled by alpha each tile: per 4 keys, 8 LDS.128 of P (4 keys a
//   load) and 8 of V for 256 FFMA. At the end the groups' sums meet in
//   shared memory (the ring, free by then) and are added in group order,
//   so O repeats bit for bit. This is K3-bwd-dq's dQ loop
//   (csrc/flash_attn_bwd_f32.cu) with P in place of dS and V of K.
// - Ring. While a tile's products run, cp.async copies the next walked key
//   tile's K and V (256-byte rows in 16-byte chunks, keys past L
//   zero-filled) and its segment ids into the other of two stages. Shared
//   memory, in floats: Q 128 x 68 = 8704 (34.8 KB), K and V 2 stages x 2 x
//   64 x 68 = 17408 (69.6 KB), the S halves (P in the first) 2 x 128 x 72
//   = 18432 (73.7 KB), the rows' alpha, 1 / l, segment ids and runs and
//   the keys' segment ids 900 (3.6 KB); 181.8 KB, plus one byte a key tile
//   for the walk.
// - The walk: the key tiles the rule keeps for the block's rows, in
//   order; inside a walked tile a key is still absent past each row's own
//   F_r. At (1, 4224, 16, 64) the rule skips the pad keys' tile for every
//   block of real rows only: 32 x 65 + 66 = 2146 of the 2178 tiles a head
//   (at (1, 1280, 16, 64) in the narrow tile 18 x 19 + 20 + 2 = 364 of
//   400: the pad-only row block walks the two tiles that hold pad keys).
// - Order. Grid (B * H, ceil(L / R)), the last row block first: under
//   causal masking the longest walks start first and the tail is short.
// The narrow tile keeps the same loops with 4 x 8 register tiles (rows
// y + 16 i, i < 4: 10.7 FFMA a load) and four threads a row in the
// softmax (126.0 KB of shared memory). Probes (PERF.md §6,
// tools/time_k3.py --variant): the narrow tile took 9% less at
// (1, 1280, 16, 64) and 20% more at (1, 4224, 16, 64); the S or the P.V
// loop unrolled whole 0.3-1.7% less (not adopted: the loop then no longer
// shows in the SASS check).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"
#include "segments.cuh"

namespace {

constexpr int kD = 64;
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, K, V pitch (floats)
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kNone = 0x7fffffff;          // no key of a run's id

// The two tiles, rows a block (ops/flash_attention.py:FWD_F32_TILES): the
// wide one, and the narrow one for grids whose wide blocks would leave a
// costly last wave (fwd_f32_tile); both walk kK keys at a time
constexpr int kWideR = 128, kNarrowR = 64;
constexpr int kK = 64;                     // keys a tile
constexpr int kSP = kK + 8;                // S halves' pitch (floats)
constexpr int kDH = kD / 2;                // S: D a half
constexpr int kKG = kK / 2;                // P.V: keys a group
constexpr int kSUnroll = 4;                // S: steps of 4 of D unrolled
constexpr int kPVUnroll = 4;               // P.V: steps of 4 keys unrolled
constexpr int kStage = 2 * kK * kP;        // K and V of one tile

// The shapes that follow from a block of R rows.
template <int R>
struct Tiles {
  static constexpr int kRI = R / 16;       // S, O: rows a thread
  static constexpr int kTPR = kThreads / R;  // softmax: threads a row
  static constexpr int kKPT = kK / kTPR;   // softmax: keys a thread
  // the keys' segment ids (2 stages); the rows' alpha, 1 / l and segment
  // ids; the row runs' ids, first rows and first keys of their id; the
  // run-start ballots
  static constexpr int kMeta = 2 * kK + 3 * R + 3 * R + R / 32;
  static constexpr int kFloats = R * kP + 2 * kStage + 2 * R * kSP + kMeta;
  static_assert(R == kWideR || R == kNarrowR, "K3 f32: 128 or 64 rows");
  static_assert(kFloats * sizeof(float) + 64 <= kSmemMax,
                "K3 f32: the tiles fit in a block's shared memory");
  static_assert(R * kP <= 2 * kStage,
                "the key groups' O sums fit in the ring");
  static_assert(kKPT % 4 == 0, "softmax: whole float4 runs of keys");
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* q_seg;     // (B, L), or null (one segment)
  const int* kv_seg;
  float* o;
  float* lse;           // (B, H, L)
  int* walked;          // tiles walked a block (B * H, row blocks), or null
  int b, l, h, causal;
  float sm_scale;
};

// Element offset of row (or key) r of head hi, batch bi, in (B, L, H, D).
__device__ __forceinline__ int64_t row_offset(const Args& a, int bi, int hi,
                                              int r) {
  return ((static_cast<int64_t>(bi) * a.l + r) * a.h + hi) * kD;
}

// Copy the block's R rows of Q from row0 on into shared memory
// (cp.async; rows past L zero-filled).
template <int R>
__device__ __forceinline__ void load_rows(const Args& a, int bi, int hi,
                                          int row0, float* Qs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int m = 0; m < R * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < a.l;
    int64_t off = in ? row_offset(a, bi, hi, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
  }
}

// Copy key tile kt's K, V (cp.async, keys past L zero-filled) and segment
// ids into one stage.
__device__ __forceinline__ void load_key_tile(const Args& a, int bi, int hi,
                                              int kt, float* Ks, int* kseg) {
  const int tid = threadIdx.x;
  const int k0 = kt * kK;
  float* Vs = Ks + kK * kP;
#pragma unroll
  for (int m = 0; m < kK * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int kk = c / (kD / 4), ch = c % (kD / 4);
    int key = k0 + kk;
    bool in = key < a.l;
    int64_t off = in ? row_offset(a, bi, hi, key) + ch * 4 : 0;
    cp_async16(Ks + kk * kP + ch * 4, a.k + off, in);
    cp_async16(Vs + kk * kP + ch * 4, a.v + off, in);
  }
  if (tid < kK) {
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

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const Args a) {
  using T = Tiles<R>;
  constexpr int kRI = T::kRI, kTPR = T::kTPR, kKPT = T::kKPT;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [R][kP]
  float* ring = Qs + R * kP;                 // 2 x {K, V} [kK][kP]
  float* S0 = ring + 2 * kStage;             // S, first half of D; then P
  float* S1 = S0 + R * kSP;                  // S, second half of D
  int* s_kseg = reinterpret_cast<int*>(S1 + R * kSP);  // 2 x [kK]
  float* s_alpha = reinterpret_cast<float*>(s_kseg + 2 * kK);  // [R]
  float* s_inv = s_alpha + R;                // [R] 1 / l
  int* s_qseg = reinterpret_cast<int*>(s_inv + R);  // [R]
  int* s_run_seg = s_qseg + R;               // [R]
  int* s_run_first = s_run_seg + R;          // [R]
  int* s_run_fk = s_run_first + R;           // [R] first key of the id
  unsigned* s_starts = reinterpret_cast<unsigned*>(s_run_fk + R);
  unsigned char* walk = reinterpret_cast<unsigned char*>(s_starts + R / 32);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int hi = blockIdx.x % a.h;
  const int bi = blockIdx.x / a.h;
  const int nrb = gridDim.y;
  const int rb = nrb - 1 - blockIdx.y;       // the last rows first
  const int row0 = rb * R;
  const int nkt = (a.l + kK - 1) / kK;
  const int64_t seg_base = static_cast<int64_t>(bi) * a.l;

  load_rows<R>(a, bi, hi, row0, Qs);
  cp_async_commit();

  // the block's rows below L as runs of one segment id
  if (tid < R) s_run_fk[tid] = kNone;
  const int n_runs = segment_runs<R>(a.q_seg, seg_base, row0, a.l, s_qseg,
                                     s_run_seg, s_run_first, s_starts);
  const int rows_end = min(row0 + R, a.l);
  // under causal no row of the block scans a key at or past rows_end
  const int scan_end = a.causal ? rows_end : a.l;

  // the walk: warp w tests key tiles w, w + 8, ...; a tile is kept when a
  // key of it below L shares its segment with a run of the block's rows
  // (causal: a run that ends at or after the key). On the way each run
  // records the first key of its id (kNone: none scanned).
  for (int kt = warp; kt < nkt; kt += kThreads / 32) {
    const int k0 = kt * kK;
    bool keep = false;
    if (k0 < scan_end) {
#pragma unroll
      for (int half = 0; half < kK / 32; ++half) {
        const int key = k0 + 32 * half + lane;
        const bool in = key < a.l;
        const int ks = in && a.kv_seg ? a.kv_seg[seg_base + key] : 0;
        for (int i = 0; i < n_runs; ++i) {
          const bool same = in && ks == s_run_seg[i];
          const int last = (i + 1 < n_runs ? s_run_first[i + 1] : rows_end)
                           - 1;
          keep |= same && (!a.causal || last >= key);
          const unsigned m = __ballot_sync(0xffffffffu, same);
          if (lane == 0 && m)
            atomicMin(s_run_fk + i, k0 + 32 * half + __ffs(m) - 1);
        }
      }
    }
    const unsigned any = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) walk[kt] = any != 0;
  }
  __syncthreads();  // the tiles' segment tests and the runs' first keys
  // the last row that sees no key of its segment below its frontier (-1:
  // none): not causal, every row of a run whose id no key carries; causal,
  // the rows of a run before its id's first key. Such a row keeps every
  // tile below its frontier.
  int dead_last = -1;
  for (int i = 0; i < n_runs; ++i) {
    const int end = i + 1 < n_runs ? s_run_first[i + 1] : rows_end;
    const int fk = s_run_fk[i];
    const int last = a.causal ? min(end, fk) - 1 : (fk == kNone ? end - 1
                                                                 : -1);
    if (last >= s_run_first[i]) dead_last = max(dead_last, last);
  }
  for (int kt = tid; kt < nkt; kt += kThreads)
    if (dead_last >= (a.causal ? kt * kK : 0)) walk[kt] = 1;
  __syncthreads();
  count_walked(a.walked, static_cast<int64_t>(blockIdx.x) * nrb + rb, walk,
               nkt);

  int t = next_walked(walk, 0, nkt);
  if (t < nkt) load_key_tile(a, bi, hi, t, ring, s_kseg);
  cp_async_commit();

  // S: the half hf of D, rows y + 16 i, keys x + 8 j; P.V: key group hf,
  // rows y + 16 i, D columns 4 x + c and 32 + 4 x + c
  const int hf = tid / (kThreads / 2);
  const int u = tid % (kThreads / 2);
  const int x = u & 7, y = u >> 3;
  float* Sh = hf ? S1 : S0;
  // the softmax: row sr, keys 4 (kTPR m + sq) + e
  const int sr = tid / kTPR, sq = tid % kTPR;
  const int gr_s = row0 + sr;
  const int f_r = gr_s < a.l ? (a.causal ? gr_s + 1 : a.l) : 0;
  const int qs_r = s_qseg[sr];
  float m_r = kNeg, l_r = 0.f;
  float acc[kRI][8];
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int stage = 0;
  while (t < nkt) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged; the previous tile fully consumed
    const int tn = next_walked(walk, t + 1, nkt);
    const float* Ks = ring + stage * kStage;
    const float* Vs = Ks + kK * kP;
    const int* kseg = s_kseg + stage * kK;
    if (tn < nkt)
      load_key_tile(a, bi, hi, tn, ring + (stage ^ 1) * kStage,
                    s_kseg + (stage ^ 1) * kK);
    cp_async_commit();

    // S over the half's 32 of D, into its buffer
    {
      const float* X = Qs + hf * kDH;
      const float* Y = Ks + hf * kDH;
      float sp[kRI][8];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sp[i][j] = 0.f;
#pragma unroll(kSUnroll)
      for (int d = 0; d < kDH; d += 4) {
        float4 xa[kRI], yb[8];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
          xa[i] = *reinterpret_cast<const float4*>(X + (y + 16 * i) * kP + d);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          yb[j] = *reinterpret_cast<const float4*>(Y + (x + 8 * j) * kP + d);
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sp[i][j] = fmaf(xa[i].x, yb[j].x, sp[i][j]);
            sp[i][j] = fmaf(xa[i].y, yb[j].y, sp[i][j]);
            sp[i][j] = fmaf(xa[i].z, yb[j].z, sp[i][j]);
            sp[i][j] = fmaf(xa[i].w, yb[j].w, sp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Sh[(y + 16 * i) * kSP + x + 8 * j] = sp[i][j];
    }
    __syncthreads();  // the S halves written

    // the online softmax of row sr over the thread's keys: the halves
    // added in order, the logit x = s * scale below the row's frontier
    // (kNeg across segments, -inf past F_r), p = 2^((x - m) log2 e) into
    // the first half's place
    {
      const int k0 = t * kK;
      float xs[kKPT];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int m = 0; m < kKPT / 4; ++m) {
        const int c = 4 * (kTPR * m + sq);
        float4 s = *reinterpret_cast<const float4*>(S0 + sr * kSP + c);
        const float4 s1 = *reinterpret_cast<const float4*>(S1 + sr * kSP
                                                           + c);
        s.x += s1.x;
        s.y += s1.y;
        s.z += s1.z;
        s.w += s1.w;
        const int4 ks4 = *reinterpret_cast<const int4*>(kseg + c);
        const float sv[4] = {s.x, s.y, s.z, s.w};
        const int ks[4] = {ks4.x, ks4.y, ks4.z, ks4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float xv = ks[e] == qs_r ? sv[e] * a.sm_scale : kNeg;
          xv = k0 + c + e < f_r ? xv : -CUDART_INF_F;
          xs[4 * m + e] = xv;
          mx = fmaxf(mx, xv);
        }
      }
#pragma unroll
      for (int sh = 1; sh < kTPR; sh <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m_r, mx);
      const float alpha = exp2_approx((m_r - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kKPT / 4; ++m) {
        const int c = 4 * (kTPR * m + sq);
        float4 p;
        p.x = exp2_approx((xs[4 * m] - m_new) * kLog2e);
        p.y = exp2_approx((xs[4 * m + 1] - m_new) * kLog2e);
        p.z = exp2_approx((xs[4 * m + 2] - m_new) * kLog2e);
        p.w = exp2_approx((xs[4 * m + 3] - m_new) * kLog2e);
        sum += p.x;
        sum += p.y;
        sum += p.z;
        sum += p.w;
        *reinterpret_cast<float4*>(S0 + sr * kSP + c) = p;
      }
      l_r = l_r * alpha + sum;
      m_r = m_new;
      if (sq == 0) s_alpha[sr] = alpha;
    }
    __syncthreads();  // P and alpha written

    // O = O * alpha + P.V over the key group's keys: warps 0-3 keys
    // [0, 32), warps 4-7 [32, 64)
    {
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const float al = s_alpha[y + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= al;
      }
      const int g0 = hf * kKG;
      const float* Vg = Vs + g0 * kP + 4 * x;
      const float* Pg = S0 + y * kSP + g0;
#pragma unroll(kPVUnroll)
      for (int c = 0; c < kKG; c += 4) {
        float4 w[kRI], z[4][2];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
          w[i] = *reinterpret_cast<const float4*>(Pg + 16 * i * kSP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          z[cc][0] = *reinterpret_cast<const float4*>(Vg + (c + cc) * kP);
          z[cc][1] = *reinterpret_cast<const float4*>(Vg + (c + cc) * kP
                                                      + 32);
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
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

  // each row's l (the threads' shares summed), lse = m + log l, and 1 / l
  // (0 where l = 0: rows past L)
  {
    float l = l_r;
#pragma unroll
    for (int sh = 1; sh < kTPR; sh <<= 1)
      l += __shfl_xor_sync(0xffffffffu, l, sh);
    if (sq == 0) {
      s_inv[sr] = l > 0.f ? 1.f / l : 0.f;
      if (gr_s < a.l)
        a.lse[(static_cast<int64_t>(bi) * a.h + hi) * a.l + gr_s] =
            m_r + logf(l > 0.f ? l : 1.f);
    }
  }
  __syncthreads();  // the ring is free, 1 / l written

  // the key groups' O sums meet in the ring; group 0 adds group 1's to its
  // own and writes O for the block's rows below L
  float* red = ring;                         // [R][kP]
  if (hf == 1) {
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      float* xr = red + (y + 16 * i) * kP + 4 * x;
      reinterpret_cast<float4*>(xr)[0] = make_float4(acc[i][0], acc[i][1],
                                                     acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(xr + 32)[0] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  __syncthreads();
  if (hf == 0) {
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int r = y + 16 * i;
      const int gr = row0 + r;
      if (gr >= a.l) continue;
      const float inv = s_inv[r];
      float* out = a.o + row_offset(a, bi, hi, gr) + 4 * x;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float4 g1 = *reinterpret_cast<const float4*>(
            red + r * kP + 32 * hh + 4 * x);
        float4 o = make_float4(acc[i][4 * hh], acc[i][4 * hh + 1],
                               acc[i][4 * hh + 2], acc[i][4 * hh + 3]);
        o.x = (o.x + g1.x) * inv;
        o.y = (o.y + g1.y) * inv;
        o.z = (o.z + g1.z) * inv;
        o.w = (o.w + g1.w) * inv;
        *reinterpret_cast<float4*>(out + 32 * hh) = o;
      }
    }
  }
}

// Launch the kernel in blocks of R rows on `stream`; returns
// cudaGetLastError() (0 = ok).
template <int R>
int launch(const Args& a, cudaStream_t stream) {
  const int nrb = (a.l + R - 1) / R;
  if (nrb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the dynamic shared memory allowed
  const size_t smem = Tiles<R>::kFloats * sizeof(float)
                      + ((static_cast<size_t>((a.l + kK - 1) / kK) + 15) / 16)
                        * 16;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  dim3 grid(a.b * a.h, nrb);
  flash_fwd_f32_kernel<R><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3, f32 at D = 64. q, k, v, o (B, L, H, 64), each 16-byte aligned;
// q_seg, kv_seg (B, L) int32 or both null; lse (B, H, L) f32. rows: the
// tile, 128 (wide) or 64 (narrow) rows a block. walked: null, or
// (B * H, ceil(L / rows)) int32 that gets each row block's count of
// walked key tiles. Launches on `stream`; returns cudaGetLastError()
// (0 = ok).
extern "C" int flash_attention_fwd_f32(const float* q, const float* k,
                                       const float* v, const int* q_seg,
                                       const int* kv_seg, float* o,
                                       float* lse, int b, int l, int h,
                                       int d, int causal, float sm_scale,
                                       int rows, int* walked, void* stream) {
  if (d != kD || b <= 0 || l <= 0 || h <= 0
      || (q_seg == nullptr) != (kv_seg == nullptr)
      || (rows != kWideR && rows != kNarrowR))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  Args a{q, k, v, q_seg, kv_seg, o, lse, walked, b, l, h, causal, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == kWideR ? launch<kWideR>(a, st) : launch<kNarrowR>(a, st);
}

// The keys a tile of `rows` rows walks at a time (0: no such tile);
// ops/flash_attention.py:FWD_F32_TILES.
extern "C" int flash_attention_fwd_f32_keys(int rows) {
  return rows == kWideR || rows == kNarrowR ? kK : 0;
}
