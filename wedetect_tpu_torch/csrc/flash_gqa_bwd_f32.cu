// K2's dk/dv backward in f32 for Hopper (sm_90a): register tiles on FFMA
// fed by 128-bit shared-memory loads and a cp.async ring. Kernel
// K2-bwd-dkdv, f32 at D = 128.
//
// Replaces wedetect_tpu/ops/flash_gqa.py:_dkdv_kernel (the Pallas TPU
// kernel of the grouped-KV flash attention's custom VJP, `pallas_call`
// at :308, reached through _bwd_grouped) for f32 inputs at D = 128
// (ops/flash_gqa.py:dkdv_route). K2-bwd-dq in f32, dk/dv at D = 64 or
// 256 and bf16 outside csrc/flash_gqa_bwd_sm90.cu stay on the SIMT
// kernels of csrc/flash_attn_bwd.cu. The contract is theirs
// (ops/flash_gqa.py:gqa_flash_attention_bwd_plain): q, dO (B, S, H, D)
// and k, v, dk, dv (B, Lk, KVH, D) read and written in place; folded row
// r is query r / G, head kvh * G + r % G; lse and delta = rowsum(dO * O)
// f32 (B, KVH, S * G) in folded order; each row scans keys [0, F) with
// the forward's frontier F and -1e30 for a masked key below F
// (flash_common.cuh); p = exp(s - lse) on scanned keys and 0 past F;
// ds = p * (dO.V^T - delta) * scale; dv = sum p^T.dO, dk = sum ds^T.Q
// over the rows (the G folded heads summed), all in f32. A block owns
// its keys: no atomics, and dk and dv repeat bit for bit.
//
// Bound on the H100: 8 * H * D FLOPs per visible (query, key) pair at
// 67 TFLOP/s f32 (FFMA; no TF32, so the f32 limits hold), against q, k,
// v, dO, lse and delta read once and dk, dv written once at 3.35 TB/s.
// At the training path's decoder shape (1, 2048, 16, 128 | 2048, 8),
// 1253 valid keys, the FLOPs bound it: 0.436 ms.
//
// Design. A block owns 64 keys of one (batch, kv head) and walks the
// folded rows in tiles of 32; 256 threads, one block an SM.
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
// - The walk. A row tile is skipped when none of its pairs can change dk
//   or dv: every row r has F_r <= the block's first key, or sees no
//   valid key of the block (each key invalid or after the row's
//   position) with lse_r > -1e29, where p = exp(-1e30 - lse_r) is
//   exactly +0 and ds is +-0. A row with lse ~ -1e30 (no visible valid
//   key anywhere: p = 1) keeps its tiles. One warp tests each tile's 32
//   rows with a ballot before the walk (ops/flash_gqa.py:
//   dkdv_tile_walked is the same rule); a block that walks nothing
//   writes zeros.
// - Order. Grid (B * KVH, Lk / 64): key block 0 of every (batch, head)
//   launches before key block 1 of any, so the longest causal walks
//   start first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kBK = 64;                    // keys a block
constexpr int kBR = 32;                    // folded rows a tile
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, dO, K, V pitch (floats)
constexpr int kPP = kBK + 16;              // p, ds pitch (floats)
constexpr int kKVFloats = 2 * kBK * kP;
constexpr int kStageFloats = 2 * kBR * kP;
// per stage: lse, delta (f32) and each row's frontier and position (int)
constexpr int kRowMeta = 4 * kBR;
constexpr int kSmemFloats = kKVFloats + 2 * kStageFloats + 2 * kBR * kPP
                            + 2 * kRowMeta;
constexpr size_t kSmemFixed = kSmemFloats * sizeof(float);
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLseNone = -1e29f;         // lse above it: p = +0 at kNeg
constexpr float kLog2e = 1.4426950408889634f;

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

// Copy row tile t's Q, dO, lse and delta into one stage (cp.async), and
// write its rows' frontiers and positions there (F = 0 past S * G).
__device__ __forceinline__ void load_tile(const Args& a, int bi, int hk,
                                          int t, float* Qs, float* dOs,
                                          float* meta) {
  const int rows = a.s * a.g;
  const int tid = threadIdx.x;
  const int row0 = t * kBR;
#pragma unroll
  for (int m = 0; m < kBR * (kD / 4) / kThreads; ++m) {
    int c = tid + m * kThreads;
    int r = c / (kD / 4), ch = c % (kD / 4);
    int gr = row0 + r;
    bool in = gr < rows;
    int64_t off = in ? row_offset(a, bi, hk, gr) + ch * 4 : 0;
    cp_async16(Qs + r * kP + ch * 4, a.q + off, in);
    cp_async16(dOs + r * kP + ch * 4, a.dout + off, in);
  }
  const int r = tid % kBR;
  const int gr = row0 + r;
  const bool in = gr < rows;
  if (tid < 2 * kBR) {
    int64_t st = (static_cast<int64_t>(bi) * a.kvh + hk) * rows
                 + (in ? gr : 0);
    cp_async4(meta + tid, (tid < kBR ? a.lse : a.delta) + st, in);
  } else if (tid < 3 * kBR) {
    int qi = row_query(a, gr);
    int* m = reinterpret_cast<int*>(meta + 2 * kBR);
    m[r] = in ? frontier(a, qi) : 0;
    m[kBR + r] = a.off + qi;
  }
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

  // the block's valid keys, and the first of them (INT_MAX: none)
  if (warp < 2) {
    int key = k0 + tid;
    bool ok = a.kv_valid[static_cast<int64_t>(bi) * a.lk + key] != 0;
    unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_vmask[warp] = m;
  }
  __syncthreads();
  const unsigned vm0 = s_vmask[0], vm1 = s_vmask[1];
  const int first_valid = vm0 ? k0 + __ffs(vm0) - 1
                          : vm1 ? k0 + 32 + __ffs(vm1) - 1 : 0x7fffffff;

  // the walk: warp w tests tiles w, w + 8, ...; a row keeps its tile
  // when its frontier passes k0 and it sees a valid key of the block
  // (causal: the first valid key at or before its position) or has
  // lse <= -1e29 (no visible valid key at all: p = 1 on scanned keys)
  const float* lse_bh = a.lse + (static_cast<int64_t>(bi) * a.kvh + hk)
                                    * rows;
  for (int t = warp; t < ntiles; t += kThreads / 32) {
    int gr = t * kBR + lane;
    bool keep = false;
    if (gr < rows) {
      int qi = row_query(a, gr);
      if (frontier(a, qi) > k0) {
        bool sees = a.causal ? first_valid <= a.off + qi
                             : first_valid != 0x7fffffff;
        keep = sees || lse_bh[gr] <= kLseNone;
      }
    }
    unsigned any = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) walk[t] = any != 0;
  }
  __syncthreads();

  int t = next_walked(walk, 0, ntiles);
  if (t < ntiles) {
    // K and V once, with the first walked tile
    for (int c = tid; c < kBK * (kD / 4); c += kThreads) {
      int kk = c / (kD / 4), ch = c % (kD / 4);
      int64_t off = ((static_cast<int64_t>(bi) * a.lk + k0 + kk) * a.kvh
                     + hk) * kD + ch * 4;
      cp_async16(Ks + kk * kP + ch * 4, a.k + off, true);
      cp_async16(Vs + kk * kP + ch * 4, a.v + off, true);
    }
    load_tile(a, bi, hk, t, stage0, stage0 + kBR * kP, s_meta);
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
      load_tile(a, bi, hk, tn, nQ, nQ + kBR * kP,
                s_meta + (stage ^ 1) * kRowMeta);
    }
    cp_async_commit();

    const float* X = (dp_half ? dOs : Qs) + (d_hi ? kD / 2 : 0);
    const float* Y = (dp_half ? Vs : Ks) + (d_hi ? kD / 2 : 0);
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD / 2; d += 4) {
      float4 xa[8], yb[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xa[i] = *reinterpret_cast<const float4*>(X + (ry + 4 * i) * kP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        yb[j] = *reinterpret_cast<const float4*>(Y + (kx + 16 * j) * kP + d);
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

    // S (into Ps) and dP (into DSs): the upper half of D's sums first,
    // then the lower half adds its own
    float* SP = dp_half ? DSs : Ps;
    if (d_hi) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          SP[(ry + 4 * i) * kPP + kx + 16 * j] = acc[i][j];
    }
    __syncthreads();  // upper halves written
    if (!d_hi) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* e = SP + (ry + 4 * i) * kPP + kx + 16 * j;
          *e = acc[i][j] + *e;
        }
    }
    __syncthreads();  // S and dP written

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

// Shared memory of one block for S * G folded rows (bytes).
size_t smem_bytes(int rows) {
  int ntiles = (rows + kBR - 1) / kBR;
  return kSmemFixed + ((static_cast<size_t>(ntiles) + 15) / 16) * 16;
}

}  // namespace

// K2-bwd-dkdv, f32 at D = 128. q, dout (B, S, H, D); k, v, dk, dv
// (B, Lk, KVH, D), each 16-byte aligned; kv_valid (B, Lk) int32; lse,
// delta (B, KVH, S * H / KVH) f32; bq, bk: the Pallas kernel's blocks,
// which fix each row's frontier. Lk must be a multiple of 64. Launches
// on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int gqa_flash_bwd_dkdv_f32(const float* q, const float* k,
                                      const float* v, const int* kv_valid,
                                      const float* dout, const float* lse,
                                      const float* delta, float* dk,
                                      float* dv, int b, int s, int lk, int h,
                                      int kvh, int d, int causal, int bq,
                                      int bk, float sm_scale, void* stream) {
  if (d != kD || kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0
      || lk % kBK != 0 || (causal && lk < s))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  size_t smem = smem_bytes(s * (h / kvh));
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the dynamic shared memory allowed
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gqa_bwd_dkdv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int g = h / kvh;
  int g_shift = -1;
  for (int e = 0; e < 31; ++e)
    if ((1 << e) == g) g_shift = e;
  Args a{q, k, v, dout, lse, delta, kv_valid, dk, dv, b, s, lk, h, kvh,
         g, g_shift, causal, causal ? lk - s : 0, bq, bk, sm_scale};
  dim3 grid(b * kvh, lk / kBK);
  gqa_bwd_dkdv_f32_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
