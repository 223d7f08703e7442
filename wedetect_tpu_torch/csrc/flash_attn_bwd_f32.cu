// K3's dk/dv backward in f32 for Hopper (sm_90a): register tiles on FFMA
// fed by 128-bit shared-memory loads and a cp.async ring. Kernel
// K3-bwd-dkv, f32 at D = 64 (the Qwen3-VL ViT's head dim).
//
// Replaces the stock Pallas TPU kernel _flash_attention_dkv_kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py:796, `pallas_call`
// at :1121, the custom VJP of the flash attention that
// wedetect_tpu/ops/attention.py:_flash_attention calls) for f32 inputs at
// D = 64 (ops/flash_attention.py:dkv_route). K3-bwd-dq in f32 and dk/dv
// at other head dims stay on the SIMT kernels of csrc/flash_attn_bwd.cu,
// bf16 at D = 64 on csrc/flash_attn_bwd_sm90.cu. The contract is theirs
// (ops/flash_attention.py:flash_attention_bwd_plain): q, k, v, dO, dk, dv
// (B, L, H, D) read and written in place; lse and delta = rowsum(dO * O)
// f32 (B, H, L); optional segment ids (B, L) for the rows and the keys.
// Row r sees keys [0, F_r) with F_r = r + 1 under `causal`, else L; a key
// of another segment has logit -1e30. p = exp(s - lse) with s = q.k *
// scale (or -1e30) on keys below F_r and 0 past it; ds = p * (dO.V^T -
// delta) * scale; dv = sum p^T.dO, dk = sum ds^T.Q over the rows, all in
// f32. A block owns its keys: no atomics, and dk and dv repeat bit for
// bit.
//
// Bound on the H100: 8 * D FLOPs per visible (row, key) pair and head at
// 67 TFLOP/s f32 (FFMA; no TF32, so the f32 limits hold), against q, k,
// v, dO, lse and delta read once and dk, dv written once at 3.35 TB/s. At
// the training path's ViT shape (1, 4224, 16, 64), 4144 real tokens and
// 80 pad tokens in segment 0, the FLOPs bound it: 2.100 ms.
//
// Design. A block owns 128 keys of one (batch, head) and walks the rows
// in tiles of 64; 256 threads, one block an SM.
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
// - The walk. A row tile is skipped when none of its pairs can change dk
//   or dv: every row r is past L, or lies before the block's first key
//   under `causal`, or shares no segment with a key of the block at or
//   before it (causal) or anywhere in it, with lse_r > -1e29, where
//   p = exp(-1e30 - lse_r) is exactly +0 and ds is +-0. A row with
//   lse <= -1e29 keeps its tiles. The block's keys are read once as runs
//   of one segment id (the id and the run's first key), and one warp
//   tests each tile's 64 rows against them with a ballot before the walk
//   (ops/flash_attention.py:dkv_tile_walked is the same rule); a block
//   that walks nothing writes zeros. At the training shape the rule skips
//   the pad rows' tile for every block of real keys only: 2146 of 2178
//   tiles a head are walked.
// - Grid (B * H, ceil(L / 128)): 528 blocks at the training shape, four
//   waves of 132. With 64 keys a block (8 x 4 tiles, 1056 blocks: 10.7
//   FFMA a load, and twice the row-tile passes) the kernel took 8% longer
//   (PERF.md §6, tools/time_k3_bwd.py --variant).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBK = 128;                   // keys a block (DKV_F32_KEYS)
constexpr int kBR = 64;                    // rows a tile
constexpr int kThreads = 256;
constexpr int kP = kD + 4;                 // Q, dO, K, V pitch (floats)
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
constexpr size_t kSmemMax = 232448 - 1024;  // an H100 block's, less static
constexpr float kLseNone = -1e29f;         // lse above it: p = +0 at kNeg
constexpr float kLog2e = 1.4426950408889634f;

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

  // the block's keys below L as runs of one segment id: a key starts a
  // run when it is the block's first or its id differs from the key's
  // before it
  bool start = false;
  int kseg = 0;
  if (warp < kBK / 32) {
    const int key = k0 + tid;
    if (key < a.l) {
      kseg = a.kv_seg ? a.kv_seg[seg_base + key] : 0;
      start = tid == 0 || (a.kv_seg && kseg != a.kv_seg[seg_base + key - 1]);
    }
    s_kseg[tid] = kseg;
    unsigned m = __ballot_sync(0xffffffffu, start);
    if (lane == 0) s_starts[warp] = m;
  }
  __syncthreads();
  int n_runs = 0, i_run = 0;
#pragma unroll
  for (int w = 0; w < kBK / 32; ++w) {
    if (w == warp) i_run = n_runs + __popc(s_starts[w] & ((1u << lane) - 1u));
    n_runs += __popc(s_starts[w]);
  }
  if (start) {
    s_run_seg[i_run] = kseg;
    s_run_first[i_run] = k0 + tid;
  }
  __syncthreads();

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

// Shared memory of one block for L rows (bytes).
size_t smem_bytes(int l) {
  int ntiles = (l + kBR - 1) / kBR;
  return kSmemFixed + ((static_cast<size_t>(ntiles) + 15) / 16) * 16;
}

}  // namespace

// K3-bwd-dkv, f32 at D = 64. q, k, v, dout, dk, dv (B, L, H, 64), each
// 16-byte aligned; q_seg, kv_seg (B, L) int32 or both null; lse, delta
// (B, H, L) f32. Launches on `stream`; returns cudaGetLastError()
// (0 = ok).
extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k,
                                           const float* v, const int* q_seg,
                                           const int* kv_seg,
                                           const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int b, int l, int h,
                                           int d, int causal, float sm_scale,
                                           void* stream) {
  if (d != kD || b <= 0 || l <= 0 || h <= 0
      || (q_seg == nullptr) != (kv_seg == nullptr)
      || (l + kBK - 1) / kBK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
  size_t smem = smem_bytes(l);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 0;  // the dynamic shared memory allowed
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  Args a{q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, b, l, h, causal,
         sm_scale};
  dim3 grid(b * h, (l + kBK - 1) / kBK);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
