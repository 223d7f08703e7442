// Flash attention forward for Hopper, the SIMT template: kernels K2 and
// K3 of the port at the shapes their faster kernels do not take. K2 at
// D = 128 runs on csrc/flash_gqa_f32.cu (f32, FFMA) and, with G dividing
// 128, csrc/flash_gqa_sm90.cu (bf16, wgmma and TMA); every other K2
// shape runs here (ops/flash_gqa.py:fwd_route). K3 at
// D = 64 runs on csrc/flash_attn_f32.cu (f32, FFMA) and
// csrc/flash_attn_sm90.cu (bf16, wgmma and TMA); K3 at every other head
// dim in either type runs here (ops/flash_attention.py:fwd_route). Head
// dims 64, 128, 256, 384 and 512 are built; ops/flash_attention.py pads
// any other K3 width up to 512 with zero columns, and both wrappers
// refuse a wider one.
//
// K2 replaces wedetect_tpu/ops/flash_gqa.py:_fwd_kernel (the Pallas TPU
// kernel behind gqa_flash_attention): native grouped KV, end-aligned
// rectangular causal (query i sits at key position off + i, off = Lk - S),
// kv_valid key masking, f32 online softmax, O in the input type and the
// per-row logsumexp in f32.
// K3 replaces the stock Pallas TPU flash_attention that
// wedetect_tpu/ops/attention.py:_flash_attention calls (the Qwen3-VL
// ViT): square attention, non-causal with segment ids (a key is masked
// where its segment differs from the query's) or square causal.
//
// One template serves both. Layouts are the JAX package's public ones,
// read in place with no transpose: q and o (B, S, H, D), k and v
// (B, Lk, KVH, D), H = KVH * G. The G query heads of one kv head are
// folded into the row axis: folded row r is query position r / G and
// head kvh * G + r % G (flash_gqa.py:17-21, _to_grouped_q), so a block
// reads its kv head's K and V once for all G heads. K3 is G = 1.
//
// Which keys a row sees. A key at or past the row's frontier F is
// absent (weight 0); a key below F that the mask rejects has logit
// -1e30 (flash_gqa.py _NEG, not -inf). K2's F is the Pallas kernel's
// causal tile frontier, min(Lk, bk * ceil((off + (qb + 1) * bq) / bk))
// for the row's query block qb at JAX's bq and bk (the wrapper passes
// them; flash_common.cuh), or Lk when not causal; so a row whose
// scanned keys are all masked returns the mean of V over those keys, as
// the Pallas kernel does. K3's F is q + 1 when causal, else L; its mask is the segment
// test. The key loop of a block runs to the largest F among its rows.
//
// Design (simple, right first): a block holds BR folded rows and 256
// threads; key tiles of BK keys are staged in dynamic shared memory as
// f32. BR = BK = 64 up to D = 256 (Q 33 KB, K 33 KB, V 32 KB, logits
// 17 KB at D = 128; 210 KB in all at D = 256), 32 at D = 384 and 512
// (197 KB at D = 512). Logits are scalar FMAs into a BR/16 x BK/16
// register tile per thread, the row softmax is one warp per row, and
// each thread keeps a BR/16 x D/16 slice of the f32 output accumulator
// in registers. In bf16, p is rounded to bf16 before the p.V product, as
// the Pallas kernel casts p to V's type; l sums the unrounded p. No
// tensor cores, TMA or pipelining yet.
//
// Bound on the H100: 4 * B * H * D * (visible (query, key) pairs) FLOPs
// against 67 TFLOP/s f32 (no tensor cores) or 989 TFLOP/s bf16, and the
// bytes of q, k, v read once plus O and lse written once at 3.35 TB/s;
// at the Ref path's shapes the FLOPs bound it. This SIMT design runs
// far below the f32 rate (shared-memory operand loads per FMA);
// wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid, 8 warps

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_valid;  // K2: (B, Lk) 0/1, or null (all valid)
  const int* q_seg;     // K3: (B, L) segment ids, or null (one segment)
  const int* kv_seg;
  void* o;
  float* lse;           // (B, KVH, S * G)
  int b, s, lk, h, kvh, g;
  int causal, off, bq, bk;
  float sm_scale;
};

// The row's frontier F: keys at or past it are absent.
template <bool kSeg>
__device__ __forceinline__ int frontier(const Args& a, int qi) {
  if (!a.causal) return a.lk;
  if (kSeg) return qi + 1;
  return gqa_frontier(qi, a.lk, a.off, a.bq, a.bk);
}

// BR folded rows a block, BK keys a tile
template <typename T, int D, bool kSeg, int BR, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int QP = D + 1;      // padded pitches: no bank conflicts
  constexpr int SP = BK + 1;
  constexpr int RI = BR / 16;    // rows per thread
  constexpr int CJ = BK / 16;    // keys per thread
  constexpr int KL = BK / 32;    // keys per lane in the row softmax
  constexpr int DJ = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BR][QP]
  float* Ks = Qs + BR * QP;             // [BK][QP]
  float* Vs = Ks + BK * QP;             // [BK][D]
  float* Ss = Vs + BK * D;              // [BR][SP]
  float* s_m = Ss + BR * SP;            // [BR]
  float* s_l = s_m + BR;
  float* s_alpha = s_l + BR;
  int* s_f = reinterpret_cast<int*>(s_alpha + BR);  // [BR] frontier
  int* s_qtag = s_f + BR;               // [BR] qpos (K2) / segment (K3)
  int* s_ktag = s_qtag + BR;            // [BK] valid (K2) / segment (K3)

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BR;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = a.s * a.g;

  auto row_offset = [&](int gr) -> int64_t {
    int qi = gr / a.g;
    int head = hk * a.g + gr % a.g;
    return ((static_cast<int64_t>(bi) * a.s + qi) * a.h + head) * D;
  };

  // row metadata and the Q tile
  if (tid < BR) {
    int gr = row0 + tid;
    int f = 0, tag = 0;
    if (gr < rows) {
      int qi = gr / a.g;
      f = frontier<kSeg>(a, qi);
      tag = kSeg ? (a.q_seg ? a.q_seg[static_cast<int64_t>(bi) * a.s + qi] : 0)
                 : a.off + qi;
    }
    s_f[tid] = f;
    s_qtag[tid] = tag;
    s_m[tid] = kNeg;
    s_l[tid] = 0.f;
  }
  for (int idx = tid; idx < BR * D; idx += kThreads) {
    int r = idx / D, dd = idx % D;
    int gr = row0 + r;
    Qs[r * QP + dd] = gr < rows ? to_f<T>(q[row_offset(gr) + dd]) : 0.f;
  }
  // frontier of the block: F grows with the row, so the last live row's
  int last = min(row0 + BR, rows) - 1;
  int fmax = frontier<kSeg>(a, last / a.g);
  int ntiles = (fmax + BK - 1) / BK;

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int64_t kv_base = static_cast<int64_t>(bi) * a.lk;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile's K, V and p are consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      int kk = idx / D, dd = idx % D;
      int key = k0 + kk;
      float kvk = 0.f, kvv = 0.f;
      if (key < a.lk) {
        int64_t off = ((kv_base + key) * a.kvh + hk) * D + dd;
        kvk = to_f<T>(k[off]);
        kvv = to_f<T>(v[off]);
      }
      Ks[kk * QP + dd] = kvk;
      Vs[kk * D + dd] = kvv;
    }
    if (tid < BK) {
      int key = k0 + tid;
      int tag = 0;
      if (key < a.lk) {
        if (kSeg)
          tag = a.kv_seg ? a.kv_seg[kv_base + key] : 0;
        else
          tag = a.kv_valid ? (a.kv_valid[kv_base + key] != 0) : 1;
      }
      s_ktag[tid] = tag;
    }
    __syncthreads();

    // logits: rows ty + 16 i, keys tx + 16 j
    float sc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qa[RI], kb[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qa[i] = Qs[(ty + 16 * i) * QP + dd];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kb[j] = Ks[(tx + 16 * j) * QP + dd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        int c = tx + 16 * j;
        int key = k0 + c;
        bool ok = kSeg ? (s_ktag[c] == s_qtag[r])
                       : gqa_key_ok(s_ktag[c], key, s_qtag[r], a.causal);
        float val = ok ? sc[i][j] * a.sm_scale : kNeg;
        Ss[r * SP + c] = key < s_f[r] ? val : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < BR; r += kThreads / 32) {
      float x[KL];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < KL; ++c) {
        x[c] = Ss[r * SP + lane + 32 * c];
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      float m_old = s_m[r];
      float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KL; ++c) {
        float p = expf(x[c] - m_new);
        sum += p;
        Ss[r * SP + lane + 32 * c] = to_f<T>(from_f<T>(p));
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      if (lane == 0) {
        float alpha = expf(m_old - m_new);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float al = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = Ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    int r = ty + 16 * i;
    int gr = row0 + r;
    if (gr >= rows) continue;
    float l = s_l[r];
    float safe_l = l > 0.f ? l : 1.f;
    int64_t base = row_offset(gr);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      float val = l > 0.f ? acc[i][j] / safe_l : 0.f;
      o[base + tx + 16 * j] = from_f<T>(val);
    }
    if (tx == 0)
      a.lse[(static_cast<int64_t>(bi) * a.kvh + hk) * rows + gr] =
          s_m[r] + logf(safe_l);
  }
}

size_t shared_bytes(int d, int br, int bk) {
  size_t floats = static_cast<size_t>(br) * (d + 1)    // Q
                  + static_cast<size_t>(bk) * (d + 1)  // K
                  + static_cast<size_t>(bk) * d        // V
                  + static_cast<size_t>(br) * (bk + 1)
                  + 3 * br;                            // m, l, alpha
  size_t ints = 2 * br + bk;
  return floats * sizeof(float) + ints * sizeof(int);
}

// 64 x 64 tiles up to D = 256 (210 KB of shared memory at D = 256);
// 32 x 32 at D = 384 and 512 (151 KB, 201 KB: 64 x 64 would need 296 KB
// and 394 KB). 32 divides every JAX key block bk (>= 128), so no K2
// frontier splits a tile
template <typename T, int D, bool kSeg>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int B = D > 256 ? 32 : 64;
  auto kern = flash_fwd_kernel<T, D, kSeg, B, B>;
  size_t smem = shared_bytes(D, B, B);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((a.s * a.g + B - 1) / B, a.kvh, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSeg>
int dispatch(const Args& a, int d, int bf16, cudaStream_t stream) {
  if (d == 64)
    return bf16 ? launch<__nv_bfloat16, 64, kSeg>(a, stream)
                : launch<float, 64, kSeg>(a, stream);
  if (d == 128)
    return bf16 ? launch<__nv_bfloat16, 128, kSeg>(a, stream)
                : launch<float, 128, kSeg>(a, stream);
  if (d == 256)   // 210 KB of shared memory
    return bf16 ? launch<__nv_bfloat16, 256, kSeg>(a, stream)
                : launch<float, 256, kSeg>(a, stream);
  if (d == 384)
    return bf16 ? launch<__nv_bfloat16, 384, kSeg>(a, stream)
                : launch<float, 384, kSeg>(a, stream);
  if (d == 512)
    return bf16 ? launch<__nv_bfloat16, 512, kSeg>(a, stream)
                : launch<float, 512, kSeg>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K2 at the shapes csrc/flash_gqa_f32.cu and csrc/flash_gqa_sm90.cu do
// not take (ops/flash_gqa.py:fwd_route: D = 64, 256, 384 or 512, or bf16
// with G not dividing 128).
// q, o (B, S, H, D); k, v (B, Lk, KVH, D); kv_valid (B, Lk) int32; lse
// (B, KVH, S * H / KVH) f32. bq, bk: the Pallas kernel's query and key
// blocks (flash_gqa._pick_bq / _pick_bk), which fix each row's
// frontier. Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int gqa_flash_fwd(const void* q, const void* k, const void* v,
                             const int* kv_valid, void* o, float* lse,
                             int b, int s, int lk, int h, int kvh, int d,
                             int causal, int bq, int bk, float sm_scale,
                             int bf16, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, kv_valid, nullptr, nullptr, o, lse,
         b, s, lk, h, kvh, h / kvh,
         causal, causal ? lk - s : 0, bq, bk, sm_scale};
  return dispatch<false>(a, d, bf16, static_cast<cudaStream_t>(stream));
}

// K3 at the head dims csrc/flash_attn_f32.cu and csrc/flash_attn_sm90.cu
// do not take (ops/flash_attention.py:fwd_route: f32 or bf16 off D = 64).
// q, k, v, o (B, L, H, D), D one of 64, 128, 256, 384, 512; q_seg,
// kv_seg (B, L) int32 or both null; lse (B, H, L) f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* q_seg,
                                   const int* kv_seg, void* o, float* lse,
                                   int b, int l, int h, int d, int causal,
                                   float sm_scale, int bf16, void* stream) {
  Args a{q, k, v, nullptr, q_seg, kv_seg, o, lse,
         b, l, l, h, h, 1,
         causal, 0, 1, 1, sm_scale};
  return dispatch<true>(a, d, bf16, static_cast<cudaStream_t>(stream));
}
