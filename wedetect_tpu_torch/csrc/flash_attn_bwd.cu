// Flash attention backward for Hopper: kernels K2-bwd and K3-bwd of the
// port.
//
// K2-bwd replaces the two Pallas TPU kernels of the grouped-KV flash
// attention's custom VJP, wedetect_tpu/ops/flash_gqa.py:_dq_kernel and
// :_dkdv_kernel (reached through _bwd_grouped). K3-bwd replaces the two
// kernels of the stock Pallas TPU flash attention's custom VJP,
// _flash_attention_bwd_dq and _flash_attention_bwd_dkv, which the
// Qwen3-VL ViT reaches through wedetect_tpu/ops/attention.py:
// _flash_attention. One template pair serves both, as in flash_attn.cu:
// a dq kernel over blocks of query rows and a dk/dv kernel over blocks of
// keys. The split is JAX's: each block owns its output rows, so there are
// no atomics and the gradients are the same bit for bit from run to run.
//
// Layouts are the JAX package's public ones, read in place: q, o, dO, dq
// (B, S, H, D); k, v, dk, dv (B, Lk, KVH, D); the G = H / KVH query heads
// of one kv head are folded into the row axis (folded row r = query
// position r / G, head kvh * G + r % G). lse and delta = rowsum(dO * O)
// are f32 (B, KVH, S * G) in that folded order (delta is computed by the
// wrapper in plain torch, as JAX computes it outside its kernels). K3 is
// G = 1 with segment ids in place of kv_valid.
//
// Which keys a row sees is the forward's (flash_attn.cu): row r scans
// keys [0, F_r) with the forward's frontier F; a scanned key that the
// mask rejects has logit -1e30. So p = exp(s - lse) for a scanned key
// (s = q.k * scale, or -1e30) and 0 past F, on every row: a row with no
// visible valid key has lse ~ -1e30 and p = 1 on each scanned key, as in
// the Pallas kernels. ds = p * (dp - delta) * scale with dp = dO.v;
// dq = sum ds.k over keys, dk = sum ds^T.q and dv = sum p^T.dO over the
// rows whose frontier reaches the key (summed over the G folded heads).
// As in the Pallas kernels, p is rounded to dO's type before p^T.dO and
// ds to the input type before ds.k and ds^T.q; sums are f32.
//
// Design (simple, right first; the forward's SIMT scheme): 256 threads
// in a 16 x 16 grid, 64 x 64 tiles staged in dynamic shared memory as
// f32, logits and dp as scalar FMAs into 4 x 4 register tiles, each
// thread keeping a 4 x D/16 slice of its f32 accumulators. dq: a block
// holds 64 folded rows (Q, dO) and walks the key tiles up to its last
// row's frontier. dk/dv: a block holds 64 keys (K, V) and walks the row
// tiles, skipping those whose last row's frontier does not reach its
// first key (JAX's j0 rule per 64-row tile). Shared memory at D = 128:
// 150 KB (dq), 166 KB (dk/dv), one block per SM.
//
// Bound on the H100: dq 6 * H * D and dk/dv 8 * H * D FLOPs per visible
// (query, key) pair (two and four products of the pair), against
// 67 TFLOP/s f32 (no tensor cores) or 989 TFLOP/s bf16, and q, k, v, dO,
// lse, delta read once plus the gradients written once at 3.35 TB/s. At
// the training path's shapes the FLOPs bound both; this SIMT design runs
// far below the f32 rate (shared-memory operand loads per FMA), and
// wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBR = 64;        // folded rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid, 8 warps
constexpr float kNeg = -1e30f;

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

// x rounded to T and back: the Pallas kernels' casts before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, KVH, S * G)
  const float* delta;   // (B, KVH, S * G)
  const int* kv_valid;  // K2: (B, Lk) 0/1, or null (all valid)
  const int* q_seg;     // K3: (B, L) segment ids, or null (one segment)
  const int* kv_seg;
  void* dq;
  void* dk;
  void* dv;
  int b, s, lk, h, kvh, g;
  int causal, off, bq, bk;
  float sm_scale;
};

// The row's frontier F (flash_attn.cu): keys at or past it are absent.
template <bool kSeg>
__device__ __forceinline__ int frontier(const Args& a, int qi) {
  if (!a.causal) return a.lk;
  if (kSeg) return qi + 1;
  int qb = qi / a.bq;
  int n = (a.off + (qb + 1) * a.bq + a.bk - 1) / a.bk;
  int f = n * a.bk;
  return f < a.lk ? f : a.lk;
}

// Row tag: the query's key position (K2) or its segment (K3).
template <bool kSeg>
__device__ __forceinline__ int row_tag(const Args& a, int bi, int qi) {
  if (kSeg) return a.q_seg ? a.q_seg[static_cast<int64_t>(bi) * a.s + qi] : 0;
  return a.off + qi;
}

// Key tag: valid (K2) or segment (K3); 0 past Lk.
template <bool kSeg>
__device__ __forceinline__ int key_tag(const Args& a, int bi, int key) {
  if (key >= a.lk) return 0;
  int64_t i = static_cast<int64_t>(bi) * a.lk + key;
  if (kSeg) return a.kv_seg ? a.kv_seg[i] : 0;
  return a.kv_valid ? (a.kv_valid[i] != 0) : 1;
}

template <bool kSeg>
__device__ __forceinline__ bool visible(const Args& a, int qtag, int ktag,
                                        int key) {
  return kSeg ? (ktag == qtag)
              : (ktag != 0 && (!a.causal || key <= qtag));
}

// Element offset of folded row gr of kv head hk, batch bi, in (B, S, H, D).
template <int D>
__device__ __forceinline__ int64_t row_offset(const Args& a, int bi, int hk,
                                              int gr) {
  int qi = gr / a.g;
  int head = hk * a.g + gr % a.g;
  return ((static_cast<int64_t>(bi) * a.s + qi) * a.h + head) * D;
}

// Element offset of key `key` of kv head hk, batch bi, in (B, Lk, KVH, D).
template <int D>
__device__ __forceinline__ int64_t key_offset(const Args& a, int bi, int hk,
                                              int key) {
  return ((static_cast<int64_t>(bi) * a.lk + key) * a.kvh + hk) * D;
}

// Stage rows [row0, row0 + kBR) of q and dO (f32, pitch D + 1) and their
// frontier, tag, lse and delta. Rows past the end get F = 0 (no key).
template <typename T, int D, bool kSeg>
__device__ __forceinline__ void load_rows(const Args& a, int bi, int hk,
                                          int row0, float* Qs, float* dOs,
                                          float* s_lse, float* s_delta,
                                          int* s_f, int* s_qtag) {
  constexpr int QP = D + 1;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int rows = a.s * a.g;
  const int tid = threadIdx.x;
  if (tid < kBR) {
    int gr = row0 + tid;
    int f = 0, tag = 0;
    float l = 0.f, dl = 0.f;
    if (gr < rows) {
      int qi = gr / a.g;
      f = frontier<kSeg>(a, qi);
      tag = row_tag<kSeg>(a, bi, qi);
      int64_t st = (static_cast<int64_t>(bi) * a.kvh + hk) * rows + gr;
      l = a.lse[st];
      dl = a.delta[st];
    }
    s_f[tid] = f;
    s_qtag[tid] = tag;
    s_lse[tid] = l;
    s_delta[tid] = dl;
  }
  for (int idx = tid; idx < kBR * D; idx += kThreads) {
    int r = idx / D, dd = idx % D;
    int gr = row0 + r;
    float qv = 0.f, ov = 0.f;
    if (gr < rows) {
      int64_t off = row_offset<D>(a, bi, hk, gr) + dd;
      qv = to_f<T>(q[off]);
      ov = to_f<T>(dout[off]);
    }
    Qs[r * QP + dd] = qv;
    dOs[r * QP + dd] = ov;
  }
}

// Stage keys [k0, k0 + kBK) of k and v (f32, pitch D + 1) and their tags.
template <typename T, int D, bool kSeg>
__device__ __forceinline__ void load_keys(const Args& a, int bi, int hk,
                                          int k0, float* Ks, float* Vs,
                                          int* s_ktag) {
  constexpr int QP = D + 1;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int tid = threadIdx.x;
  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    int kk = idx / D, dd = idx % D;
    int key = k0 + kk;
    float kv = 0.f, vv = 0.f;
    if (key < a.lk) {
      int64_t off = key_offset<D>(a, bi, hk, key) + dd;
      kv = to_f<T>(k[off]);
      vv = to_f<T>(v[off]);
    }
    Ks[kk * QP + dd] = kv;
    Vs[kk * QP + dd] = vv;
  }
  if (tid < kBK) s_ktag[tid] = key_tag<kSeg>(a, bi, k0 + tid);
}

// s = Q.K^T and dp = dO.V^T for rows ty + 16 i and keys tx + 16 j.
template <int D>
__device__ __forceinline__ void tile_products(const float* Qs,
                                              const float* dOs,
                                              const float* Ks,
                                              const float* Vs, int ty,
                                              int tx, float (&sc)[4][4],
                                              float (&dp)[4][4]) {
  constexpr int QP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = Qs[(ty + 16 * i) * QP + dd];
      oa[i] = dOs[(ty + 16 * i) * QP + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb[j] = Ks[(tx + 16 * j) * QP + dd];
      vb[j] = Vs[(tx + 16 * j) * QP + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
}

// p of row r (tile-local) and key c: exp(s - lse) below the frontier.
template <bool kSeg>
__device__ __forceinline__ float prob(const Args& a, float s, int r, int c,
                                      int k0, const float* s_lse,
                                      const int* s_f, const int* s_qtag,
                                      const int* s_ktag) {
  int key = k0 + c;
  if (key >= s_f[r]) return 0.f;
  float val = visible<kSeg>(a, s_qtag[r], s_ktag[c], key) ? s * a.sm_scale
                                                          : kNeg;
  return expf(val - s_lse[r]);
}

// ------------------------------------------------------------------ dq
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  constexpr int QP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                      // [kBR][QP]
  float* dOs = Qs + kBR * QP;            // [kBR][QP]
  float* Ks = dOs + kBR * QP;            // [kBK][QP]
  float* Vs = Ks + kBK * QP;             // [kBK][QP]
  float* DSs = Vs + kBK * QP;            // [kBR][SP] ds, rounded
  float* s_lse = DSs + kBR * SP;         // [kBR]
  float* s_delta = s_lse + kBR;          // [kBR]
  int* s_f = reinterpret_cast<int*>(s_delta + kBR);  // [kBR]
  int* s_qtag = s_f + kBR;               // [kBR]
  int* s_ktag = s_qtag + kBR;            // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kBR;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = a.s * a.g;

  load_rows<T, D, kSeg>(a, bi, hk, row0, Qs, dOs, s_lse, s_delta, s_f,
                        s_qtag);
  // F grows with the row, so the last live row's bounds the key loop
  const int last = min(row0 + kBR, rows) - 1;
  const int ntiles = (frontier<kSeg>(a, last / a.g) + kBK - 1) / kBK;

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // rows staged; the previous tile's K and ds consumed
    load_keys<T, D, kSeg>(a, bi, hk, k0, Ks, Vs, s_ktag);
    __syncthreads();

    float sc[4][4], dp[4][4];
    tile_products<D>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx + 16 * j;
        float p = prob<kSeg>(a, sc[i][j], r, c, k0, s_lse, s_f, s_qtag,
                             s_ktag);
        float ds = p * (dp[i][j] - s_delta[r]) * a.sm_scale;
        DSs[r * SP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dq += ds . K
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = DSs[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[c * QP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = row0 + ty + 16 * i;
    if (gr >= rows) continue;
    int64_t base = row_offset<D>(a, bi, hk, gr);
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[base + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------- dk/dv
template <typename T, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args a) {
  constexpr int QP = D + 1;
  constexpr int SP = kBK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kBK][QP]
  float* Vs = Ks + kBK * QP;             // [kBK][QP]
  float* Qs = Vs + kBK * QP;             // [kBR][QP]
  float* dOs = Qs + kBR * QP;            // [kBR][QP]
  float* Ps = dOs + kBR * QP;            // [kBR][SP] p, rounded
  float* DSs = Ps + kBR * SP;            // [kBR][SP] ds, rounded
  float* s_lse = DSs + kBR * SP;         // [kBR]
  float* s_delta = s_lse + kBR;          // [kBR]
  int* s_f = reinterpret_cast<int*>(s_delta + kBR);  // [kBR]
  int* s_qtag = s_f + kBR;               // [kBR]
  int* s_ktag = s_qtag + kBR;            // [kBK]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int rows = a.s * a.g;

  load_keys<T, D, kSeg>(a, bi, hk, k0, Ks, Vs, s_ktag);

  // keys ty + 16 i, columns tx + 16 j
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int ntiles = (rows + kBR - 1) / kBR;
  for (int t = 0; t < ntiles; ++t) {
    const int row0 = t * kBR;
    // F grows with the row: skip a tile whose last row does not reach
    // this block's first key (the same for every thread of the block)
    const int last = min(row0 + kBR, rows) - 1;
    if (frontier<kSeg>(a, last / a.g) <= k0) continue;
    __syncthreads();  // the previous tile's rows, p and ds are consumed
    load_rows<T, D, kSeg>(a, bi, hk, row0, Qs, dOs, s_lse, s_delta, s_f,
                          s_qtag);
    __syncthreads();

    // logits and dp with rows ty + 16 i and keys tx + 16 j
    float sc[4][4], dp[4][4];
    tile_products<D>(Qs, dOs, Ks, Vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx + 16 * j;
        float p = prob<kSeg>(a, sc[i][j], r, c, k0, s_lse, s_f, s_qtag,
                             s_ktag);
        float ds = p * (dp[i][j] - s_delta[r]) * a.sm_scale;
        Ps[r * SP + c] = round_to<T>(p);
        DSs[r * SP + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dv += p^T . dO, dk += ds^T . Q over the tile's rows
#pragma unroll 2
    for (int r = 0; r < kBR; ++r) {
      float pv[4], dsv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * SP + ty + 16 * i];
        dsv[i] = DSs[r * SP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = dOs[r * QP + tx + 16 * j];
        qv[j] = Qs[r * QP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], ov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int key = k0 + ty + 16 * i;
    if (key >= a.lk) continue;
    int64_t base = key_offset<D>(a, bi, hk, key);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkp[base + tx + 16 * j] = from_f<T>(dk[i][j]);
      dvp[base + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

size_t meta_bytes() {
  return 2 * kBR * sizeof(float) + (2 * kBR + kBK) * sizeof(int);
}

size_t dq_shared_bytes(int d) {
  size_t floats = static_cast<size_t>(2 * kBR + 2 * kBK) * (d + 1)
                  + static_cast<size_t>(kBR) * (kBK + 1);
  return floats * sizeof(float) + meta_bytes();
}

size_t dkdv_shared_bytes(int d) {
  size_t floats = static_cast<size_t>(2 * kBR + 2 * kBK) * (d + 1)
                  + 2 * static_cast<size_t>(kBR) * (kBK + 1);
  return floats * sizeof(float) + meta_bytes();
}

template <typename T, int D, bool kSeg>
int launch_dq(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D, kSeg>;
  size_t smem = dq_shared_bytes(D);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((a.s * a.g + kBR - 1) / kBR, a.kvh, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kSeg>
int launch_dkdv(const Args& a, cudaStream_t stream) {
  auto kern = flash_bwd_dkdv_kernel<T, D, kSeg>;
  size_t smem = dkdv_shared_bytes(D);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((a.lk + kBK - 1) / kBK, a.kvh, a.b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSeg>
int dispatch(const Args& a, bool dq, int d, int bf16, cudaStream_t stream) {
  if (d == 64) {
    if (dq)
      return bf16 ? launch_dq<__nv_bfloat16, 64, kSeg>(a, stream)
                  : launch_dq<float, 64, kSeg>(a, stream);
    return bf16 ? launch_dkdv<__nv_bfloat16, 64, kSeg>(a, stream)
                : launch_dkdv<float, 64, kSeg>(a, stream);
  }
  if (d == 128) {
    if (dq)
      return bf16 ? launch_dq<__nv_bfloat16, 128, kSeg>(a, stream)
                  : launch_dq<float, 128, kSeg>(a, stream);
    return bf16 ? launch_dkdv<__nv_bfloat16, 128, kSeg>(a, stream)
                : launch_dkdv<float, 128, kSeg>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Args gqa_args(const void* q, const void* k, const void* v,
              const int* kv_valid, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, int b, int s,
              int lk, int h, int kvh, int causal, int bq, int bk,
              float sm_scale) {
  return Args{q, k, v, dout, lse, delta, kv_valid, nullptr, nullptr,
              dq, dk, dv, b, s, lk, h, kvh, h / kvh,
              causal, causal ? lk - s : 0, bq, bk, sm_scale};
}

Args seg_args(const void* q, const void* k, const void* v, const int* q_seg,
              const int* kv_seg, const void* dout, const float* lse,
              const float* delta, void* dq, void* dk, void* dv, int b, int l,
              int h, int causal, float sm_scale) {
  return Args{q, k, v, dout, lse, delta, nullptr, q_seg, kv_seg,
              dq, dk, dv, b, l, l, h, h, 1,
              causal, 0, 1, 1, sm_scale};
}

}  // namespace

// K2-bwd-dq. q, dout, dq (B, S, H, D); k, v (B, Lk, KVH, D); kv_valid
// (B, Lk) int32; lse, delta (B, KVH, S * H / KVH) f32; bq, bk: the Pallas
// kernel's blocks, which fix each row's frontier (as in gqa_flash_fwd).
// Launches on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int gqa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const int* kv_valid, const void* dout,
                                const float* lse, const float* delta,
                                void* dq, int b, int s, int lk, int h,
                                int kvh, int d, int causal, int bq, int bk,
                                float sm_scale, int bf16, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = gqa_args(q, k, v, kv_valid, dout, lse, delta, dq, nullptr,
                    nullptr, b, s, lk, h, kvh, causal, bq, bk, sm_scale);
  return dispatch<false>(a, true, d, bf16, static_cast<cudaStream_t>(stream));
}

// K2-bwd-dkdv. As gqa_flash_bwd_dq; dk, dv (B, Lk, KVH, D).
extern "C" int gqa_flash_bwd_dkdv(const void* q, const void* k,
                                  const void* v, const int* kv_valid,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int b, int s, int lk, int h, int kvh, int d,
                                  int causal, int bq, int bk, float sm_scale,
                                  int bf16, void* stream) {
  if (kvh <= 0 || h % kvh != 0 || bq <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = gqa_args(q, k, v, kv_valid, dout, lse, delta, nullptr, dk, dv, b,
                    s, lk, h, kvh, causal, bq, bk, sm_scale);
  return dispatch<false>(a, false, d, bf16,
                         static_cast<cudaStream_t>(stream));
}

// K3-bwd-dq. q, k, v, dout, dq (B, L, H, D); q_seg, kv_seg (B, L) int32
// or both null; lse, delta (B, H, L) f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const int* q_seg,
                                      const int* kv_seg, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dq, int b, int l, int h, int d,
                                      int causal, float sm_scale, int bf16,
                                      void* stream) {
  Args a = seg_args(q, k, v, q_seg, kv_seg, dout, lse, delta, dq, nullptr,
                    nullptr, b, l, h, causal, sm_scale);
  return dispatch<true>(a, true, d, bf16, static_cast<cudaStream_t>(stream));
}

// K3-bwd-dkv. As flash_attention_bwd_dq; dk, dv (B, L, H, D).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const int* q_seg,
                                       const int* kv_seg, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dk, void* dv, int b, int l,
                                       int h, int d, int causal,
                                       float sm_scale, int bf16,
                                       void* stream) {
  Args a = seg_args(q, k, v, q_seg, kv_seg, dout, lse, delta, nullptr, dk,
                    dv, b, l, h, causal, sm_scale);
  return dispatch<true>(a, false, d, bf16,
                        static_cast<cudaStream_t>(stream));
}
