// Per-row top-t (value, class) extraction for the pre-NMS selection.
//
// Replaces wedetect_tpu/ops/pallas_topk.py:_row_topk_kernel (the Pallas
// TPU kernel that wedetect_tpu/ops/nms.py:_batched_select_topk calls in
// its sparse branch). Same contract, bit for bit:
//   scores (R, K) f32, -inf for masked lanes
//   -> vals (R, t) f32 descending, cls (R, t) int32
// Each of the t rounds takes the row's current maximum and the LOWEST
// class index holding it, writes that pair to the slot, and sets the
// lane to -inf. Ties therefore come out in ascending class order, and
// once the finite values are exhausted a round picks the lowest index
// whose value is -inf -- the Pallas kernel's `x == m` matches -inf lanes
// too -- so the empty slots agree as well.
//
// Design: one warp per row. Lane l holds the row's elements
// l, l + 32, l + 64, ... (coalesced loads); the register path keeps them
// in an unrolled array of NPL values (K <= 32 * NPL, NPL <= 40, so
// K <= 1280 covers LVIS), the shared-memory path keeps the row in
// dynamic shared memory for larger K. Every lane caches its own best
// (value, lowest index); a round is a 5-step butterfly shuffle that
// orders candidates by value descending, then index ascending, after
// which only the winning lane clears its element and rescans. Lane 0
// writes the slot.
//
// Bound on the H100 (3.35 TB/s): the kernel must read R*K*4 bytes and
// write R*t*8 bytes -- at the detect path's R = 8*8400, K = 1203, t = 64
// that is 323 MB + 34 MB, about 0.107 ms. The iterative max also does
// t*K compare-selects per row (5.2e9 at that size, 0.077 ms at the
// 67 TFLOP/s f32 rate), and the serial dependence of the t rounds keeps
// this simple design well above the byte bound; a faster selection
// (radix or bitonic per row) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kNoIndex = 0x7fffffff;  // lanes past K: never win

// Folds candidate (ov, oi) into (v, i): the larger value wins; between
// numerically equal values the lower index wins, and the value keeps
// +0.0 over -0.0 (XLA's max, which the Pallas kernel's `jnp.max` is).
__device__ __forceinline__ void fold(float& v, int& i, float ov, int oi) {
  if (ov > v) {
    v = ov;
    i = oi;
  } else if (ov == v) {
    if (oi < i) i = oi;
    if (signbit(v)) v = ov;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    fold(v, i, ov, oi);
  }
}

template <int NPL>
__global__ void row_topk_regs(const float* __restrict__ x,
                              float* __restrict__ vals,
                              int* __restrict__ cls, int rows, int k,
                              int t) {
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;  // whole warp exits together
  const float* xr = x + static_cast<int64_t>(row) * k;

  float v[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + j * kWarp;
    v[j] = c < k ? xr[c] : -CUDART_INF_F;
  }
  // lane-local best over ascending indices; padding never enters
  auto rescan = [&](float& bv, int& bi) {
    bv = v[0];
    bi = lane < k ? lane : kNoIndex;
#pragma unroll
    for (int j = 1; j < NPL; ++j) {
      if (lane + j * kWarp < k) fold(bv, bi, v[j], lane + j * kWarp);
    }
  };
  float bv;
  int bi;
  rescan(bv, bi);

  float* vr = vals + static_cast<int64_t>(row) * t;
  int* cr = cls + static_cast<int64_t>(row) * t;
  for (int s = 0; s < t; ++s) {
    float wv = bv;
    int wi = bi;
    warp_argmax(wv, wi);
    if (lane == 0) {
      vr[s] = wv;
      cr[s] = wi;
    }
    if (wi % kWarp == lane) {  // the winner clears its element
      const int jw = wi / kWarp;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        if (j == jw) v[j] = -CUDART_INF_F;
      }
      rescan(bv, bi);
    }
  }
}

__global__ void row_topk_smem(const float* __restrict__ x,
                              float* __restrict__ vals,
                              int* __restrict__ cls, int rows, int k,
                              int t) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;
  float* v = smem + static_cast<int64_t>(warp) * k;
  const float* xr = x + static_cast<int64_t>(row) * k;
  for (int c = lane; c < k; c += kWarp) v[c] = xr[c];
  __syncwarp();

  auto rescan = [&](float& bv, int& bi) {
    bv = -CUDART_INF_F;
    bi = kNoIndex;
    for (int c = lane; c < k; c += kWarp) fold(bv, bi, v[c], c);
  };
  float bv;
  int bi;
  rescan(bv, bi);

  float* vr = vals + static_cast<int64_t>(row) * t;
  int* cr = cls + static_cast<int64_t>(row) * t;
  for (int s = 0; s < t; ++s) {
    float wv = bv;
    int wi = bi;
    warp_argmax(wv, wi);
    if (lane == 0) {
      vr[s] = wv;
      cr[s] = wi;
    }
    if (wi % kWarp == lane) {
      v[wi] = -CUDART_INF_F;
      rescan(bv, bi);
    }
  }
}

template <int NPL>
void launch_regs(const float* x, float* vals, int* cls, int rows, int k,
                 int t, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_topk_regs<NPL><<<blocks, kWarpsPerBlock * kWarp, 0, stream>>>(
      x, vals, cls, rows, k, t);
}

}  // namespace

// Largest K the shared-memory path takes (one row per warp, eight
// warps per block, within the 227 KB a block may use).
extern "C" int row_topk_max_k() {
  return (227 * 1024) / (kWarpsPerBlock * static_cast<int>(sizeof(float)));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes: 1 <= t <= k, k <= row_topk_max_k().
extern "C" int row_topk_f32(const float* x, float* vals, int* cls, int rows,
                            int k, int t, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows > 0) {
    const int npl = (k + kWarp - 1) / kWarp;
    if (npl <= 4) {
      launch_regs<4>(x, vals, cls, rows, k, t, stream);
    } else if (npl <= 8) {
      launch_regs<8>(x, vals, cls, rows, k, t, stream);
    } else if (npl <= 16) {
      launch_regs<16>(x, vals, cls, rows, k, t, stream);
    } else if (npl <= 24) {
      launch_regs<24>(x, vals, cls, rows, k, t, stream);
    } else if (npl <= 32) {
      launch_regs<32>(x, vals, cls, rows, k, t, stream);
    } else if (npl <= 40) {
      launch_regs<40>(x, vals, cls, rows, k, t, stream);
    } else {
      const size_t bytes =
          static_cast<size_t>(kWarpsPerBlock) * k * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          row_topk_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
      row_topk_smem<<<blocks, kWarpsPerBlock * kWarp, bytes, stream>>>(
          x, vals, cls, rows, k, t);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
