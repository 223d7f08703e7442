// The cp.async ring the FFMA kernels share (csrc/flash_gqa_bwd_f32.cu,
// csrc/flash_attn_bwd_f32.cu, csrc/flash_gqa_f32.cu,
// csrc/flash_attn_f32.cu): asynchronous copies from global into shared
// memory, each either a 16-byte or a 4-byte piece, zero-filled when its
// predicate is false; and the walk over the tiles a block keeps.

#pragma once

#include <stdint.h>

// One 16-byte copy (both addresses 16-byte aligned); 16 zero bytes when
// !pred.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

// One 4-byte copy; a zero word when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first walked tile at or after t (n if none); walk[i] != 0 marks a
// walked tile.
__device__ __forceinline__ int next_walked(const unsigned char* walk, int t,
                                           int n) {
  while (t < n && !walk[t]) ++t;
  return t;
}

// walked[block] = the number of set bytes of walk[0, n), with a non-null
// walked. Every thread of the block calls it.
__device__ __forceinline__ void count_walked(int* walked, int64_t block,
                                             const unsigned char* walk,
                                             int n) {
  if (!walked) return;
  const int tid = threadIdx.x;
  int c = 0;
  for (int i = 0; i < n; i += blockDim.x)
    c += __syncthreads_count(i + tid < n && walk[i + tid]);
  if (tid == 0) walked[block] = c;
}
