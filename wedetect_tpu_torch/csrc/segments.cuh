// The segment prologue that K3's f32 kernels share
// (csrc/flash_attn_f32.cu, the forward; csrc/flash_attn_bwd_f32.cu, the
// dk/dv and dq kernels): a block reads the positions it keeps resident
// (rows or keys) once as runs of one segment id, and tests the tiles of
// the other side against the runs before its walk.

#pragma once

#include <stdint.h>

// The N positions p0, p0 + 1, ... below L (threads 0 to N - 1, N / 32
// whole warps) as runs of one segment id: a position starts a run when it
// is the first or its id differs from the one before it. Writes each
// position's id to ids[0, N) (0 past L, and without ids), each run's id
// and first position to run_id and run_first in order, and returns the
// number of runs. Every thread of the block calls it (two barriers).
template <int N>
__device__ __forceinline__ int segment_runs(const int* seg, int64_t seg_base,
                                            int p0, int l, int* ids,
                                            int* run_id, int* run_first,
                                            unsigned* starts) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  bool start = false;
  int id = 0;
  if (warp < N / 32) {
    const int p = p0 + tid;
    if (p < l) {
      id = seg ? seg[seg_base + p] : 0;
      start = tid == 0 || (seg && id != seg[seg_base + p - 1]);
    }
    ids[tid] = id;
    unsigned m = __ballot_sync(0xffffffffu, start);
    if (lane == 0) starts[warp] = m;
  }
  __syncthreads();
  int n_runs = 0, i_run = 0;
#pragma unroll
  for (int w = 0; w < N / 32; ++w) {
    if (w == warp) i_run = n_runs + __popc(starts[w] & ((1u << lane) - 1u));
    n_runs += __popc(starts[w]);
  }
  if (start) {
    run_id[i_run] = id;
    run_first[i_run] = p0 + tid;
  }
  __syncthreads();
  return n_runs;
}
