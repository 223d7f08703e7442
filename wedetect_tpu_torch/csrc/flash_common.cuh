// Which keys a row of K2 sees: the rules K2's kernels share
// (csrc/flash_attn.cu, the SIMT forward; csrc/flash_gqa_sm90.cu and
// csrc/flash_gqa_bwd_sm90.cu, the bf16 forward and backward), those of
// the Pallas kernels in wedetect_tpu/ops/flash_gqa.py.
//
// Query i sits at key position off + i (off = Lk - S, end-aligned
// rectangular causal). Its row scans keys [0, F): a key at or past the
// frontier F is absent (weight 0), a key below F that is invalid or
// causally later has logit kNeg (-1e30, not -inf), so a row whose
// scanned keys are all masked returns the mean of V over them.
//
// Also the exponential that the flash kernels take on the MUFU unit.

#pragma once

constexpr float kNeg = -1e30f;

// F of query i when causal: the Pallas kernel's causal tile frontier,
// min(Lk, bk * ceil((off + (i / bq + 1) * bq) / bk)), at its query and
// key blocks bq and bk (flash_gqa._pick_bq / _pick_bk).
__host__ __device__ __forceinline__ int gqa_frontier(int qi, int lk, int off,
                                                     int bq, int bk) {
  int qb = qi / bq;
  int f = (off + (qb + 1) * bq + bk - 1) / bk * bk;
  return f < lk ? f : lk;
}

// A scanned key keeps its logit when it is valid and, if causal, not
// later than the query's position qpos; otherwise its logit is kNeg.
__device__ __forceinline__ bool gqa_key_ok(int valid, int key, int qpos,
                                           int causal) {
  return valid != 0 && (!causal || key <= qpos);
}

// 2^x on the MUFU unit alone (ex2.approx.ftz: about 2^-22 relative
// error; 2^-inf = 0, and a result below 2^-126 flushes to 0, far under
// the f32 limits). exp2f's handling of subnormal results took 7% of
// K3-bwd's f32 dk/dv kernel.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
