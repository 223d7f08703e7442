// Per-row top-t (value, class) extraction for the pre-NMS selection.
//
// Replaces wedetect_tpu/ops/pallas_topk.py:_row_topk_kernel (the Pallas
// TPU kernel that wedetect_tpu/ops/nms.py:_batched_select_topk calls in
// its sparse branch). Same contract, bit for bit:
//   scores (R, K) f32, -inf for masked lanes
//   -> vals (R, t) f32 descending, cls (R, t) int32
// The Pallas kernel runs t rounds; each takes the row's current maximum
// and the LOWEST class index holding it, writes that pair to the slot,
// and sets the lane to -inf. Ties therefore come out in ascending class
// order, and once the finite values are exhausted a round picks the
// lowest index whose value is -inf -- the Pallas kernel's `x == m`
// matches -inf lanes too -- so the empty slots hold (-inf, 0). A row
// that holds a NaN gives (that NaN, K) in every slot, its bits kept; of
// several NaNs, the lowest-index one with its sign bit set, else the
// highest-index one. Signed zeros: the zero slots come out in ascending
// class order, and a zero slot carries +0.0 iff its class is <= the
// highest index of a +0.0 lane in the row (XLA's max keeps +0.0 while
// one remains), else -0.0.
//
// Design: selection by key, in one pass over the row and no loop over
// t (ops/row_topk.py:row_topk_by_key states the same rule in plain
// torch). One warp per row. Each value maps to an order-preserving
// uint32 key (sign bit flipped for a positive value, every bit for a
// negative one; -0.0 takes +0.0's key, so the two tie as `==` ties
// them); -inf's key marks a lane that is no candidate. Lane l holds the
// row's elements l, l + 32, l + 64, ... (coalesced loads, all of a
// lane's loads issued before any is used): in registers for
// K <= 40 * 32 (`row_topk_regs`), in shared memory above
// (`row_topk_smem`). While loading, each lane counts its candidates (n
// for the row, one warp reduction) and notes any NaN and the last +0.0.
//   - A NaN row (by warp vote) writes its (NaN, K) slots.
//   - n = 0 (most rows on the detect path): the t slots get (-inf, 0).
//   - 0 < n <= t (every other row on the detect path): the candidates
//     are compacted in ascending class order by a ballot prefix into
//     (key, index) pairs in shared memory, bitonic-sorted in the warp
//     (2 a lane, shuffles) by key descending then index ascending, and
//     written; slots from n on get (-inf, 0).
//   - n > t: a radix select (4 passes of 8-bit digits, a 256-bin
//     histogram a warp in shared memory) finds the key at rank t - 1;
//     every key above it, and the lowest-index keys equal to it up to t,
//     are compacted in class order, then sorted and written as above.
//   Where t > 64 the slots go in chunks of 64: chunk [lo, hi) selects
//   the ranks between the keys at ranks lo and hi - 1 the same way.
//
// Bound on the H100 (3.35 TB/s): the kernel must read R*K*4 bytes and
// write R*t*8 bytes -- at the detect path's R = 8*8400, K = 1203, t = 64
// that is 323 MB + 34 MB, about 0.107 ms. The work per element (a key,
// a compare, a count) is a few instructions; a row with candidates adds
// a 64-wide sort, and a dense row 4 histogram passes over its keys.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegWarps = 8;     // rows a block on the register path
constexpr int kSmemWarps = 4;    // rows a block on the shared-memory path
constexpr int kMaxNpl = 40;      // register path: K <= 40 * 32
constexpr int kChunk = 64;       // slots sorted at once: 2 a lane
// The largest K: eight f32 rows in a block's 227 KB, the limit the
// wrapper states; the shared-memory path holds four rows of keys a block
// beside their scratch.
constexpr int kMaxK = (227 * 1024) / (8 * static_cast<int>(sizeof(float)));
constexpr uint32_t kNegInfBits = 0xff800000u;
constexpr uint32_t kNegInfKey = 0x007fffffu;  // -inf: no candidate
constexpr uint32_t kTopKey = 0xffffffffu;     // above a NaN-free row's keys

enum Branch { kEmpty = 0, kSparse = 1, kDense = 2, kNan = 3 };

__device__ __forceinline__ uint32_t to_key(uint32_t bits) {
  if (bits == 0x80000000u) bits = 0;  // -0.0 ties +0.0
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

__device__ __forceinline__ uint32_t from_key(uint32_t key) {
  return (key & 0x80000000u) ? key & 0x7fffffffu : ~key;
}

__device__ __forceinline__ bool is_nan(uint32_t bits) {
  return (bits & 0x7fffffffu) > 0x7f800000u;
}

// A row's keys: lane l's j-th key is element l + 32 j (-inf past K).
template <int NPL>
struct RegRow {
  uint32_t key[NPL];
  __device__ __forceinline__ int npl() const { return NPL; }
  __device__ __forceinline__ uint32_t operator[](int j) const {
    return key[j];
  }
};

struct SmemRow {
  const uint32_t* key;  // key[32 j + lane]
  int n;
  int lane;
  __device__ __forceinline__ int npl() const { return n; }
  __device__ __forceinline__ uint32_t operator[](int j) const {
    return key[j * kWarp + lane];
  }
};

// What a lane notes while it loads: its candidates, the largest
// |bits| (a NaN if above +inf's), the highest index of a +0.0.
struct LaneStats {
  int count = 0;
  uint32_t abs_max = 0;
  int pos_zero = -1;
  __device__ __forceinline__ uint32_t note(uint32_t bits, int c) {
    abs_max = max(abs_max, bits & 0x7fffffffu);
    if (bits == 0) pos_zero = c;
    const uint32_t key = to_key(bits);
    count += key > kNegInfKey;
    return key;
  }
};

struct WarpScratch {
  uint32_t hist[256];
  unsigned long long pair[kChunk];  // (key << 32) | ~class
};

// Butterfly max / min over the warp. (redux.sync's max, in
// __reduce_max_sync, gave a wrong +0.0 index at K <= 512 on the card.)
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// Bitonic sort of the warp's 64 values, descending: lane l holds
// positions l (a) and l + 32 (b).
__device__ __forceinline__ void sort64_desc(unsigned long long& a,
                                            unsigned long long& b,
                                            int lane) {
#pragma unroll
  for (int k = 2; k <= kChunk; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == kWarp) {  // k == 64: the pair lies in one lane
        const unsigned long long hi = umax64(a, b);
        b = umin64(a, b);
        a = hi;
      } else {
        const unsigned long long pa = __shfl_xor_sync(kFull, a, j);
        const unsigned long long pb = __shfl_xor_sync(kFull, b, j);
        const bool lower = (lane & j) == 0;
        const bool desc_a = (lane & k) == 0;
        const bool desc_b = ((lane + kWarp) & k) == 0;
        a = desc_a == lower ? umax64(a, pa) : umin64(a, pa);
        b = desc_b == lower ? umax64(b, pb) : umin64(b, pb);
      }
    }
  }
}

// The key at descending rank r (0-based) among the row's candidates,
// and in `above` the number of candidates with a larger key: 4 passes
// of 8-bit digits, high to low, over a 256-bin histogram.
template <class Row>
__device__ __forceinline__ uint32_t radix_select(const Row& row, int lane,
                                                 uint32_t* hist, int r,
                                                 int& above) {
  uint32_t prefix = 0;
  int gt = 0;
#pragma unroll 1
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t fixed = shift == 24 ? 0u : kFull << (shift + 8);
#pragma unroll
    for (int i = 0; i < 256 / kWarp; ++i) hist[i * kWarp + lane] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < row.npl(); ++j) {
      const uint32_t key = row[j];
      if (key > kNegInfKey && (key & fixed) == prefix)
        atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncwarp();
    // lane l takes digits 255 - 8 l down to 248 - 8 l
    uint32_t cnt[8];
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cnt[i] = hist[255 - 8 * lane - i];
      sum += cnt[i];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const uint32_t excl = incl - sum;
    const uint32_t want = static_cast<uint32_t>(r - gt);
    const int src =
        __ffs(__ballot_sync(kFull, excl <= want && want < incl)) - 1;
    int digit = 0;
    uint32_t before = excl, acc = excl;
    bool found = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!found && want < acc + cnt[i]) {
        found = true;
        digit = 255 - 8 * lane - i;
        before = acc;
      }
      acc += cnt[i];
    }
    digit = __shfl_sync(kFull, digit, src);
    before = __shfl_sync(kFull, before, src);
    gt += static_cast<int>(before);
    prefix |= static_cast<uint32_t>(digit) << shift;
    __syncwarp();  // every lane has read hist before the next clear
  }
  above = gt;
  return prefix;
}

// Compacts, in ascending class order, the candidates of descending rank
// [lo, hi) into pair[0, hi - lo). k_hi / gt_hi: the key at rank lo and
// the candidates above it (kTopKey / 0 where lo = 0); k_lo / gt_lo: the
// same at rank hi - 1 (kNegInfKey where every candidate from lo on is
// taken). Equal keys take ranks in class order.
template <class Row>
__device__ __forceinline__ void compact(const Row& row, int lane,
                                        unsigned long long* pair, int lo,
                                        int hi, uint32_t k_hi, int gt_hi,
                                        uint32_t k_lo, int gt_lo) {
  const bool bounded = k_hi != kTopKey || k_lo != kNegInfKey;
  const unsigned below = (1u << lane) - 1u;
  int base = 0, q_hi = 0, q_lo = 0;
#pragma unroll
  for (int j = 0; j < row.npl(); ++j) {
    const uint32_t key = row[j];
    bool take = key > kNegInfKey;
    if (bounded) {
      const unsigned eq_hi = __ballot_sync(kFull, key == k_hi);
      const unsigned eq_lo = __ballot_sync(kFull, key == k_lo);
      take = take &&
             (key < k_hi ||
              (key == k_hi && gt_hi + q_hi + __popc(eq_hi & below) >= lo)) &&
             (key > k_lo ||
              (key == k_lo && gt_lo + q_lo + __popc(eq_lo & below) < hi));
      q_hi += __popc(eq_hi);
      q_lo += __popc(eq_lo);
    }
    const unsigned taken = __ballot_sync(kFull, take);
    if (take) {
      const uint32_t c = static_cast<uint32_t>(lane + j * kWarp);
      pair[base + __popc(taken & below)] =
          (static_cast<unsigned long long>(key) << 32) | ~c;
    }
    base += __popc(taken);
  }
  __syncwarp();
}

// Everything after the load: one warp, one row.
template <class Row>
__device__ __forceinline__ void select_row(const Row& row,
                                           const LaneStats& st,
                                           const float* xr, float* vr,
                                           int* cr, int k, int t,
                                           WarpScratch& ws, int* branches) {
  const int lane = threadIdx.x % kWarp;
  const int n = __reduce_add_sync(kFull, st.count);
  int branch = n == 0 ? kEmpty : n <= t ? kSparse : kDense;
  if (__any_sync(kFull, st.abs_max > 0x7f800000u)) {
    branch = kNan;
    int first_neg = INT_MAX, last = -1;
#pragma unroll
    for (int j = 0; j < row.npl(); ++j) {
      const uint32_t bits = from_key(row[j]);
      const int c = lane + j * kWarp;
      if (is_nan(bits)) {
        if ((bits >> 31) && first_neg == INT_MAX) first_neg = c;
        last = c;
      }
    }
    first_neg = warp_min(first_neg);
    last = warp_max(last);
    const uint32_t bits = reinterpret_cast<const uint32_t*>(
        xr)[first_neg != INT_MAX ? first_neg : last];
    for (int s = lane; s < t; s += kWarp) {
      vr[s] = __uint_as_float(bits);
      cr[s] = k;
    }
  } else {
    const int m = min(n, t);
    const int pos_zero = m > 0 ? warp_max(st.pos_zero) : -1;
    for (int lo = 0; lo < m; lo += kChunk) {
      const int hi = min(lo + kChunk, m);
      uint32_t k_hi = kTopKey, k_lo = kNegInfKey;
      int gt_hi = 0, gt_lo = 0;
      if (lo > 0) k_hi = radix_select(row, lane, ws.hist, lo, gt_hi);
      if (hi < n) k_lo = radix_select(row, lane, ws.hist, hi - 1, gt_lo);
      compact(row, lane, ws.pair, lo, hi, k_hi, gt_hi, k_lo, gt_lo);
      const int cnt = hi - lo;
      unsigned long long a = lane < cnt ? ws.pair[lane] : 0ull;
      unsigned long long b = lane + kWarp < cnt ? ws.pair[lane + kWarp] : 0ull;
      __syncwarp();  // pair is read before the next chunk writes it
      if (cnt > 1) sort64_desc(a, b, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + h * kWarp;
        if (p < cnt) {
          const unsigned long long e = h ? b : a;
          const int c = static_cast<int>(~static_cast<uint32_t>(e));
          uint32_t bits = from_key(static_cast<uint32_t>(e >> 32));
          if (bits == 0 && c > pos_zero) bits = 0x80000000u;  // -0.0
          vr[lo + p] = __uint_as_float(bits);
          cr[lo + p] = c;
        }
      }
    }
    for (int s = m + lane; s < t; s += kWarp) {
      vr[s] = __uint_as_float(kNegInfBits);
      cr[s] = 0;
    }
  }
  if (branches != nullptr && lane == 0) atomicAdd(&branches[branch], 1);
}

template <int NPL>
__global__ void __launch_bounds__(kRegWarps* kWarp)
    row_topk_regs(const float* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ cls, int rows, int k, int t,
                  int* branches) {
  __shared__ WarpScratch scratch[kRegWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kRegWarps + warp;
  if (row >= rows) return;  // whole warp exits together
  const float* xr = x + static_cast<int64_t>(row) * k;
  const uint32_t* xb = reinterpret_cast<const uint32_t*>(xr);

  uint32_t bits[NPL];  // every load issued before any is used
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int c = lane + j * kWarp;
    bits[j] = c < k ? __ldg(xb + c) : kNegInfBits;
  }
  RegRow<NPL> keys;
  LaneStats st;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    keys.key[j] = st.note(bits[j], lane + j * kWarp);
  }
  select_row(keys, st, xr, vals + static_cast<int64_t>(row) * t,
             cls + static_cast<int64_t>(row) * t, k, t, scratch[warp],
             branches);
}

__global__ void __launch_bounds__(kSmemWarps* kWarp)
    row_topk_smem(const float* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ cls, int rows, int k, int t,
                  int* branches) {
  extern __shared__ uint32_t smem_keys[];
  __shared__ WarpScratch scratch[kSmemWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int row = blockIdx.x * kSmemWarps + warp;
  if (row >= rows) return;
  const int npl = (k + kWarp - 1) / kWarp;
  uint32_t* keys = smem_keys + static_cast<int64_t>(warp) * npl * kWarp;
  const float* xr = x + static_cast<int64_t>(row) * k;
  const uint32_t* xb = reinterpret_cast<const uint32_t*>(xr);
  LaneStats st;
#pragma unroll 8
  for (int j = 0; j < npl; ++j) {
    const int c = lane + j * kWarp;
    keys[j * kWarp + lane] = st.note(c < k ? __ldg(xb + c) : kNegInfBits, c);
  }
  __syncwarp();
  select_row(SmemRow{keys, npl, lane}, st, xr,
             vals + static_cast<int64_t>(row) * t,
             cls + static_cast<int64_t>(row) * t, k, t, scratch[warp],
             branches);
}

template <int NPL>
void launch_regs(const float* x, float* vals, int* cls, int rows, int k,
                 int t, int* branches, cudaStream_t stream) {
  const int blocks = (rows + kRegWarps - 1) / kRegWarps;
  row_topk_regs<NPL><<<blocks, kRegWarps * kWarp, 0, stream>>>(
      x, vals, cls, rows, k, t, branches);
}

}  // namespace

extern "C" int row_topk_max_k() { return kMaxK; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller checks shapes: 1 <= t <= k, k <= row_topk_max_k().
// `branches`: null, or 4 ints to which the kernel adds the rows that
// took each branch (no candidate, at most t, more than t, a NaN).
extern "C" int row_topk_f32_branches(const float* x, float* vals, int* cls,
                                     int rows, int k, int t, int* branches,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows > 0) {
    const int npl = (k + kWarp - 1) / kWarp;
    if (npl <= 4) {
      launch_regs<4>(x, vals, cls, rows, k, t, branches, stream);
    } else if (npl <= 8) {
      launch_regs<8>(x, vals, cls, rows, k, t, branches, stream);
    } else if (npl <= 16) {
      launch_regs<16>(x, vals, cls, rows, k, t, branches, stream);
    } else if (npl <= 24) {
      launch_regs<24>(x, vals, cls, rows, k, t, branches, stream);
    } else if (npl <= 32) {
      launch_regs<32>(x, vals, cls, rows, k, t, branches, stream);
    } else if (npl <= kMaxNpl) {
      launch_regs<kMaxNpl>(x, vals, cls, rows, k, t, branches, stream);
    } else {
      const size_t bytes =
          static_cast<size_t>(kSmemWarps) * npl * kWarp * sizeof(uint32_t);
      cudaError_t err = cudaFuncSetAttribute(
          row_topk_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
      const int blocks = (rows + kSmemWarps - 1) / kSmemWarps;
      row_topk_smem<<<blocks, kSmemWarps * kWarp, bytes, stream>>>(
          x, vals, cls, rows, k, t, branches);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The same without the branch counts: the C interface every version of
// this kernel has had, through which tools/time_k1.py times a variant.
extern "C" int row_topk_f32(const float* x, float* vals, int* cls, int rows,
                            int k, int t, void* stream_ptr) {
  return row_topk_f32_branches(x, vals, cls, rows, k, t, nullptr,
                               stream_ptr);
}
