// Sorted-set intersection of -1-padded neighbor panels, one warp per row.
//
// Replaces the reference's Pallas kernel family in
// src/repro/kernels/triangle_count/triangle_count.py:
//   MODE_COUNT    -> intersect_count_pallas     (:223, body _kernel_count :79)
//   MODE_PER_NODE -> intersect_per_node_pallas  (:231, body _kernel_per_node :90)
//   MODE_SUPPORT  -> intersect_support_pallas   (:244, body _kernel_support :104)
//
// Inputs: a (B, Lu) and b (B, Lv), int32 or int16, row-major and
// contiguous.  Each row holds a strictly increasing prefix of valid ids
// (>= 0) followed by -1 padding, as the engine's panel gather produces it.
// Outputs (int32): count (B,); arm (B, Lu) with arm[i, j] = 1 when a[i, j]
// occurs in b[i] (0 on padding); closure (B, Lv) with closure[i, k] = 1
// when b[i, k] occurs in a[i].
//
// Bound: the bytes of the two panels plus the outputs.  The TPU kernel
// spends Lu*Lv compares per row on an equality cube so its vector unit
// stays full; here each lane takes entries of a's valid prefix and
// binary-searches them in b's valid prefix, Lu*log2(Lv) work per row, so
// the compares are far below the card's rate and the panels' reads
// dominate.  The valid lengths come from a binary search on the monotone
// predicate x >= 0, so padding is never scanned.  count is a warp-shuffle
// reduction written once per row: no atomics, deterministic.  Row offsets
// are 64-bit so B * L may exceed 2^31.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MODE_COUNT = 0;
constexpr int MODE_PER_NODE = 1;
constexpr int MODE_SUPPORT = 2;

// Length of the valid prefix: the first index whose entry is negative.
template <typename T>
__device__ __forceinline__ int64_t valid_length(const T* row, int64_t len) {
  int64_t lo = 0, hi = len;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int>(row[mid]) >= 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Lower bound of x in row[0:n).
template <typename T>
__device__ __forceinline__ int64_t lower_bound(const T* row, int64_t n, int x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (static_cast<int>(row[mid]) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename T, int MODE>
__global__ void intersect_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                 int64_t n_rows, int64_t lu, int64_t lv,
                                 int32_t* __restrict__ count,
                                 int32_t* __restrict__ arm,
                                 int32_t* __restrict__ closure) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp leaves together
  const T* ar = a + row * lu;
  const T* br = b + row * lv;
  const int64_t nu = valid_length(ar, lu);
  const int64_t nv = valid_length(br, lv);

  int32_t* clo = nullptr;
  if (MODE == MODE_SUPPORT) {
    clo = closure + row * lv;
    for (int64_t k = lane; k < lv; k += 32) clo[k] = 0;
    __syncwarp();
  }

  int local = 0;
  const int64_t arm_end = (MODE == MODE_COUNT) ? nu : lu;
  for (int64_t j = lane; j < arm_end; j += 32) {
    int hit = 0;
    if (j < nu) {
      const int x = static_cast<int>(ar[j]);
      const int64_t pos = lower_bound(br, nv, x);
      hit = (pos < nv && static_cast<int>(br[pos]) == x) ? 1 : 0;
      if (MODE == MODE_SUPPORT && hit) clo[pos] = 1;
    }
    if (MODE != MODE_COUNT) arm[row * lu + j] = hit;
    local += hit;
  }

  for (int off = 16; off > 0; off >>= 1) local += __shfl_down_sync(0xffffffffu, local, off);
  if (lane == 0) count[row] = local;
}

template <typename T>
cudaError_t launch_typed(int mode, const void* a, const void* b, int64_t n_rows,
                         int64_t lu, int64_t lv, void* count, void* arm,
                         void* closure, int warps_per_block, cudaStream_t stream) {
  const int threads = warps_per_block * 32;
  const int64_t n_blocks = (n_rows + warps_per_block - 1) / warps_per_block;
  if (n_blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 blocks(static_cast<unsigned int>(n_blocks));
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  int32_t* pc = static_cast<int32_t*>(count);
  int32_t* parm = static_cast<int32_t*>(arm);
  int32_t* pclo = static_cast<int32_t*>(closure);
  switch (mode) {
    case MODE_COUNT:
      intersect_kernel<T, MODE_COUNT><<<blocks, threads, 0, stream>>>(
          pa, pb, n_rows, lu, lv, pc, parm, pclo);
      break;
    case MODE_PER_NODE:
      intersect_kernel<T, MODE_PER_NODE><<<blocks, threads, 0, stream>>>(
          pa, pb, n_rows, lu, lv, pc, parm, pclo);
      break;
    case MODE_SUPPORT:
      intersect_kernel<T, MODE_SUPPORT><<<blocks, threads, 0, stream>>>(
          pa, pb, n_rows, lu, lv, pc, parm, pclo);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  elem_bytes is 4 (int32) or 2 (int16);
// mode is 0 (count), 1 (per-node) or 2 (support).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tc_intersect_launch(int elem_bytes, int mode, const void* a,
                                   const void* b, long long n_rows, long long lu,
                                   long long lv, void* count, void* arm,
                                   void* closure, int warps_per_block,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  if (warps_per_block < 1 || warps_per_block > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_typed<int32_t>(mode, a, b, n_rows, lu, lv, count, arm, closure,
                                 warps_per_block, s);
  if (elem_bytes == 2)
    return launch_typed<int16_t>(mode, a, b, n_rows, lu, lv, count, arm, closure,
                                 warps_per_block, s);
  return cudaErrorInvalidValue;
}
