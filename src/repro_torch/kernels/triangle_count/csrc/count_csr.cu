// Per-row intersection sizes read straight from the CSR: the panel gather
// fused into the count kernel.
//
// Replaces the reference's Pallas kernel `intersect_count_pallas`
// (src/repro/kernels/triangle_count/triangle_count.py:223, body
// _kernel_count :79) together with the panel gather in front of it
// (gather_panels_arrays, src/repro/core/count.py:315).  For each query row
// i with u[i], v[i] >= 0 it counts the common entries of the two sorted
// out-neighbour lists col[row_offsets[u] : ...] and col[row_offsets[v] :
// ...], each cut to its first `width` entries as the gather cuts a panel;
// a row with u or v = -1 (chunk padding) counts 0.  Output: int32 (B,).
//
// Design.  The TPU kernel needs both panels materialised at the bucket's
// width (mostly -1 padding) and reduces an Lu x Lv equality cube.  Here a
// group of G lanes takes one row: it reads the two lists' bounds from
// row_offsets (no padding, no length search), stages the longer list in
// its share of shared memory with coalesced loads, and binary-searches
// each entry of the shorter list there: min(du, dv) * log2 max(du, dv)
// shared-memory compares.  A longer list than the share (kShare entries)
// is searched in global memory by the same code.  G follows the bucket
// width (8 lanes for width 16, 16 for 64, a warp above), so narrow rows do
// not leave most of a warp idle.  The count is a shuffle reduction inside
// the group written once: no atomics, deterministic.
//
// Bound on this card: each valid list entry read once, plus u, v, two
// row_offsets pairs and one count per row, at 3.35 TB/s; the compares at
// the scalar rate are far below that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShare = 1024;  // ints of shared memory per row group, at most

// Lower bound of x in row[0:n).
__device__ __forceinline__ int lower_bound(const int* row, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Entries of shorter[lane::G] found in longer[0:n).
template <int G>
__device__ __forceinline__ int hits_in(const int* longer, int n,
                                       const int* __restrict__ shorter, int m, int lane) {
  int hits = 0;
  for (int i = lane; i < m; i += G) {
    const int x = __ldg(shorter + i);
    const int pos = lower_bound(longer, n, x);
    hits += (pos < n && longer[pos] == x) ? 1 : 0;
  }
  return hits;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
count_csr_kernel(const int* __restrict__ row_offsets, const int* __restrict__ col,
                 const int* __restrict__ u, const int* __restrict__ v, int64_t n_rows,
                 int width, int share, int* __restrict__ count) {
  extern __shared__ int smem[];
  constexpr int kGroups = kThreads / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kGroups + group;
  int* mine = smem + group * share;

  int lb = 0, ln = 0, sb = 0, sn = 0;  // longer list: base, length; shorter: base, length
  if (row < n_rows) {
    const int su = u[row], sv = v[row];
    if (su >= 0 && sv >= 0) {
      const int bu = row_offsets[su], du = min(row_offsets[su + 1] - bu, width);
      const int bv = row_offsets[sv], dv = min(row_offsets[sv + 1] - bv, width);
      if (du >= dv) { lb = bu; ln = du; sb = bv; sn = dv; }
      else { lb = bv; ln = dv; sb = bu; sn = du; }
    }
  }
  const bool staged = ln <= share;
  if (staged && sn > 0)
    for (int i = lane; i < ln; i += G) mine[i] = __ldg(col + lb + i);
  __syncwarp();  // every group of the warp passes here once

  int hits = 0;
  if (sn > 0)
    hits = staged ? hits_in<G>(mine, ln, col + sb, sn, lane)
                  : hits_in<G>(col + lb, ln, col + sb, sn, lane);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) hits += __shfl_xor_sync(0xffffffffu, hits, off);
  if (lane == 0 && row < n_rows) count[row] = hits;
}

template <int G>
cudaError_t launch(const int* ro, const int* col, const int* u, const int* v, int64_t n_rows,
                   int width, int* count, cudaStream_t stream) {
  constexpr int kGroups = kThreads / G;
  const int share = min(width, kShare);
  const int64_t n_blocks = (n_rows + kGroups - 1) / kGroups;
  if (n_blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * kGroups * share;  // <= 32 KB: no opt-in needed
  count_csr_kernel<G><<<static_cast<unsigned int>(n_blocks), kThreads, smem, stream>>>(
      ro, col, u, v, n_rows, width, share, count);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  row_offsets (n + 1,), col, u, v (B,) and
// count (B,) are int32 device arrays; width >= 1 is the bucket width.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tc_count_csr_launch(const void* row_offsets, const void* col, const void* u,
                                   const void* v, long long n_rows, int width, void* count,
                                   void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 1) return cudaErrorInvalidValue;
  const int* ro = static_cast<const int*>(row_offsets);
  const int* c = static_cast<const int*>(col);
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  int* out = static_cast<int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 16) return launch<8>(ro, c, pu, pv, n_rows, width, out, s);
  if (width <= 64) return launch<16>(ro, c, pu, pv, n_rows, width, out, s);
  return launch<32>(ro, c, pu, pv, n_rows, width, out, s);
}
