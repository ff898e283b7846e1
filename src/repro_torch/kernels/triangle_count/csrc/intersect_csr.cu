// Per-row intersections read straight from the CSR: the panel gather, the
// intersection and, for per-node and support, the scatter in one kernel.
//
// Replaces the reference's Pallas kernel family in
// src/repro/kernels/triangle_count/triangle_count.py, each together with
// the panel gather in front of it (gather_panels_arrays,
// src/repro/core/count.py:315) and the scatter behind it:
//   MODE_COUNT    -> intersect_count_pallas     (:223, body _kernel_count :79)
//   MODE_PER_NODE -> intersect_per_node_pallas  (:231, body _kernel_per_node :90)
//                    + _panel_scatter_per_node  (src/repro/core/engine.py:357)
//   MODE_SUPPORT  -> intersect_support_pallas   (:244, body _kernel_support :104)
//                    + _panel_scatter_support   (src/repro/core/engine.py:373)
//
// For each query row i with u[i], v[i] >= 0 the kernel intersects the two
// sorted out-neighbour lists col[row_offsets[u] : ...] and
// col[row_offsets[v] : ...], each cut to its first `width` entries as the
// gather cuts a panel; a row with u or v = -1 (chunk padding) adds nothing.
//   MODE_COUNT    out (B,): the row's number of common entries.
//   MODE_PER_NODE out (n_out,), zeroed by the caller: each common entry x
//                 adds 1 to out[x] (the third vertex, as the panel arm bills
//                 it), and the row's count adds to out[u] and out[v].
//   MODE_SUPPORT  out (m_out,), zeroed by the caller: each common entry adds
//                 1 to the two directed edges that hold it, out[row_offsets[u]
//                 + j] and out[row_offsets[v] + k] (j, k its slots in u's and
//                 v's lists), and the row's count adds to out[edge_idx[i]].
// Every scatter index is clipped to [0, n_out) as the reference clips it.
//
// Design.  The TPU kernels need both panels materialised at the bucket's
// width (mostly -1 padding), reduce an Lu x Lv equality cube, and return
// (B, Lu) / (B, Lv) attribution arrays that a scatter then adds up.  Here a
// group of G lanes takes one row: it reads the two lists' bounds from
// row_offsets (no padding, no length search), stages the longer list in its
// share of shared memory with coalesced loads, and binary-searches each
// entry of the shorter list there: min(du, dv) * log2 max(du, dv)
// shared-memory compares.  A longer list than the share (kShare entries) is
// searched in global memory by the same code.  By default G follows the
// bucket width (8 lanes for width 16, 16 for 64, a warp above), so narrow
// rows do not leave most of a warp idle, and a block holds 256 threads.  A
// tuner may instead set both knobs at run time (core/tuning.py): rows per
// block and lanes per row G in {8, 16, 32}, with rows * G a multiple of 32
// up to 1,024 threads (the group reduction is a full-mask warp shuffle, so
// every warp must be whole) and rows * min(width, kShare) * 4 bytes of
// shared memory under kMaxSmem; above 48 KB the launch opts in.  A pick
// outside those limits is refused (cudaErrorInvalidValue), never replaced.
// The result does not depend on the knobs.  A hit at slot i of the shorter list and slot
// p of the longer one knows both slots, so the support scatter needs no
// second search.  The count is a shuffle reduction inside the group; the
// per-node and support adds are int32 atomics, whose sums are the same in
// any order, so every mode is deterministic.
//
// Bound on this card: each distinct list read once, plus u, v (edge_idx),
// two row_offsets pairs per row and each output slot the hits touch, at
// 3.35 TB/s; the compares at the scalar rate are far below that.  Per-node
// hits pile onto the hubs (the common neighbour is the higher-ranked
// vertex), so their atomics contend on a few slots.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MODE_COUNT = 0;
constexpr int MODE_PER_NODE = 1;
constexpr int MODE_SUPPORT = 2;

constexpr int kThreads = 256;       // the default pick's block
constexpr int kMaxThreads = 1024;   // a tuned pick's block, at most
constexpr int kShare = 1024;        // ints of shared memory per row group, at most
constexpr size_t kMaxSmem = 232448;     // 227 KB: a block's dynamic shared memory, at most
constexpr size_t kDefaultSmem = 49152;  // 48 KB: beyond it a launch must opt in

// Lower bound of x in row[0:n).
__device__ __forceinline__ int lower_bound(const int* row, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// out + idx with idx clipped to [0, n_out).
__device__ __forceinline__ int* clipped(int* out, long long idx, long long n_out) {
  return out + (idx < 0 ? 0 : (idx < n_out ? idx : n_out - 1));
}

// Entries of shorter[lane::G] (at col[sb:]) found in longer[0:n) (at
// col[lb:]), each hit scattered as MODE says; returns the lane's hits.
template <int G, int MODE>
__device__ __forceinline__ int hits_in(const int* longer, int n, int lb,
                                       const int* __restrict__ shorter, int m, int sb,
                                       int lane, int* __restrict__ out, long long n_out) {
  int hits = 0;
  for (int i = lane; i < m; i += G) {
    const int x = __ldg(shorter + i);
    const int pos = lower_bound(longer, n, x);
    if (pos < n && longer[pos] == x) {
      ++hits;
      if (MODE == MODE_PER_NODE) atomicAdd(clipped(out, x, n_out), 1);
      if (MODE == MODE_SUPPORT) {
        atomicAdd(clipped(out, static_cast<long long>(lb) + pos, n_out), 1);
        atomicAdd(clipped(out, static_cast<long long>(sb) + i, n_out), 1);
      }
    }
  }
  return hits;
}

// One block of blockDim.x / G row groups (blockDim.x a multiple of 32).
template <int G, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
intersect_csr_kernel(const int* __restrict__ row_offsets, const int* __restrict__ col,
                     const int* __restrict__ u, const int* __restrict__ v,
                     const int* __restrict__ edge_idx, int64_t n_rows, int width, int share,
                     int* __restrict__ out, long long n_out) {
  extern __shared__ int smem[];
  const int groups = blockDim.x / G;
  const int group = threadIdx.x / G, lane = threadIdx.x % G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * groups + group;
  int* mine = smem + group * share;

  int su = -1, sv = -1;
  int lb = 0, ln = 0, sb = 0, sn = 0;  // longer list: base, length; shorter: base, length
  if (row < n_rows) {
    su = u[row];
    sv = v[row];
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
    hits = staged ? hits_in<G, MODE>(mine, ln, lb, col + sb, sn, sb, lane, out, n_out)
                  : hits_in<G, MODE>(col + lb, ln, lb, col + sb, sn, sb, lane, out, n_out);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) hits += __shfl_xor_sync(0xffffffffu, hits, off);
  if (lane != 0 || row >= n_rows) return;
  if (MODE == MODE_COUNT) {
    out[row] = hits;
  } else if (hits > 0) {  // a row with hits has u, v >= 0
    if (MODE == MODE_PER_NODE) {
      atomicAdd(clipped(out, su, n_out), hits);
      atomicAdd(clipped(out, sv, n_out), hits);
    } else {
      const int e = edge_idx[row];
      if (e >= 0) atomicAdd(clipped(out, e, n_out), hits);
    }
  }
}

template <int G, int MODE>
cudaError_t launch(const int* ro, const int* col, const int* u, const int* v, const int* edge_idx,
                   int64_t n_rows, int width, int rows_per_block, int* out, long long n_out,
                   cudaStream_t stream) {
  const int threads = rows_per_block * G;
  if (rows_per_block < 1 || threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int share = min(width, kShare);
  const int64_t n_blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (n_blocks > 2147483647LL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * static_cast<size_t>(rows_per_block) * share;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    // always the ceiling, never this launch's size: a smaller setting from
    // another thread's launch must not undercut a larger one in flight
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_csr_kernel<G, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
  }
  intersect_csr_kernel<G, MODE><<<static_cast<unsigned int>(n_blocks), threads, smem, stream>>>(
      ro, col, u, v, edge_idx, n_rows, width, share, out, n_out);
  return cudaGetLastError();
}

// lanes = 0 (and rows_per_block = 0): the default pick, G by width and a
// 256-thread block.
template <int MODE>
cudaError_t launch_mode(const int* ro, const int* col, const int* u, const int* v,
                        const int* edge_idx, int64_t n_rows, int width, int rows_per_block,
                        int lanes, int* out, long long n_out, cudaStream_t s) {
  if (lanes == 0 && rows_per_block == 0) {
    lanes = width <= 16 ? 8 : (width <= 64 ? 16 : 32);
    rows_per_block = kThreads / lanes;
  }
  switch (lanes) {
    case 8:
      return launch<8, MODE>(ro, col, u, v, edge_idx, n_rows, width, rows_per_block, out, n_out, s);
    case 16:
      return launch<16, MODE>(ro, col, u, v, edge_idx, n_rows, width, rows_per_block, out, n_out,
                              s);
    case 32:
      return launch<32, MODE>(ro, col, u, v, edge_idx, n_rows, width, rows_per_block, out, n_out,
                              s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes.  mode is 0 (count), 1 (per-node) or 2
// (support).  row_offsets (n + 1,), col, u, v (B,), edge_idx (B,; support
// only, else null) and out are int32 device arrays; out holds B counts
// (count) or n_out >= 1 slots, zeroed by the caller (per-node, support).
// width >= 1 is the bucket width.  rows_per_block and lanes are the tuner's
// knobs, both 0 for the default pick.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int tc_intersect_csr_launch(int mode, const void* row_offsets, const void* col,
                                       const void* u, const void* v, const void* edge_idx,
                                       long long n_rows, int width, int rows_per_block,
                                       int lanes, void* out, long long n_out, void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 1) return cudaErrorInvalidValue;
  if ((lanes == 0) != (rows_per_block == 0)) return cudaErrorInvalidValue;
  if (mode != MODE_COUNT && n_out < 1) return cudaErrorInvalidValue;
  if (mode == MODE_SUPPORT && edge_idx == nullptr) return cudaErrorInvalidValue;
  const int* ro = static_cast<const int*>(row_offsets);
  const int* c = static_cast<const int*>(col);
  const int* pu = static_cast<const int*>(u);
  const int* pv = static_cast<const int*>(v);
  const int* pe = static_cast<const int*>(edge_idx);
  int* po = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_COUNT:
      return launch_mode<MODE_COUNT>(ro, c, pu, pv, pe, n_rows, width, rows_per_block, lanes, po,
                                     n_out, s);
    case MODE_PER_NODE:
      return launch_mode<MODE_PER_NODE>(ro, c, pu, pv, pe, n_rows, width, rows_per_block, lanes,
                                        po, n_out, s);
    case MODE_SUPPORT:
      return launch_mode<MODE_SUPPORT>(ro, c, pu, pv, pe, n_rows, width, rows_per_block, lanes,
                                       po, n_out, s);
    default:
      return cudaErrorInvalidValue;
  }
}
