// Flash attention, forward, with GQA head sharing, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py).  It computes the
// same function: softmax(q kᵀ · sm_scale) v per query head, the query head
// h reading kv head h / (Hq / Hkv), with a running (max m, sum l,
// accumulator) state in f32, a bottom-right aligned causal mask (key j is
// valid for query i when i + Skv − Sq ≥ j), keys past Skv masked and their
// rows zero, a fully masked key tile adding nothing, the denominator
// floored at 1e-30 (a query row with no valid key outputs 0), and the
// output in q's type.
//
// Work split.  The TPU kernel walks a sequential grid (head, q tile, kv
// tile) and carries the softmax state in scratch memory between grid
// steps.  Here the blocks run in parallel: one block per (batch·head,
// q tile), and the kv sweep is a loop inside the block.  Under the causal
// mask the sweep stops at the last tile that meets the diagonal (the tiles
// after it are fully masked and would add nothing).  The grid puts the
// heads on x and the q tiles, longest first, on y, so the first wave holds
// every head's longest tile.
//
// bf16 (the serving path): a warp-specialised wgmma + TMA kernel.
//
// * Bound on this card (H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s).  At
//   the serving shape of qwen2-1.5b (q 4×12×2048×128, k/v 4×2×2048×128,
//   causal) the work is 4·D per valid (query, key) pair per query head,
//   5.16·10¹⁰ FLOP, 52 µs on the tensor cores, against 58.7 MB moved
//   (18 µs): the tensor cores bound it, and only wgmma reaches their rate.
// * One producer warp: a single thread issues TMA loads, Q once, then K
//   and V tiles of BK keys into a ring of kStages stages with full and
//   empty mbarriers.  Each of q, k, v has a 3-D tensor map (D, S, B·H), so
//   a box past a head's Sq or Skv is zero-filled by the hardware instead of
//   reading the next head's rows.  The maps are built on the host by
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//   -lcuda), and passed as __grid_constant__ parameters.  Rows are stored
//   with the 128-byte swizzle (64-byte at D = 32) that wgmma reads without
//   bank conflicts; D = 128 is two 64-column boxes.
// * NWG ∈ {1, 2} consumer warpgroups of 64 query rows each (block_q = 64 or
//   128).  Per K/V tile a consumer runs S = Q·Kᵀ as wgmma m64nBKk16 from
//   shared memory, the online softmax in registers (exp2 with scale·log2 e
//   folded into one FMA when the scale is positive; masks only on tiles
//   that meet the diagonal or the Skv edge), rounds P to bf16 in registers (the JAX blockwise version
//   rounds it to v's type) and feeds it as the register A operand of
//   O += P·V, wgmma m64nDk16 with V read from shared memory as a transposed
//   (MN-major) B.  The two consumer warpgroups run on their own, so one's
//   softmax can overlap the other's products.
// * Registers.  With 2·128 + 32 threads (9 warps, 3 on one of the SM's four
//   schedulers) a thread may hold at most 168 registers; the BK = 128 tile
//   needs 167.  setmaxnreg would not raise that: ptxas still allocated the
//   consumers within the launch bound's 168 under a 24/240 split, so the
//   producer is one warp and nothing is reallocated.  For the same reason
//   FA3's intra-warpgroup pipelining (S(t+1) issued beside P(t)·V(t), which
//   needs a second P) spilled, and an explicit ping-pong of the two
//   warpgroups measured no faster than this loop; neither is kept.
// * What it leaves for later: a persistent schedule (the Q load and the
//   epilogue of each block are not overlapped with another block's work)
//   and a TMA store of O.
//
// f32 (off the serving path; the smoke configs' D = 16 runs only here):
// scalar f32 FMAs over shared memory (the tensor cores would round f32
// inputs to TF32); scores, probabilities and the accumulator live in shared
// memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kF32Threads = 256;
constexpr int kStages = 2;              // K/V ring depth of the bf16 kernel
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may use

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Keys [0, end) can be valid for query rows up to `last_row`.
__device__ __forceinline__ int kv_end_for(int last_row, int shift, int skv, int causal) {
  return causal ? max(0, min(skv, last_row + shift + 1)) : skv;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

template <int D, int NWG, int BK>
struct Bf16Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span = bytes of one stored row
  static constexpr int CH = SW / 2;              // head-dim columns per TMA box
  static constexpr int NCH = D / CH;             // boxes per row
  static constexpr int KSTEPS_PER_CH = SW / 32;  // k-steps of 16 columns per box
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = NWG * 128 + 32;  // consumer warpgroups + one producer warp
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // from a 1024-byte aligned base: Q, K ring, V ring, barriers
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + kStages * KV_BYTES;
  static constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
};

template <int D, int NWG, int BK>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int hq,
            int hkv, int sq, int skv, float scale_log2, float score_scale, int causal) {
  // scale > 0: scale_log2 = scale·log2 e is folded into the exponent, and the
  // row max is taken on the raw scores.  scale ≤ 0 reverses or flattens their
  // order: the host passes score_scale = scale·log2 e and scale_log2 = 1, and
  // the scores are scaled before the max (score_scale = 1 otherwise).
  using C = Bf16Cfg<D, NWG, BK>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* ks = base + C::OFF_K;
  unsigned char* vs = base + C::OFF_V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + C::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int bh = blockIdx.x, h = bh % hq;
  const int kvh = (bh / hq) * hkv + h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // longest causal tiles first
  const int shift = skv - sq;
  const int n_tiles = (kv_end_for(min(q0 + C::BQ, sq) - 1, shift, skv, causal) + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, NWG * 128);  // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // ------------------------------------- producer warp
    if (threadIdx.x == NWG * 128) {
      prefetch_tensormap(&tq);
      prefetch_tensormap(&tk);
      prefetch_tensormap(&tv);
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::NCH; ++c)
        tma_load_3d(qs + c * C::BQ * C::SW, &tq, q_full, c * C::CH, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + s, ((t / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(k_full + s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          tma_load_3d(ks + s * C::KV_BYTES + c * BK * C::SW, &tk, k_full + s, c * C::CH,
                      t * BK, kvh);
        mbar_arrive_expect_tx(v_full + s, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::NCH; ++c)
          tma_load_3d(vs + s * C::KV_BYTES + c * BK * C::SW, &tv, v_full + s, c * C::CH,
                      t * BK, kvh);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int row_lo = q0 + wg * 64;
  const int r0 = row_lo + warp * 16 + gid, r1 = r0 + 8;
  // this warpgroup's own sweep: it may end a tile before the block's
  const int wg_tiles =
      row_lo < sq ? (kv_end_for(min(row_lo + 63, sq - 1), shift, skv, causal) + BK - 1) / BK : 0;
  const unsigned char* q_wg = qs + wg * 64 * C::SW;

  float acc[D / 2];  // O, 64 × D, f32
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1 (before scale_log2)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the running sums
  float sc[BK / 2];                      // S of the tile, then its P in f32
  uint32_t pa[BK / 16][4];               // P in bf16: the A fragments of P·V

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    mbar_wait(k_full + s, parity);
    if (t >= wg_tiles) {  // past this warpgroup's diagonal: release the stage only
      mbar_arrive(empty + s);
      continue;
    }

    // S = Q·Kᵀ, 64 × BK, both operands K-major in shared memory
    const unsigned char* k_st = ks + s * C::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / C::KSTEPS_PER_CH, off = (kk % C::KSTEPS_PER_CH) * 32;
      wgmma_ss<BK>(sc, smem_desc<C::SW>(q_wg + c * C::BQ * C::SW + off, 16, 8 * C::SW),
                   smem_desc<C::SW>(k_st + c * BK * C::SW + off, 16, 8 * C::SW), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (score_scale != 1.f) {  // uniform across the launch
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= score_scale;
    }

    // masks, only on a tile that meets the diagonal or the Skv edge
    const int k0 = t * BK;
    if (k0 + BK > skv || (causal && k0 + BK - 1 > row_lo + shift)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * tig + (e & 1);
          const int qi = e < 2 ? r0 : r1;
          if (kj >= skv || (causal && kj > qi + shift)) sc[4 * j + e] = -INFINITY;
        }
      }
    }
    // online softmax: the scale is folded into the exponent's FMA
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // a row with no valid key so far keeps max −inf: subtract 0 there, so
    // its masked scores give exp2(−inf) = 0 and its (zero) state scales by 0
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float al0 = fast_exp2(m0 * scale_log2 - ms0);
    const float al1 = fast_exp2(m1 * scale_log2 - ms1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -ms0));
      sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -ms0));
      sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -ms1));
      sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -ms1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      // two neighbouring 8-key tiles of P are one bf16 A fragment
      pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[4 * dn] *= al0;
      acc[4 * dn + 1] *= al0;
      acc[4 * dn + 2] *= al1;
      acc[4 * dn + 3] *= al1;
    }

    // O += P·V, V (BK × D, D contiguous) read as a transposed B
    mbar_wait(v_full + s, parity);
    const unsigned char* v_st = vs + s * C::KV_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk], smem_desc<C::SW>(v_st + kk * 16 * C::SW, BK * C::SW, 8 * C::SW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(empty + s);
  }

  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* op = o + (size_t)bh * sq * D + 2 * tig;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * D + 8 * dn) =
          pack_bf16(acc[4 * dn] / d0, acc[4 * dn + 1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * D + 8 * dn) =
          pack_bf16(acc[4 * dn + 2] / d1, acc[4 * dn + 3] / d1);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, state in shared memory
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Threads)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int hq, int hkv, int sq,
           int skv, int bq, int bk, float scale, int causal) {
  constexpr int LD = D + 1;  // odd row stride: threads on neighbouring rows hit distinct banks
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // bq × LD
  float* Ks = Qs + bq * LD;    // bk × LD
  float* Vs = Ks + bk * LD;    // bk × D
  float* S = Vs + bk * D;      // bq × bk: scores, then probabilities
  float* acc = S + bq * bk;    // bq × D
  float* m_s = acc + bq * D;   // bq running maxima
  float* l_s = m_s + bq;       // bq running sums
  float* a_s = l_s + bq;       // bq rescale factors of the current tile

  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int bh = blockIdx.y, h = bh % hq;
  const int kvh = (bh / hq) * hkv + h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int shift = skv - sq;
  const float* qp = q + (size_t)bh * sq * D;
  const float* kp = k + (size_t)kvh * skv * D;
  const float* vp = v + (size_t)kvh * skv * D;

  for (int i = tid; i < bq * D; i += nt) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = q0 + r < sq ? qp[(size_t)(q0 + r) * D + c] : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < bq; r += nt) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int block_end = kv_end_for(min(q0 + bq, sq) - 1, shift, skv, causal);
  for (int k0 = 0; k0 < block_end; k0 += bk) {
    __syncthreads();
    for (int i = tid; i < bk * D; i += nt) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < skv;  // rows past Skv are zero, so 0 · padding stays 0
      Ks[r * LD + c] = in ? kp[(size_t)(k0 + r) * D + c] : 0.f;
      Vs[i] = in ? vp[(size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < bq * bk; i += nt) {
      const int r = i / bk, c = i % bk;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + c * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      S[i] = s * scale;
    }
    __syncthreads();
    for (int r = warp; r < bq; r += nw) {  // one warp per row: max, probabilities, sum
      const int qi = q0 + r;
      float* sr = S + r * bk;
      float mx = kNegInf;
      for (int c = lane; c < bk; c += 32) {
        const int kj = k0 + c;
        const bool ok = kj < skv && (!causal || qi + shift >= kj);
        if (!ok) sr[c] = kNegInf;
        mx = fmaxf(mx, sr[c]);
      }
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const int kj = k0 + c;
        const bool ok = kj < skv && (!causal || qi + shift >= kj);
        const float p = ok ? expf(sr[c] - m_new) : 0.f;
        sr[c] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < bq * D; i += nt) {
      const int r = i / D, c = i % D;
      const float* pr = S + r * bk;
      float pv = 0.f;
#pragma unroll 16
      for (int j = 0; j < bk; ++j) pv = fmaf(pr[j], Vs[j * D + c], pv);
      acc[i] = acc[i] * a_s[r] + pv;
    }
  }
  __syncthreads();
  float* op = o + (size_t)bh * sq * D;
  for (int i = tid; i < bq * D; i += nt) {
    const int r = i / D, c = i % D;
    if (q0 + r < sq) op[(size_t)(q0 + r) * D + c] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

size_t f32_smem_bytes(int d, int bq, int bk) {
  return sizeof(float) * ((size_t)bq * (d + 1) + (size_t)bk * (d + 1) + (size_t)bk * d +
                          (size_t)bq * bk + (size_t)bq * d + 3 * (size_t)bq);
}

template <int D>
size_t bf16_smem_bytes(int bq, int bk) {
  if (bq == 64) return bk == 64 ? Bf16Cfg<D, 1, 64>::SMEM : Bf16Cfg<D, 1, 128>::SMEM;
  return bk == 64 ? Bf16Cfg<D, 2, 64>::SMEM : Bf16Cfg<D, 2, 128>::SMEM;
}

size_t smem_bytes(int dtype, int d, int bq, int bk) {
  if (dtype == 0) return f32_smem_bytes(d, bq, bk);
  switch (d) {
    case 32: return bf16_smem_bytes<32>(bq, bk);
    case 64: return bf16_smem_bytes<64>(bq, bk);
    default: return bf16_smem_bytes<128>(bq, bk);
  }
}

bool blocks_ok(int dtype, int bq, int bk) {
  if (dtype == 1) return (bq == 64 || bq == 128) && (bk == 64 || bk == 128);
  return bq >= 16 && bq <= 128 && bq % 16 == 0 && bk >= 64 && bk % 64 == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cuTensorMapEncodeTiled, from the driver the runtime already loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, S, BH) bf16 tensor, boxes of `ch` columns × `rows` rows of one head.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int s, int bh, int ch, int rows,
                int sw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {(cuuint32_t)ch, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int hq,
                        int hkv, int sq, int skv, float scale, int causal, cudaStream_t stream) {
  using C = Bf16Cfg<D, NWG, BK>;
  const float scale_log2 = scale * 1.4426950408889634f;
  if (skv == 0)  // no key for any query: every row is 0 (and a tensor map needs extent ≥ 1)
    return cudaMemsetAsync(o, 0, (size_t)b * hq * sq * D * 2, stream);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, sq, b * hq, C::CH, C::BQ, C::SW) ||
      !tensor_map(&tk, k, D, skv, b * hkv, C::CH, BK, C::SW) ||
      !tensor_map(&tv, v, D, skv, b * hkv, C::CH, BK, C::SW))
    return cudaErrorInvalidValue;
  auto kernel = fa_fwd_bf16<D, NWG, BK>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * hq, (sq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq,
                                                hkv, sq, skv, scale > 0.f ? scale_log2 : 1.f,
                                                scale > 0.f ? 1.f : scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int hq,
                       int hkv, int sq, int skv, int bq, int bk, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D, bq, bk);
  cudaError_t err = allow_smem(fa_fwd_f32<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + bq - 1) / bq, b * hq);
  fa_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), hq, hkv, sq, skv, bq, bk, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o, int b,
                     int hq, int hkv, int sq, int skv, int bq, int bk, float scale, int causal,
                     cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, b, hq, hkv, sq, skv, bq, bk, scale, causal, stream);
  if (bq == 64)
    return bk == 64 ? launch_bf16<D, 1, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, stream)
                    : launch_bf16<D, 1, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, stream);
  return bk == 64 ? launch_bf16<D, 2, 64>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, stream)
                  : launch_bf16<D, 2, 128>(q, k, v, o, b, hq, hkv, sq, skv, scale, causal, stream);
}

}  // namespace

extern "C" {


// Shared memory a launch of these parameters needs (dtype 0 = f32, 1 = bf16).
size_t fa_smem_bytes(int dtype, int d, int block_q, int block_k) {
  return smem_bytes(dtype, d, block_q, block_k);
}

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o (B, Hq, Sq, D), all contiguous and
// 16-byte aligned.  D ∈ {32, 64, 128}, and 16 in f32 only (the wgmma tiles of
// the bf16 kernel assume D ≥ 32).  bf16: block_q ∈ {64, 128}, block_k ∈
// {64, 128}.  f32: block_q a multiple of 16 in [16, 128], block_k a multiple
// of 64.  Returns the launch's cudaError_t (0 on success).
int fa_forward_launch(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                      int b, int hq, int hkv, int sq, int skv, int block_q, int block_k,
                      float scale, int causal, void* stream) {
  const bool d_ok = d == 32 || d == 64 || d == 128 || (d == 16 && dtype == 0);
  if ((dtype != 0 && dtype != 1) || !d_ok || !blocks_ok(dtype, block_q, block_k) || hkv <= 0 ||
      hq % hkv || smem_bytes(dtype, d, block_q, block_k) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hq == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    // f32 only: launch_d<16> would instantiate the bf16 configurations
    case 16: return (int)launch_f32<16>(q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    case 32: return (int)launch_d<32>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    case 64: return (int)launch_d<64>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    default: return (int)launch_d<128>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
  }
}

}  // extern "C"
