// Flash attention, forward, with GQA head sharing, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention/flash_attention.py).  It computes the
// same function: softmax(q kᵀ · sm_scale) v per query head, the query head
// h reading kv head h / (Hq / Hkv), with a running (max m, sum l,
// accumulator) state in f32, a bottom-right aligned causal mask (key j is
// valid for query i when i + Skv − Sq ≥ j), keys past Skv masked and their
// rows zeroed, a fully masked key tile adding nothing, the denominator
// floored at 1e-30 (a query row with no valid key outputs 0), and the
// output in q's type.
//
// Work split.  The TPU kernel walks a sequential grid (head, q tile, kv
// tile) and carries the softmax state in scratch memory between grid
// steps.  Here the blocks run in parallel: one block per (batch·head,
// q tile), and the kv sweep is a loop inside the block, which stages each
// K/V tile in shared memory.  Under the causal mask the loop stops at the
// last tile that meets the diagonal (the tiles after it are fully masked
// and would add nothing), and the q tiles are issued longest first.
//
// Two instantiations, both templated on the head dim D ∈ {32, 64, 128}:
//
// * bf16: each warp owns 16 query rows and keeps its Q fragments, its
//   scores and its output accumulator in registers; both products run on
//   the tensor cores as mma.sync m16n8k16 bf16 → f32, 64 keys per softmax
//   step.  The probabilities are rounded to bf16 for P·V, as the JAX
//   package's blockwise version rounds them to v's type.
// * f32: scalar f32 FMAs over shared memory (the tensor cores would round
//   f32 inputs to TF32); scores, probabilities and the accumulator live in
//   shared memory.
//
// Bound on this card (H100 SXM, 989 TFLOP/s dense bf16, 3.35 TB/s).  At
// the serving shape of qwen2-1.5b (q 4×12×2048×128, k/v 4×2×2048×128,
// causal) the work is 4·B·Hq·Sq·Skv·D/2 ≈ 5.2·10¹⁰ FLOP, 52 µs on the
// tensor cores, against ≈ 59 MB moved (q, k, v read once, o written once:
// ≈ 18 µs at 3.35 TB/s), so the tensor cores bound it.
// What this simple design leaves on the table: wgmma (mma.sync reaches a
// fraction of the tensor-core rate), TMA loads and a multi-stage K/V ring
// (each tile is loaded, then computed, with the block waiting between),
// warp specialisation, exp2 with the scale folded in, ldmatrix for the
// fragments, and a persistent schedule.  Those are for the redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kKeyStep = 64;            // keys per softmax step (bf16 kernel)
constexpr int kF32Threads = 256;
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may use

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x));
}

// c += a · b for one 16×8 tile, bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  return causal ? min(skv, last_row + shift + 1) : skv;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync, one warp per 16 query rows
// ---------------------------------------------------------------------------
//
// Fragment layouts of m16n8k16 (PTX ISA), with gid = lane / 4, tig = lane % 4:
//   A (16×16, row major): regs {0,1,2,3} hold rows {gid, gid+8, gid, gid+8},
//     columns 2·tig + {0,1} (regs 0, 1) and 2·tig + 8 + {0,1} (regs 2, 3);
//   B (16×8): regs {0,1} hold rows 2·tig + {0,1} and 2·tig + 8 + {0,1}, column gid;
//   C (16×8, f32): c0, c1 at row gid, columns 2·tig + {0,1}; c2, c3 at row gid+8.
// Two neighbouring C tiles of the scores are one A fragment of P for P·V.

template <int D>
__global__ void __launch_bounds__(256)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int hq,
            int hkv, int sq, int skv, int bk, float scale, int causal) {
  constexpr int LDS = D + 8;          // padded shared row: conflict-free fragment loads
  constexpr int NT = kKeyStep / 8;    // score tiles per step
  constexpr int DT = D / 8;           // output tiles
  constexpr int KD = D / 16;          // k-steps of q·kᵀ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // bk × LDS
  __nv_bfloat16* Vs = Ks + bk * LDS;                                // bk × LDS

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int bq = (blockDim.x >> 5) * 16;
  const int bh = blockIdx.y, h = bh % hq;
  const int kvh = (bh / hq) * hkv + h / (hq / hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;  // longest causal tiles first
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;
  const int shift = skv - sq;
  const __nv_bfloat16* qp = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kp = k + (size_t)kvh * skv * D;
  const __nv_bfloat16* vp = v + (size_t)kvh * skv * D;

  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = 16 * kk + 2 * tig;
    qa[kk][0] = r0 < sq ? ld32(qp + (size_t)r0 * D + c) : 0u;
    qa[kk][1] = r1 < sq ? ld32(qp + (size_t)r1 * D + c) : 0u;
    qa[kk][2] = r0 < sq ? ld32(qp + (size_t)r0 * D + c + 8) : 0u;
    qa[kk][3] = r1 < sq ? ld32(qp + (size_t)r1 * D + c + 8) : 0u;
  }
  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the running sums

  const int block_end = kv_end_for(min(q0 + bq, sq) - 1, shift, skv, causal);
  const int warp_end = kv_end_for(min(q0 + warp * 16 + 15, sq - 1), shift, skv, causal);
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int k0 = 0; k0 < block_end; k0 += bk) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < bk * VEC; i += blockDim.x) {
      const int r = i / VEC, c = (i % VEC) * 8;
      int4 kv4 = make_int4(0, 0, 0, 0), vv4 = make_int4(0, 0, 0, 0);
      if (k0 + r < skv) {  // rows past Skv are zero, so 0 · padding stays 0
        kv4 = *reinterpret_cast<const int4*>(kp + (size_t)(k0 + r) * D + c);
        vv4 = *reinterpret_cast<const int4*>(vp + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<int4*>(Ks + r * LDS + c) = kv4;
      *reinterpret_cast<int4*>(Vs + r * LDS + c) = vv4;
    }
    __syncthreads();
    const int tile_end = min(bk, warp_end - k0);  // keys of this tile the warp can see
    for (int c0 = 0; c0 < tile_end; c0 += kKeyStep) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const __nv_bfloat16* kr = Ks + (c0 + 8 * j + gid) * LDS + 16 * kk + 2 * tig;
          mma_bf16(s[j], qa[kk], ld32(kr), ld32(kr + 8));
        }
      }
      uint32_t valid = 0;  // bit 4·j + e: score s[j][e] is a valid key
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + c0 + 8 * j + 2 * tig + (e & 1);
          const int qi = e < 2 ? r0 : r1;
          const bool ok = kj < skv && (!causal || qi + shift >= kj);
          s[j][e] = ok ? s[j][e] * scale : kNegInf;
          valid |= (ok ? 1u : 0u) << (4 * j + e);
          if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
          else mx1 = fmaxf(mx1, s[j][e]);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (valid >> (4 * j + e)) & 1u ? expf(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
          s[j][e] = p;
          if (e < 2) ps0 += p;
          else ps1 += p;
        }
      }
      l0 = al0 * l0 + ps0;
      l1 = al1 * l1 + ps1;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        acc[dn][0] *= al0;
        acc[dn][1] *= al0;
        acc[dn][2] *= al1;
        acc[dn][3] *= al1;
      }
#pragma unroll
      for (int ks = 0; ks < kKeyStep / 16; ++ks) {
        const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const __nv_bfloat16* vr = Vs + (c0 + 16 * ks + 2 * tig) * LDS + gid;
#pragma unroll
        for (int dn = 0; dn < DT; ++dn) {
          const __nv_bfloat16* col = vr + 8 * dn;
          const uint32_t b0 = bits16(col[0]) | (bits16(col[LDS]) << 16);
          const uint32_t b1 = bits16(col[8 * LDS]) | (bits16(col[9 * LDS]) << 16);
          mma_bf16(acc[dn], pa, b0, b1);
        }
      }
    }
  }
  const float d0 = fmaxf(quad_sum(l0), 1e-30f), d1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* op = o + (size_t)bh * sq * D + 2 * tig;
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r0 * D + 8 * dn) =
          pack_bf16(acc[dn][0] / d0, acc[dn][1] / d0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(op + (size_t)r1 * D + 8 * dn) =
          pack_bf16(acc[dn][2] / d1, acc[dn][3] / d1);
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

size_t smem_bytes(int dtype, int d, int bq, int bk) {
  if (dtype == 1) return (size_t)2 * bk * (d + 8) * sizeof(__nv_bfloat16);
  return sizeof(float) * ((size_t)bq * (d + 1) + (size_t)bk * (d + 1) + (size_t)bk * d +
                          (size_t)bq * bk + (size_t)bq * d + 3 * (size_t)bq);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t launch_d(int dtype, const void* q, const void* k, const void* v, void* o, int b,
                     int hq, int hkv, int sq, int skv, int bq, int bk, float scale, int causal,
                     cudaStream_t stream) {
  const size_t smem = smem_bytes(dtype, D, bq, bk);
  const dim3 grid((sq + bq - 1) / bq, b * hq);
  cudaError_t err;
  if (dtype == 1) {
    err = allow_smem(fa_fwd_bf16<D>, smem);
    if (err != cudaSuccess) return err;
    fa_fwd_bf16<D><<<grid, bq * 2, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), hq, hkv, sq, skv,
        bk, scale, causal);
  } else {
    err = allow_smem(fa_fwd_f32<D>, smem);
    if (err != cudaSuccess) return err;
    fa_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, skv, bq, bk, scale,
        causal);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory a launch of these parameters needs (dtype 0 = f32, 1 = bf16).
size_t fa_smem_bytes(int dtype, int d, int block_q, int block_k) {
  return smem_bytes(dtype, d, block_q, block_k);
}

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), o (B, Hq, Sq, D), all contiguous and
// 16-byte aligned.  block_q: a multiple of 16 in [16, 128]; block_k: a
// multiple of 64.  Returns the launch's cudaError_t (0 on success).
int fa_forward_launch(int dtype, int d, const void* q, const void* k, const void* v, void* o,
                      int b, int hq, int hkv, int sq, int skv, int block_q, int block_k,
                      float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || block_q < 16 || block_q > 128 || block_q % 16 ||
      block_k < kKeyStep || block_k % kKeyStep || hkv <= 0 || hq % hkv ||
      smem_bytes(dtype, d, block_q, block_k) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || hq == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch_d<32>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    case 64: return (int)launch_d<64>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    case 128: return (int)launch_d<128>(dtype, q, k, v, o, b, hq, hkv, sq, skv, block_q, block_k, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
