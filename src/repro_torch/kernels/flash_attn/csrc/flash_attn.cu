// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention in
// src/repro/kernels/flash_attn/kernel.py (K7), with the masking of its
// oracle flash_attn/ref.py: causal alignment bottom-right (key j is visible
// to query i when j <= i + S_k - S_q) and keys past S_k never counted.
// It computes what the TPU kernel computes: scores in float32, an online
// softmax with a running max and sum in float32, P.V accumulated in
// float32, divided by max(l, 1e-30) at the end, and the output cast to
// q's type.  Inputs are float32 or bfloat16; a bfloat16 call needs
// 16-byte aligned rows (the wrapper makes an unaligned view contiguous).
//
// Layout: q (B, S_q, HQ, D), k and v (B, S_k, HK, D), the model's own
// layout, read through element strides (D contiguous), so no transpose
// copy is made.  GQA: query head h reads kv head h / (HQ / HK).
//
// Bound: at the serving path's prefill (B 1, H 16, S 32 768, D 64,
// causal) the work is B.H.S^2.D.2 flops (the causal half of 4.S^2.D) on
// 4 x 64 MB of data: about 2.2 TFLOP against 256 MB, so it is bound by
// arithmetic, not bytes.  Two kernels, one block per (batch x head, query
// tile) each, causal key tiles past the query tile's diagonal never
// loaded and the heaviest query tiles scheduled first:
//
//  * flash_fwd_mma, for bfloat16 inputs with 16-byte aligned rows (the
//    prefill path): the two products on the tensor cores with mma.sync
//    m16n8k16 (bf16 operands, float32 accumulators).  Four warps, 16
//    query rows each, keep their q fragments, scores, probabilities and
//    output accumulator in registers; K and V tiles of 64 keys are staged
//    through shared memory (rows padded by 16 bytes, so ldmatrix is free
//    of bank conflicts) and read with ldmatrix (V transposed on the fly).
//    The scores are exact bf16 products summed in float32, times
//    scale * log2(e) in float32; the softmax runs in base 2 (exp2f); the
//    probabilities enter the second product rounded to bf16, as a bf16
//    kernel on any matrix unit takes them.
//  * flash_fwd, for float32 inputs: float32 SIMT arithmetic, q scaled
//    first.  D / 32 threads share a query row
//    (one thread for D <= 32), each keeping 32 of its dims of q and of the
//    accumulator in registers; partial dot products meet through warp
//    shuffles.  K and V tiles of 32 keys are staged through shared memory
//    as float32 and read as float4 broadcasts.
//
// Neither pipelines its loads (no cp.async/TMA ring) or uses wgmma: the
// Hopper redesign (wgmma, TMA, warp specialisation) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;                // keys per shared-memory tile
constexpr float kNegInf = -1e30f;      // the running max's start value

struct Strides {
  long long b, s, h;                   // element strides; D is contiguous
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int HQ,
          int group,
          int Sq, int Sk, Strides qs, Strides ks_, Strides vs_,
          Strides os, float scale, int causal) {
  constexpr int DPT = D < 32 ? D : 32;  // dims per thread
  constexpr int TPR = D / DPT;          // threads per query row
  constexpr int BQ = kThreads / TPR;    // query rows per block
  constexpr int C4 = DPT / 4;           // float4 chunks per thread
  __shared__ float4 k_tile[kBK][D / 4];
  __shared__ float4 v_tile[kBK][D / 4];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ, hk = h / group;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int qi = qt * BQ + row;
  const int offset = Sk - Sq;
  const bool q_valid = qi < Sq;

  // Chunk c of this thread holds dims (c * TPR + part) * 4 .. + 3, so the
  // TPR threads of a row read neighbouring float4s of a shared row.
  float qr[DPT], acc[DPT];
  const float* q_row = q + b * qs.b + (long long)qi * qs.s + h * qs.h;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + part) * 4 + e;
      qr[c * 4 + e] = q_valid ? __fmul_rn(q_row[d], scale) : 0.f;
      acc[c * 4 + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // Keys past the last row's diagonal are masked for the whole tile.
  const int kv_end = causal ? min(Sk, qt * BQ + BQ + offset) : Sk;
  const float* k_base = k + b * ks_.b + hk * ks_.h;
  const float* v_base = v + b * vs_.b + hk * vs_.h;
  float* k_flat = reinterpret_cast<float*>(&k_tile[0][0]);
  float* v_flat = reinterpret_cast<float*>(&v_tile[0][0]);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        kx = k_base[(long long)key * ks_.s + d];
        vx = v_base[(long long)key * vs_.s + d];
      }
      k_flat[idx] = kx;
      v_flat[idx] = vx;
    }
    __syncthreads();

    float s[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) s[j] = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
#pragma unroll
      for (int j = 0; j < kBK; ++j) {
        const float4 kk = k_tile[j][c * TPR + part];
        s[j] = fmaf(qr[c * 4 + 0], kk.x, s[j]);
        s[j] = fmaf(qr[c * 4 + 1], kk.y, s[j]);
        s[j] = fmaf(qr[c * 4 + 2], kk.z, s[j]);
        s[j] = fmaf(qr[c * 4 + 3], kk.w, s[j]);
      }
    }
    // The row's TPR partial dot products are on neighbouring lanes.
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    }
    // Masked keys score -inf, so their weight exp(-inf - m) is exactly 0;
    // every valid row sees key 0, so m is finite after the first tile.
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int key = k0 + j;
      const bool visible = key < Sk && (!causal || key <= qi + offset);
      s[j] = visible ? s[j] : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const float4 vv = v_tile[j][c * TPR + part];
        acc[c * 4 + 0] = fmaf(p, vv.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(p, vv.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(p, vv.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(p, vv.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (!q_valid) return;
  const float denom = fmaxf(l, 1e-30f);
  float* o_row = o + b * os.b + (long long)qi * os.s + h * os.h;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (c * TPR + part) * 4 + e;
      o_row[d] = __fdiv_rn(acc[c * 4 + e], denom);
    }
  }
}

// ------------------------------------------------- tensor-core (bf16) path
__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8x8 b16 matrices; lane l addresses row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kMmaBQ = 64;  // query rows per block: 16 per warp
constexpr int kMmaBK = 64;  // keys per shared-memory tile

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t.  A holds rows
// g and g + 8, columns 2t, 2t + 1 (+ 8); B holds column g, rows 2t, 2t + 1
// (+ 8); C holds rows g and g + 8, columns 2t, 2t + 1.  So the C fragments
// of two neighbouring 8-key score tiles are the A fragment of one 16-key
// step of the second product.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int HQ, int group, int Sq,
              int Sk, Strides qs, Strides ks_, Strides vs_, Strides os,
              float scale_log2, int causal) {
  constexpr int LD = D + 8;            // padded shared row, in elements
  constexpr int KSTEPS = D / 16;       // 16-dim steps of q.k
  constexpr int NS = kMmaBK / 8;       // 8-key score tiles
  constexpr int NO = D / 8;            // 8-dim output tiles
  __shared__ __align__(16) __nv_bfloat16 k_tile[kMmaBK * LD];
  __shared__ __align__(16) __nv_bfloat16 v_tile[kMmaBK * LD];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int b = blockIdx.y / HQ, h = blockIdx.y % HQ, hk = h / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int row0 = qt * kMmaBQ + warp * 16 + g, row1 = row0 + 8;
  const int offset = Sk - Sq;

  uint32_t qa[KSTEPS][4];
  const __nv_bfloat16* q_base = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int d = 16 * kk + 2 * t;
    qa[kk][0] = row0 < Sq ? ld_b32(q_base + (long long)row0 * qs.s + d) : 0u;
    qa[kk][1] = row1 < Sq ? ld_b32(q_base + (long long)row1 * qs.s + d) : 0u;
    qa[kk][2] =
        row0 < Sq ? ld_b32(q_base + (long long)row0 * qs.s + d + 8) : 0u;
    qa[kk][3] =
        row1 < Sq ? ld_b32(q_base + (long long)row1 * qs.s + d + 8) : 0u;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int kv_end = causal ? min(Sk, qt * kMmaBQ + kMmaBQ + offset) : Sk;
  const __nv_bfloat16* k_base = k + b * ks_.b + hk * ks_.h;
  const __nv_bfloat16* v_base = v + b * vs_.b + hk * vs_.h;

  for (int k0 = 0; k0 < kv_end; k0 += kMmaBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kMmaBK * D / 8; idx += kThreads) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8, key = k0 + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (key < Sk) {
        kx = *reinterpret_cast<const uint4*>(k_base + (long long)key * ks_.s
                                             + c);
        vx = *reinterpret_cast<const uint4*>(v_base + (long long)key * vs_.s
                                             + c);
      }
      *reinterpret_cast<uint4*>(&k_tile[r * LD + c]) = kx;
      *reinterpret_cast<uint4*>(&v_tile[r * LD + c]) = vx;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, &k_tile[(8 * (2 * jp + (mi >> 1)) + mr) * LD + 16 * kk
                            + 8 * (mi & 1)]);
        mma_bf16(s[2 * jp], qa[kk], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qa[kk], bk[2], bk[3]);
      }
    }
    // Scale into base 2 and mask: keys past S_k, and past the diagonal.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * t + (c & 1);
        const int row = c < 2 ? row0 : row1;
        const bool visible = key < Sk && (!causal || key <= row + offset);
        s[j][c] = visible ? s[j][c] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // A row's 8 keys of a tile sit on the 4 lanes of its quad.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    uint32_t pa[kMmaBK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      l0 += p0 + p1;  // this lane's share; the quad adds up at the end
      l1 += p2 + p3;
      pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, &v_tile[(16 * kk + 8 * (mi & 1) + mr) * LD
                                  + 8 * (2 * np + (mi >> 1))]);
        mma_bf16(acc[2 * np], pa[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o_base = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int d = 8 * n + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (long long)row0 * os.s + d) =
          pack_bf16(__fdiv_rn(acc[n][0], d0), __fdiv_rn(acc[n][1], d0));
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (long long)row1 * os.s + d) =
          pack_bf16(__fdiv_rn(acc[n][2], d1), __fdiv_rn(acc[n][3], d1));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool rows_aligned(const Strides& st) {
  return st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
}

template <int D>
void launch_mma(const void* q, const void* k, const void* v, void* o, int B,
                int HQ, int HK, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, int causal,
                cudaStream_t stream) {
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * HQ);
  flash_fwd_mma<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      HQ, HQ / HK, Sq, Sk, qs, ks, vs, os, scale * 1.4426950408889634f,
      causal);
}

// -------------------------------------------------------- float32 SIMT path
template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int HQ, int HK, int Sq, int Sk, Strides qs, Strides ks,
            Strides vs, Strides os, float scale, int causal,
            cudaStream_t stream) {
  constexpr int TPR = D < 32 ? 1 : D / 32;
  constexpr int BQ = kThreads / TPR;
  const dim3 grid((Sq + BQ - 1) / BQ, B * HQ);
  flash_fwd<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), HQ, HQ / HK, Sq,
      Sk, qs, ks, vs, os, scale, causal);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int HQ, int HK, int Sq, int Sk, int D, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 16: launch<16>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                        scale, causal, stream); break;
    case 32: launch<32>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                        scale, causal, stream); break;
    case 64: launch<64>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                        scale, causal, stream); break;
    case 128: launch<128>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                          scale, causal, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point: device pointers, element strides and the stream
// as arguments; returns cudaGetLastError() after the launch.
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int HQ, int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
          rows_aligned(qs) && rows_aligned(ks) && rows_aligned(vs) &&
          rows_aligned(os)))
      return (int)cudaErrorMisalignedAddress;
    switch (D) {
      case 16: launch_mma<16>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                              scale, causal, st); break;
      case 32: launch_mma<32>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                              scale, causal, st); break;
      case 64: launch_mma<64>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs, os,
                              scale, causal, st); break;
      case 128: launch_mma<128>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks, vs,
                                os, scale, causal, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  return dispatch(q, k, v, o, B, HQ, HK, Sq, Sk, D, qs, ks, vs, os, scale,
                  causal, st);
}
