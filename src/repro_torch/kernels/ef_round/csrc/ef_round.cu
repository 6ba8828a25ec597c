// One error-feedback round of a compressed push, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's round (repro.ps.compression
// ef_transform between a row gather and a row scatter) is plain jnp, and the
// port ran it as about fifteen eager PyTorch passes (a gather of the owned
// ef rows, the add, a zero pad, the block max, quantize, dequantize, the
// residual, a scatter).  One launch does the whole round for one packed
// piece of a job's gradient:
//   g' = g + ef[rows]                 ef read through the owned-block rows
//   q  = dequantize(quantize(g'))     int8: one max-abs scale per 2048 lanes
//                                     bf16: a round trip through bfloat16
//   ef[rows] = g' - q                 the residual, in place
// and returns q in a new buffer.  g is only read.
//
// Bound: device-memory bandwidth.  Per lane the round reads g and ef and
// writes q and ef, 16 bytes, for a handful of flops.  The design streams
// those bytes once: one CTA of 256 threads per 2048-lane scale block, each
// thread 8 lanes as two 16-byte accesses per array, so a thread has 64 bytes
// of loads in flight before its block's max is known, and several CTAs an
// SM overlap one block's stores with the next block's loads.  Lane i of the
// piece lies at ef[rows[i / row_block] * row_block + i % row_block]; with a
// row width that is a multiple of 4 a float4 never straddles two rows, so
// the ef accesses are as coalesced as g's (512 contiguous bytes a row at
// row_block 128).  The block max is exact (a max of absolute values) from
// warp shuffles and shared memory; lanes at or past n count as 0, as the
// zero pad of the eager path does.  Everything else stays in registers.
//
// Rounding: every operation is a correctly rounded intrinsic in the eager
// path's grouping (x / s * 127, half to even, clamp, then q8 * s / 127 with
// a true division), with no FMA contraction, so q and the residual equal
// the plain PyTorch version (ref.py) bit for bit.  The code goes through an
// int as the eager path's int8 cast does, so a lane that rounds to -0 gives
// q = +0.  Inputs are finite, as the eager path's int8 cast assumes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScaleBlock = 2048;  // ps.compression.BLOCK, checked in ops.py
constexpr int kThreads = 256;
constexpr int kLanes = kScaleBlock / kThreads;  // 8 lanes a thread
constexpr int kGroups = kLanes / 4;             // as 2 float4s
constexpr int kWarps = kThreads / 32;

enum Kind { kInt8 = 0, kBf16 = 1 };

// Offset in ef of lane i of the piece: through the owned-block rows, or the
// identity when the job owns the whole buffer (rows == nullptr).
__device__ __forceinline__ long long ef_at(const long long* rows,
                                           int row_block, long long i) {
  if (rows == nullptr) return i;
  return rows[i / row_block] * row_block + i % row_block;
}

// Largest value of m over the CTA (m >= 0 everywhere).
__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
  return m;
}

template <int K>
__device__ __forceinline__ float round_trip(float x, float s) {
  if (K == kInt8) {
    int c = __float2int_rn(__fmul_rn(__fdiv_rn(x, s), 127.0f));
    c = min(max(c, -127), 127);
    return __fdiv_rn(__fmul_rn(__int2float_rn(c), s), 127.0f);
  }
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One CTA per 2048-lane scale block.  kVec: n, row_block and every buffer
// allow float4 accesses; else each thread takes 8 single lanes.
template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
    ef_round_kernel(const float* __restrict__ g, float* __restrict__ ef,
                    const long long* __restrict__ rows, int row_block,
                    float* __restrict__ q, long long n) {
  const long long base = (long long)blockIdx.x * kScaleBlock;
  float x[kLanes];
  long long at[kLanes];
  if (kVec) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long i = base + (long long)(k * kThreads + threadIdx.x) * 4;
      if (i < n) {
        at[k] = ef_at(rows, row_block, i);
        const float4 gv = __ldcs(reinterpret_cast<const float4*>(g + i));
        const float4 ev = *reinterpret_cast<const float4*>(ef + at[k]);
        x[4 * k + 0] = __fadd_rn(gv.x, ev.x);
        x[4 * k + 1] = __fadd_rn(gv.y, ev.y);
        x[4 * k + 2] = __fadd_rn(gv.z, ev.z);
        x[4 * k + 3] = __fadd_rn(gv.w, ev.w);
      } else {
        x[4 * k + 0] = x[4 * k + 1] = x[4 * k + 2] = x[4 * k + 3] = 0.0f;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const long long i = base + (long long)k * kThreads + threadIdx.x;
      if (i < n) {
        at[k] = ef_at(rows, row_block, i);
        x[k] = __fadd_rn(__ldcs(g + i), ef[at[k]]);
      } else {
        x[k] = 0.0f;
      }
    }
  }

  float s = 1.0f;
  if (K == kInt8) {
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) m = fmaxf(m, fabsf(x[k]));
    m = block_max(m);
    s = m > 0.0f ? m : 1.0f;  // a zero block quantizes to zeros
  }

  if (kVec) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long i = base + (long long)(k * kThreads + threadIdx.x) * 4;
      if (i < n) {
        float4 qv, rv;
        qv.x = round_trip<K>(x[4 * k + 0], s);
        qv.y = round_trip<K>(x[4 * k + 1], s);
        qv.z = round_trip<K>(x[4 * k + 2], s);
        qv.w = round_trip<K>(x[4 * k + 3], s);
        rv.x = __fsub_rn(x[4 * k + 0], qv.x);
        rv.y = __fsub_rn(x[4 * k + 1], qv.y);
        rv.z = __fsub_rn(x[4 * k + 2], qv.z);
        rv.w = __fsub_rn(x[4 * k + 3], qv.w);
        __stcs(reinterpret_cast<float4*>(q + i), qv);
        *reinterpret_cast<float4*>(ef + at[k]) = rv;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const long long i = base + (long long)k * kThreads + threadIdx.x;
      if (i < n) {
        const float qk = round_trip<K>(x[k], s);
        __stcs(q + i, qk);
        ef[at[k]] = __fsub_rn(x[k], qk);
      }
    }
  }
}

template <int K>
void launch(const float* g, float* ef, const long long* rows, int row_block,
            float* q, long long n, int vec, cudaStream_t s) {
  const unsigned grid = (unsigned)((n + kScaleBlock - 1) / kScaleBlock);
  if (vec)
    ef_round_kernel<K, true><<<grid, kThreads, 0, s>>>(g, ef, rows, row_block,
                                                       q, n);
  else
    ef_round_kernel<K, false><<<grid, kThreads, 0, s>>>(g, ef, rows,
                                                        row_block, q, n);
}

}  // namespace

// kind: 0 int8, 1 bf16.  rows: int64 owned-block rows of ef, or null for
// the identity.  vec: 1 when n and row_block are multiples of 4 and g, ef
// and q are 16-byte aligned.
extern "C" int ef_round(const void* g, void* ef, const void* rows,
                        int row_block, void* q, long long n, int kind, int vec,
                        void* stream) {
  if (n > 0) {
    auto* gp = static_cast<const float*>(g);
    auto* ep = static_cast<float*>(ef);
    auto* rp = static_cast<const long long*>(rows);
    auto* qp = static_cast<float*>(q);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == kInt8)
      launch<kInt8>(gp, ep, rp, row_block, qp, n, vec, s);
    else if (kind == kBf16)
      launch<kBf16>(gp, ep, rp, row_block, qp, n, vec, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
