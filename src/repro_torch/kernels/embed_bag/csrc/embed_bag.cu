// Embedding bag (K6) for Hopper (sm_90a): out[b] = sum_l table[idx[b, l]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/embed_bag/kernel.py:
// embedding_bag.  There a sequential (B, L) grid streams one table row per
// step into a revisited output block, zeroed at l = 0.  Here every bag is
// one group of `tpb` lanes of a warp (tpb a power of two, the least that
// covers the row in 16-byte pieces, at most 32: 16 lanes for a float32
// row of 64), so several bags share a warp and nothing carries between
// blocks.  The group reads its bag's L indices once, coalesced, one per
// lane, and hands them round with __shfl_sync; each lane then streams its
// piece of every row, in l order, into float32 registers from zero, and
// writes the (B, D) float32 output once.  The sum is the Pallas grid's
// and the plain version's: acc = ((0 + r0) + r1) + ..., each add correctly
// rounded, so the kernel and the plain version agree bit for bit.
//
// Bound: device-memory bytes.  Per bag it reads L rows of D table
// elements and L int32 indices and writes D floats, with no arithmetic to
// speak of; rows are scattered over the table, so each is a separate
// 16-byte-aligned stream of D * sizeof(T) bytes.  Pieces are 16 bytes
// (float4, or eight bfloat16) when the table's base, row stride and row
// width allow it (the wrapper checks); otherwise every lane takes one
// element (D = 18 or 50, an unaligned view).  Indices are not range
// checked: in-range ids are the caller's contract, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct Piece;

// One element.
template <>
struct Piece<float, 1> {
  __device__ static void add(const float* p, float* acc) {
    acc[0] = __fadd_rn(acc[0], *p);
  }
};

template <>
struct Piece<__nv_bfloat16, 1> {
  __device__ static void add(const __nv_bfloat16* p, float* acc) {
    acc[0] = __fadd_rn(acc[0], __bfloat162float(*p));
  }
};

// Four float32 in one 16-byte load.
template <>
struct Piece<float, 4> {
  __device__ static void add(const float* p, float* acc) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    acc[0] = __fadd_rn(acc[0], v.x);
    acc[1] = __fadd_rn(acc[1], v.y);
    acc[2] = __fadd_rn(acc[2], v.z);
    acc[3] = __fadd_rn(acc[3], v.w);
  }
};

// Eight bfloat16 in one 16-byte load (conversion to float is exact).
template <>
struct Piece<__nv_bfloat16, 8> {
  __device__ static void add(const __nv_bfloat16* p, float* acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 pair;
      memcpy(&pair, &w[i], 4);
      const float2 f = __bfloat1622float2(pair);
      acc[2 * i] = __fadd_rn(acc[2 * i], f.x);
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], f.y);
    }
  }
};

// One bag per group of `tpb` lanes; lane j of the group owns pieces j,
// j + tpb, ... of the row (chunks = D / VEC pieces).  Every lane runs the
// same loop counts (chunks, L and tpb are uniform), so the shuffles see
// the whole warp; lanes past the last bag or the last piece load nothing.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, long long ld,
               const int* __restrict__ idx, long long sb, long long sl,
               long long n_bags, int n_len, int chunks, int tpb,
               float* __restrict__ out) {
  const int lane = threadIdx.x & (tpb - 1);
  const long long bag =
      (long long)blockIdx.x * (kThreads / tpb) + threadIdx.x / tpb;
  const bool active = bag < n_bags;
  const int* bag_idx = idx + (active ? bag : 0) * sb;
  const long long d = (long long)chunks * VEC;
  for (int j0 = 0; j0 < chunks; j0 += tpb) {
    const int j = j0 + lane;
    const bool mine = active && j < chunks;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int l0 = 0; l0 < n_len; l0 += tpb) {
      const int n = min(tpb, n_len - l0);
      const int my_row =
          (active && lane < n) ? bag_idx[(long long)(l0 + lane) * sl] : 0;
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const int row = __shfl_sync(0xffffffffu, my_row, k, tpb);
        if (mine)
          Piece<T, VEC>::add(table + (long long)row * ld + (long long)j * VEC,
                             acc);
      }
    }
    if (mine) {
      float* o = out + bag * d + (long long)j * VEC;
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(o + v) =
              make_float4(acc[v], acc[v + 1], acc[v + 2], acc[v + 3]);
      } else {
        o[0] = acc[0];
      }
    }
  }
}

template <typename T, int VEC>
void launch(const void* table, long long ld, const void* idx, long long sb,
            long long sl, long long n_bags, int n_len, int d, void* out,
            cudaStream_t s) {
  const int chunks = d / VEC;
  int tpb = 1;
  while (tpb < chunks && tpb < 32) tpb *= 2;
  const long long per_block = kThreads / tpb;
  const dim3 grid((unsigned)((n_bags + per_block - 1) / per_block));
  bag_kernel<T, VEC><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(table), ld, static_cast<const int*>(idx), sb, sl,
      n_bags, n_len, chunks, tpb, static_cast<float*>(out));
}

}  // namespace

// table: (V, D) float32 (bf16 == 0) or bfloat16, rows `ld` elements apart,
// unit column stride; idx: int32, element (b, l) at idx[b * sb + l * sl];
// out: (n_bags, D) float32, contiguous.  vec selects the 16-byte path.
extern "C" int embed_bag(const void* table, int bf16, long long ld,
                         const void* idx, long long sb, long long sl,
                         long long n_bags, int n_len, int d, int vec,
                         void* out, void* stream) {
  if (n_bags > 0 && d > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16) {
      if (vec)
        launch<__nv_bfloat16, 8>(table, ld, idx, sb, sl, n_bags, n_len, d,
                                 out, s);
      else
        launch<__nv_bfloat16, 1>(table, ld, idx, sb, sl, n_bags, n_len, d,
                                 out, s);
    } else {
      if (vec)
        launch<float, 4>(table, ld, idx, sb, sl, n_bags, n_len, d, out, s);
      else
        launch<float, 1>(table, ld, idx, sb, sl, n_bags, n_len, d, out, s);
    }
  }
  return (int)cudaGetLastError();
}
