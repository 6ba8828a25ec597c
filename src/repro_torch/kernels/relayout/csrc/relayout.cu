// Run-copy relayout of a plan-pair migration, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel relayout_scatter of
// src/repro/kernels/relayout/kernel.py (K2) and the staging gather its
// wrapper runs outside Pallas (jnp.take in src/repro/kernels/relayout/ops.py):
//   relayout_stage    staged_l[i] = src[i] >= 0 ? x_l[src[i]] : 0 for every
//                     lane i of the delta's touched blocks, every leaf l;
//   relayout_scatter  tile i of every staged leaf into block dst[i] of the
//                     matching base, in place.
// Both take ALL leaves (flat, mu, nu) in one launch through a small device
// table of leaf pointers.
//
// Bound: device-memory bandwidth.  A migration does no arithmetic; the
// least it can cost is reading the moved lanes once and writing the moved
// and vacated lanes once per leaf.  Staging reads each source lane once
// (plus one 4-byte index per lane, -1 for a lane that carries no payload,
// shared by all leaves) and writes the packed buffer coalesced; the
// scatter streams each staged tile with 16-byte accesses, one warp per
// block.  Staging into a SEPARATE buffer before the scatter is what makes
// the in-place scatter hazard-free while blocks run in parallel in any
// order: a run may land on another run's source lanes.  The buffer's
// write and read-back cost about as much again as the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerCta = 8;

__global__ void stage_kernel(const float* const* xs, float* const* outs,
                             int n_leaves, const int* src, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int s = src[i];
    for (int l = 0; l < n_leaves; ++l) outs[l][i] = s >= 0 ? xs[l][s] : 0.0f;
  }
}

template <bool kVec>
__global__ void scatter_kernel(float* const* bases, const float* const* staged,
                               int n_leaves, const int* dst, long long n_t,
                               int block) {
  const long long tile =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile >= n_t) return;
  const int lane = threadIdx.x & 31;
  const long long to = (long long)dst[tile] * block;
  const long long from = tile * block;
  for (int l = 0; l < n_leaves; ++l) {
    float* out = bases[l] + to;
    const float* in = staged[l] + from;
    if (kVec) {
      for (int j = lane * 4; j < block; j += 32 * 4)
        *reinterpret_cast<float4*>(out + j) =
            *reinterpret_cast<const float4*>(in + j);
    } else {
      for (int j = lane; j < block; j += 32) out[j] = in[j];
    }
  }
}

}  // namespace

extern "C" int relayout_stage(const void* xs, const void* outs, int n_leaves,
                              const void* src, long long n, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond
    stage_kernel<<<(unsigned)blocks, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float* const*>(xs), static_cast<float* const*>(outs),
        n_leaves, static_cast<const int*>(src), n);
  }
  return (int)cudaGetLastError();
}

extern "C" int relayout_scatter(const void* bases, const void* staged,
                                int n_leaves, const void* dst, long long n_t,
                                int block, int vec, void* stream) {
  if (n_t > 0) {
    const unsigned grid = (unsigned)((n_t + kWarpsPerCta - 1) / kWarpsPerCta);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* b = static_cast<float* const*>(bases);
    auto* st = static_cast<const float* const*>(staged);
    auto* d = static_cast<const int*>(dst);
    if (vec)
      scatter_kernel<true><<<grid, 32 * kWarpsPerCta, 0, s>>>(b, st, n_leaves,
                                                              d, n_t, block);
    else
      scatter_kernel<false><<<grid, 32 * kWarpsPerCta, 0, s>>>(b, st, n_leaves,
                                                               d, n_t, block);
  }
  return (int)cudaGetLastError();
}
