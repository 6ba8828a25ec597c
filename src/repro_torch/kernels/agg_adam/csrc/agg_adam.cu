// Adam kernels of the aggregation service, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of src/repro/kernels/agg_adam/kernel.py:
//   agg_adam_multijob_fused  <- aggregate_adam_multijob_fused (K1): one
//       service tick, K jobs' owned blocks updated in place in one launch;
//   agg_adam_blocks          <- aggregate_adam_blocks (K3): one job's owned
//       blocks, packed outputs (the per-job block step);
//   agg_adam_dense           <- aggregate_adam (K5): dense Adam over a whole
//       (N,) tensor in place, p float32 or bfloat16, gradients (N,) or
//       (W, N) float32 or bfloat16 (the fused optimizer and the single-job
//       parameter-server step).
//
// Bound: device-memory bandwidth.  Per owned lane the update reads p, mu,
// nu and W gradient values and writes p, mu, nu: (24 + 4W) bytes for about
// 15 flops, two orders of magnitude below the H100's ridge point.  So the
// design only has to stream those bytes once, coalesced: one warp per
// owned block, 16-byte (float4) loads and stores when the block width is a
// multiple of 4 (block_align = 128 on the main path: one float4 per thread
// per array), each warp loading its own block index, job slot and
// hyperparameter row (Hopper has no scalar prefetch).  In place is
// hazard-free: blocks are exclusive to one job and each warp reads and
// writes only its own block, so warps may run in any order on any SM.
//
// Rounding: every operation is a correctly rounded intrinsic in the
// grouping of repro.ps.runtime._adam_math, with no FMA contraction, and the
// (1 - b) terms and bias-correction reciprocals arrive pre-folded in the
// hyperparameter table that the plain PyTorch version shares, so the
// kernel and the plain version agree bit for bit.  The W-way gradient sum
// runs in the fixed order w = 0 .. W-1, as the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int kHpCols = 16;  // lr, b1, 1-b1, b2, 1-b2, eps, bc1, bc2, wd, pad
constexpr int kWarpsPerCta = 8;

struct Hp {
  float lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd;
};

__device__ __forceinline__ Hp load_hp(const float* row) {
  Hp h;
  h.lr = row[0];
  h.b1 = row[1];
  h.omb1 = row[2];
  h.b2 = row[3];
  h.omb2 = row[4];
  h.eps = row[5];
  h.bc1 = row[6];
  h.bc2 = row[7];
  h.wd = row[8];
  return h;
}

__device__ __forceinline__ void adam_lane(const Hp& h, float p, float g,
                                          float& mu, float& nu, float& out_p) {
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mu_hat = __fmul_rn(mu, h.bc1);
  const float nu_hat = __fmul_rn(nu, h.bc2);
  float upd = __fdiv_rn(__fmul_rn(h.lr, mu_hat),
                        __fadd_rn(__fsqrt_rn(nu_hat), h.eps));
  if (h.wd != 0.0f) upd = __fadd_rn(upd, __fmul_rn(__fmul_rn(h.lr, h.wd), p));
  out_p = __fsub_rn(p, upd);
}

// Gradient of packed lane `i`: the W worker rows summed in order.
__device__ __forceinline__ float grad_at(const float* g, long long m, int w,
                                         long long i) {
  float s = g[i];
  for (int k = 1; k < w; ++k) s = __fadd_rn(s, g[k * m + i]);
  return s;
}

__device__ __forceinline__ float4 grad4_at(const float* g, long long m, int w,
                                           long long i) {
  float4 s = *reinterpret_cast<const float4*>(g + i);
  for (int k = 1; k < w; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(g + k * m + i);
    s.x = __fadd_rn(s.x, t.x);
    s.y = __fadd_rn(s.y, t.y);
    s.z = __fadd_rn(s.z, t.z);
    s.w = __fadd_rn(s.w, t.w);
  }
  return s;
}

// One warp per owned block.  p_src/mu_src/nu_src are read at block
// `src_blk` of their buffer, outputs written at block `dst_blk` of theirs;
// K1 passes the same buffers and block ids for both (in place), K3 reads
// mu/nu at the owned block and writes packed tile i.
template <bool kVec>
__device__ __forceinline__ void update_block(
    const Hp& h, const float* p_in, const float* mu_in, const float* nu_in,
    const float* g, long long m, int w, long long g_off,
    float* p_out, float* mu_out, float* nu_out, int block, int lane) {
  if (kVec) {
    for (int j = lane * 4; j < block; j += 32 * 4) {
      const float4 p = *reinterpret_cast<const float4*>(p_in + j);
      float4 mu = *reinterpret_cast<const float4*>(mu_in + j);
      float4 nu = *reinterpret_cast<const float4*>(nu_in + j);
      const float4 gv = grad4_at(g, m, w, g_off + j);
      float4 np;
      adam_lane(h, p.x, gv.x, mu.x, nu.x, np.x);
      adam_lane(h, p.y, gv.y, mu.y, nu.y, np.y);
      adam_lane(h, p.z, gv.z, mu.z, nu.z, np.z);
      adam_lane(h, p.w, gv.w, mu.w, nu.w, np.w);
      *reinterpret_cast<float4*>(p_out + j) = np;
      *reinterpret_cast<float4*>(mu_out + j) = mu;
      *reinterpret_cast<float4*>(nu_out + j) = nu;
    }
  } else {
    for (int j = lane; j < block; j += 32) {
      float mu = mu_in[j], nu = nu_in[j], np;
      adam_lane(h, p_in[j], grad_at(g, m, w, g_off + j), mu, nu, np);
      p_out[j] = np;
      mu_out[j] = mu;
      nu_out[j] = nu;
    }
  }
}

template <bool kVec>
__global__ void multijob_fused_kernel(float* p, float* mu, float* nu,
                                      const float* g, long long m, int w,
                                      const float* hp, const int* block_idx,
                                      const int* job_slot, long long n_own,
                                      int block) {
  const long long tile =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile >= n_own) return;
  const Hp h = load_hp(hp + (long long)job_slot[tile] * kHpCols);
  const long long dst = (long long)block_idx[tile] * block;
  update_block<kVec>(h, p + dst, mu + dst, nu + dst, g, m, w, tile * block,
                     p + dst, mu + dst, nu + dst, block, threadIdx.x & 31);
}

template <bool kVec>
__global__ void blocks_kernel(const float* p, int p_packed, const float* g,
                              long long m, int w, const float* mu,
                              const float* nu, const float* hp,
                              const int* block_idx, long long n_own, int block,
                              float* out_p, float* out_mu, float* out_nu) {
  const long long tile =
      (long long)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile >= n_own) return;
  const Hp h = load_hp(hp);
  const long long own = (long long)block_idx[tile] * block;
  const long long packed = tile * block;
  update_block<kVec>(h, p + (p_packed ? packed : own), mu + own, nu + own, g,
                     m, w, packed, out_p + packed, out_mu + packed,
                     out_nu + packed, block, threadIdx.x & 31);
}

// ---- K5: dense Adam.  Bound by bytes like K1: per lane 22 B with bf16
// p and g (p read and written, g read, mu and nu read and written in
// fp32), 28 B in fp32, (W - 1) x 2 or 4 B more for W gradient rows.  One
// thread per 4 consecutive lanes, so a warp streams 128 lanes of every
// array in one coalesced pass: 16-byte float4 accesses for fp32 arrays
// and 8-byte (four bf16) accesses for bf16 ones when every buffer is
// 16-byte aligned (the wrapper checks; a view into a stacked tensor may
// not be) and, for W > 1, N % 4 == 0.  The tail (N % 4 lanes), and every
// lane of an unaligned call, take the scalar loop.  No padding copy: the
// last thread masks the ragged end itself.

template <typename T>
struct Lane;

template <>
struct Lane<float> {
  __device__ static float load(const float* x) { return *x; }
  __device__ static void store(float* x, float v) { *x = v; }
  __device__ static float4 load4(const float* x) {
    return *reinterpret_cast<const float4*>(x);
  }
  __device__ static void store4(float* x, float4 v) {
    *reinterpret_cast<float4*>(x) = v;
  }
};

template <>
struct Lane<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* x) {
    return __bfloat162float(*x);
  }
  __device__ static void store(__nv_bfloat16* x, float v) {
    *x = __float2bfloat16_rn(v);
  }
  __device__ static float4 load4(const __nv_bfloat16* x) {
    const uint2 raw = *reinterpret_cast<const uint2*>(x);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, 4);
    memcpy(&hi, &raw.y, 4);
    const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store4(__nv_bfloat16* x, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    memcpy(&raw.x, &lo, 4);
    memcpy(&raw.y, &hi, 4);
    *reinterpret_cast<uint2*>(x) = raw;
  }
};

constexpr int kDenseThreads = 256;

template <typename PT, typename GT, bool kVec>
__global__ void dense_kernel(PT* p, const GT* g, long long n, int w,
                             float* mu, float* nu, Hp h) {
  const long long i =
      ((long long)blockIdx.x * kDenseThreads + threadIdx.x) * 4;
  if (i >= n) return;
  if (kVec && i + 4 <= n) {
    float4 gs = Lane<GT>::load4(g + i);
    for (int k = 1; k < w; ++k) {
      const float4 t = Lane<GT>::load4(g + k * n + i);
      gs.x = __fadd_rn(gs.x, t.x);
      gs.y = __fadd_rn(gs.y, t.y);
      gs.z = __fadd_rn(gs.z, t.z);
      gs.w = __fadd_rn(gs.w, t.w);
    }
    const float4 pv = Lane<PT>::load4(p + i);
    float4 m = *reinterpret_cast<const float4*>(mu + i);
    float4 v = *reinterpret_cast<const float4*>(nu + i);
    float4 np;
    adam_lane(h, pv.x, gs.x, m.x, v.x, np.x);
    adam_lane(h, pv.y, gs.y, m.y, v.y, np.y);
    adam_lane(h, pv.z, gs.z, m.z, v.z, np.z);
    adam_lane(h, pv.w, gs.w, m.w, v.w, np.w);
    Lane<PT>::store4(p + i, np);
    *reinterpret_cast<float4*>(mu + i) = m;
    *reinterpret_cast<float4*>(nu + i) = v;
  } else {
    const long long end = i + 4 < n ? i + 4 : n;
    for (long long j = i; j < end; ++j) {
      float gj = Lane<GT>::load(g + j);
      for (int k = 1; k < w; ++k)
        gj = __fadd_rn(gj, Lane<GT>::load(g + k * n + j));
      float m = mu[j], v = nu[j], np;
      adam_lane(h, Lane<PT>::load(p + j), gj, m, v, np);
      Lane<PT>::store(p + j, np);
      mu[j] = m;
      nu[j] = v;
    }
  }
}

template <typename PT, typename GT>
void launch_dense(void* p, const void* g, long long n, int w, void* mu,
                  void* nu, const Hp& h, int vec, cudaStream_t s) {
  const long long quads = (n + 3) / 4;
  const dim3 grid((unsigned)((quads + kDenseThreads - 1) / kDenseThreads));
  auto* pp = static_cast<PT*>(p);
  auto* gp = static_cast<const GT*>(g);
  auto* mup = static_cast<float*>(mu);
  auto* nup = static_cast<float*>(nu);
  if (vec)
    dense_kernel<PT, GT, true><<<grid, kDenseThreads, 0, s>>>(pp, gp, n, w,
                                                              mup, nup, h);
  else
    dense_kernel<PT, GT, false><<<grid, kDenseThreads, 0, s>>>(pp, gp, n, w,
                                                               mup, nup, h);
}

inline unsigned grid_for(long long n_own) {
  return (unsigned)((n_own + kWarpsPerCta - 1) / kWarpsPerCta);
}

}  // namespace

extern "C" int agg_adam_multijob_fused(void* p, void* mu, void* nu,
                                       const void* g, long long m, int w,
                                       const void* hp, const void* block_idx,
                                       const void* job_slot, long long n_own,
                                       int block, int vec, void* stream) {
  if (n_own > 0) {
    const dim3 grid(grid_for(n_own)), cta(32 * kWarpsPerCta);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* pf = static_cast<float*>(p);
    auto* muf = static_cast<float*>(mu);
    auto* nuf = static_cast<float*>(nu);
    auto* gf = static_cast<const float*>(g);
    auto* hpf = static_cast<const float*>(hp);
    auto* bi = static_cast<const int*>(block_idx);
    auto* js = static_cast<const int*>(job_slot);
    if (vec)
      multijob_fused_kernel<true><<<grid, cta, 0, s>>>(pf, muf, nuf, gf, m, w,
                                                       hpf, bi, js, n_own,
                                                       block);
    else
      multijob_fused_kernel<false><<<grid, cta, 0, s>>>(pf, muf, nuf, gf, m, w,
                                                        hpf, bi, js, n_own,
                                                        block);
  }
  return (int)cudaGetLastError();
}

extern "C" int agg_adam_blocks(const void* p, int p_packed, const void* g,
                               long long m, int w, const void* mu,
                               const void* nu, const void* hp,
                               const void* block_idx, long long n_own,
                               int block, void* out_p, void* out_mu,
                               void* out_nu, int vec, void* stream) {
  if (n_own > 0) {
    const dim3 grid(grid_for(n_own)), cta(32 * kWarpsPerCta);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* pf = static_cast<const float*>(p);
    auto* gf = static_cast<const float*>(g);
    auto* muf = static_cast<const float*>(mu);
    auto* nuf = static_cast<const float*>(nu);
    auto* hpf = static_cast<const float*>(hp);
    auto* bi = static_cast<const int*>(block_idx);
    auto* op = static_cast<float*>(out_p);
    auto* om = static_cast<float*>(out_mu);
    auto* on = static_cast<float*>(out_nu);
    if (vec)
      blocks_kernel<true><<<grid, cta, 0, s>>>(pf, p_packed, gf, m, w, muf, nuf,
                                               hpf, bi, n_own, block, op, om,
                                               on);
    else
      blocks_kernel<false><<<grid, cta, 0, s>>>(pf, p_packed, gf, m, w, muf,
                                                nuf, hpf, bi, n_own, block, op,
                                                om, on);
  }
  return (int)cudaGetLastError();
}

extern "C" int agg_adam_dense(void* p, int p_bf16, const void* g, int g_bf16,
                              long long n, int w, void* mu, void* nu,
                              float lr, float b1, float omb1, float b2,
                              float omb2, float eps, float bc1, float bc2,
                              float wd, int vec, void* stream) {
  if (n > 0) {
    const Hp h{lr, b1, omb1, b2, omb2, eps, bc1, bc2, wd};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (p_bf16 && g_bf16)
      launch_dense<__nv_bfloat16, __nv_bfloat16>(p, g, n, w, mu, nu, h, vec, s);
    else if (p_bf16)
      launch_dense<__nv_bfloat16, float>(p, g, n, w, mu, nu, h, vec, s);
    else if (g_bf16)
      launch_dense<float, __nv_bfloat16>(p, g, n, w, mu, nu, h, vec, s);
    else
      launch_dense<float, float>(p, g, n, w, mu, nu, h, vec, s);
  }
  return (int)cudaGetLastError();
}
