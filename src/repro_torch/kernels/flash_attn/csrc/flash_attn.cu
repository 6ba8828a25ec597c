// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention in
// src/repro/kernels/flash_attn/kernel.py (K7), with the masking of its
// oracle flash_attn/ref.py: causal alignment bottom-right (key j is visible
// to query i when j <= i + S_k - S_q) and keys past S_k never counted.
// It computes what the TPU kernel computes: scores in float32, an online
// softmax with a running max and sum in float32, P.V accumulated in
// float32, divided by max(l, 1e-30) (__fdiv_rn) at the end, and the output
// cast to q's type.
//
// Layout: q (B, S_q, HQ, D), k and v (B, S_k, HK, D), the model's own
// layout, read through their strides (D contiguous), so no transpose or
// padding copy is made.  GQA: query head h reads kv head h / (HQ / HK).
//
// Bound: at the serving path's prefill (B 1, H 16, S 32 768, D 64,
// causal) the work is B.H.S^2.D.2 flops (the causal half of 4.S^2.D) on
// 4 x 64 MB of data: 2.2 TFLOP against 256 MB, so it is bound by the
// tensor cores' operations (2.2 ms at 989 TFLOP/s).  The softmax's one
// exponential a score runs on the special-function unit at 16 a clock an
// SM: 8.6e9 / (132 x 16 x ~1.8 GHz) = 2.2 ms at D = 64 as well, so the
// exponentials have to overlap the products, or the two times add up.
//
// Two kernels, each one block per query tile and (batch, head), causal
// key tiles past the query tile's diagonal never loaded, the heaviest
// query tiles scheduled first:
//
//  * flash_fwd_wgmma, for bfloat16 at D = 64 and 128 (the prefill path),
//    built for Hopper:
//    - wgmma for both products (mma.sync does not reach the tensor cores'
//      full rate on Hopper, and blocks the warp while it runs).
//      S = Q K^T is m64n128k16 with both operands in 128-byte-swizzled
//      shared memory (K-major descriptors); O += P V takes P from
//      registers, rounded to bf16 (a warp's slice of the score
//      accumulator is laid out as the register A operand of the next
//      product), and V from shared memory as an MN-major operand (the
//      transpose bit), so V is never transposed in memory.
//    - TMA: q, k and v are 4-D tensor maps (D, H, S, B) over the model
//      layout's byte strides, boxes of 64 columns (128 B, the swizzle
//      width; D = 128 takes two) by a tile of rows; the GQA head is the
//      kv map's H coordinate, and a ragged S edge is TMA's zero fill plus
//      the mask below.  The Q tile is loaded once; K and V tiles of 128
//      keys go through a ring of stages with a full and an empty mbarrier
//      each (K and V apart, so K_{j+1} lands while P_j V_j runs).
//    - The query tile is the slow grid dimension, so the first wave holds
//      the longest tiles of every head and the last the shortest.
//    - Warp specialisation: one producer warpgroup, one thread of which
//      issues every TMA copy and hands registers back (setmaxnreg.dec);
//      64-row consumer warpgroups take them (setmaxnreg.inc).  D = 64 runs
//      three consumers (192 query rows a block), D = 128 two (128 rows):
//      each K/V tile is read from L2 once per 192 (128) query rows instead
//      of once per 64.
//    - Overlap of softmax and products, both ways the design allows:
//      inside each consumer warpgroup, S_j = Q K_j^T and
//      O += P_{j-1} V_{j-1} are issued as two commit groups, wait_group 1
//      returns with S_j while P_{j-1} V_{j-1} is still on the tensor
//      cores, and S_j's softmax (the exponentials) runs under it; across
//      warpgroups, the consumers take turns on named barriers to issue
//      their products, so one warpgroup's softmax runs while the next
//      one's products hold the tensor cores (without the turns they fall
//      into step, all in softmax or all waiting on the tensor cores
//      together, and the kernel took 4.92 ms instead of 4.20 at the
//      prefill's layer: scripts/torch_k7_variants.py, H100 SXM, 700 W).
//    - Softmax in base 2 with the scale folded into one FFMA:
//      p = exp2(s c - m c), c = scale log2(e) (ex2.approx).  With the
//      turns in place the exponentials are not the limit: taking a share
//      of them off the special-function unit (a polynomial on the FMA
//      pipe) made the kernel slower.
//    - Masks only where needed: the tiles before the query tile's
//      diagonal that end before S_k take no compare; the tiles that cross
//      the diagonal and a ragged last key tile are masked per element.
//    - D = 128 keeps each consumer's Q rows in registers, the A operand
//      of S = Q K^T (read once from the swizzled tile), so a k-step reads
//      only K from shared memory; D = 64 reads Q from shared memory.  At
//      granite-8b's layer (1, 32768, 32, 128), 8 kv heads, the card sits
//      at its 700 W limit and 1.40-1.55 GHz under this kernel, not the
//      1.83 GHz its 989 TFLOP/s assume (products alone run at ~96 % of the
//      tensor cores' peak at 1.5 GHz), and the K/V loads alone take 6 of
//      its 14 ms, so L2 is not the limit.  Q in registers took 4-5 % off;
//      a thread-block cluster of two query heads of one kv head sharing
//      each K/V tile by TMA multicast halved L2's reads and was no faster
//      (scripts/torch_k7_variants.py --shape d128, H100 SXM, 700 W).
//  * flash_fwd, for float32 inputs: float32 SIMT arithmetic, q scaled
//    first.  D / 32 threads share a query row
//    (one thread for D <= 32), each keeping 32 of its dims of q and of the
//    accumulator in registers; partial dot products meet through warp
//    shuffles.  K and V tiles of 32 keys are staged through shared memory
//    as float32 and read as float4 broadcasts.  It is on no model's path.
//
// The tensor maps are encoded on the host for every call through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint(ByVersion),
// so the library links against the CUDA runtime alone (no -lcuda).

#include <cuda.h>
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


// ------------------------------------------------------ Hopper (bf16) path
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Named barrier `id` over `n` threads: wait for it, or arrive and go on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of `bar` has completed.  A wait
// that has not completed after 4 s traps (the launch fails) instead of
// hanging the card: no sound run waits for more than microseconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, polls = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (++polls == 1024) {
      t0 = global_ns();
    } else if (polls > 1024 && (polls & 1023u) == 0 &&
               global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

// One TMA box from a 4-D map (coordinates innermost first) into shared
// memory, completing `bytes` of the barrier's expected transaction.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128B swizzle) in bits 62-63; base offset 0 (every tile starts
// on a 1024-byte swizzle period).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers that an in-flight
// wgmma owns across the fence/commit/wait points.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// d (64 x N, f32) (+)= A (64 x 16, smem desc) * B (16 x N, smem desc), both
// K-major; scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// d (64 x N, f32) += A (64 x 16, bf16 registers) * B (16 x N, smem desc,
// MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <> __device__ __forceinline__ void wgmma_ss<128>(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
template <> __device__ __forceinline__ void wgmma_rs<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) (+)= A (64 x 16, bf16 registers) * B (16 x 128, smem
// desc, K-major): S = Q K^T with Q in registers.
__device__ __forceinline__ void wgmma_rk128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Tile shapes of the bf16 kernel: NC consumer warpgroups of 64 query rows
// (BQ = 64 NC), BK keys a K/V tile, ST stages in the K/V ring; QR: each
// consumer's Q rows in registers for S = Q K^T (issue_s_rq), else read
// from shared memory at every k-step (issue_s).  Shared memory: D = 64,
// 24 KB of Q + 3 x 32 KB of K/V; D = 128, 32 + 2 x 64 KB.
template <int D> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int NC = 3, BK = 128, ST = 3, REG_LOAD = 32, REG_MMA = 160;
  static constexpr bool QR = false;
};
template <> struct Tiles<128> {
  static constexpr int NC = 2, BK = 128, ST = 2, REG_LOAD = 24, REG_MMA = 240;
  static constexpr bool QR = true;
};

// Fragment layouts (PTX ISA, wgmma m64nNk16): thread 32 w + 4 g + t of a
// warpgroup holds accumulator rows 16 w + g and 16 w + g + 8, columns
// 8 j + 2 t and + 1, as d[4 j + {0, 1}] and d[4 j + {2, 3}].  The register
// A operand of one 16-key step kk is the same four values of chunks 2 kk
// and 2 kk + 1, so the scores' accumulator becomes P without a shuffle.

// S (64 x BK) = Q_w (64 x D) K^T.  Q and K are in column blocks of 64
// (128 B rows, 128B swizzle), rows_q (rows_k) rows each: a 16-wide step kk
// starts kk % 4 x 32 B into block kk / 4; 8-row groups are 1024 B apart.
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_base,
                                        int rows_q, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk / 4), off = (kk % 4) * 32;
    wgmma_ss<BK>(s, desc_sw128(q_base + col * rows_q * 128 + off, 1, 64),
                 desc_sw128(k_base + col * BK * 128 + off, 1, 64), kk > 0);
  }
}

// The same product with Q_w in registers, the A operand of wgmma: a
// k-step reads only K from shared memory (K's 4 KB instead of Q's 2 KB
// and K's).  Only the BK = 128 form exists.
template <int D, int BK>
__device__ __forceinline__ void issue_s_rq(float (&s)[BK / 2],
                                           const uint32_t (&qf)[D / 16][4],
                                           uint32_t k_base) {
  static_assert(BK == 128, "wgmma_rk128 is the n128 form");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk / 4), off = (kk % 4) * 32;
    wgmma_rk128(s, qf[kk], desc_sw128(k_base + col * BK * 128 + off, 1, 64),
                kk > 0);
  }
}

// This thread's A fragments of its warpgroup's Q rows (the layout of the
// note above: k-step kk, rows 16 warp + g and + 8, columns 16 kk + 2 t4
// and + 8, two bf16 a register), read once from the 128B-swizzled Q tile
// at q_w: a row's 16-byte chunk c is stored at chunk c ^ (row % 8).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4],
                                             uint32_t q_w, int rows_q,
                                             int warp, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * warp + g + (r & 1) * 8;
      const int col = 16 * kk + 2 * t4 + (r >> 1) * 8;
      const int byte = (col % 64) * 2;
      const uint32_t addr = q_w + (col / 64) * rows_q * 128 + row * 128 +
                            ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(qf[kk][r]) : "r"(addr));
    }
  }
}

// S_w = Q_w K^T by either form.
template <int D, int BK, bool QR>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint32_t (&qf)[QR ? D / 16 : 1]
                                                             [4],
                                         uint32_t q_w, int rows_q,
                                         uint32_t k_base) {
  if constexpr (QR)
    issue_s_rq<D, BK>(s, qf, k_base);
  else
    issue_s<D, BK>(s, q_w, rows_q, k_base);
}

// O (64 x D) += P (64 x BK, bf16 registers) V (BK x D).  V is MN-major:
// a 16-key step is 16 rows of 128 B further; its two column blocks (D =
// 128) are BK x 128 B apart, the leading byte offset.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, p[kk], desc_sw128(v_base + kk * 16 * 128, BK * 128 / 16,
                                     64), 1);
}

template <int BK>
__device__ __forceinline__ void to_bf16_frags(const float (&s)[BK / 2],
                                              uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// Scores of invisible keys (past S_k, or past the diagonal) to -inf.
template <int BK>
__device__ __forceinline__ void mask_tile(float (&s)[BK / 2], int key0,
                                          int row0, int Sk, int offset,
                                          int causal, int t4) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = key0 + 8 * j + 2 * t4 + (c & 1);
      const int row = row0 + (c < 2 ? 0 : 8);
      if (key >= Sk || (causal && key > row + offset)) s[4 * j + c] = -INFINITY;
    }
  }
}

// The online softmax's step for one tile, in place: the rows' new running
// maxima m (the 4 lanes of a quad share a row), the scores turned into
// p = exp2(s c - m c), this lane's share of each row's sum in rs, and the
// factor a = exp2((m_old - m) c) by which the old O and l are rescaled.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float c,
                                             float& m0, float& m1, float& rs0,
                                             float& rs1, float& a0,
                                             float& a1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // A row with no visible key yet keeps m = -inf; its terms are all 0.
  const float mc0 = mx0 == -INFINITY ? 0.f : mx0 * c;
  const float mc1 = mx1 == -INFINITY ? 0.f : mx1 * c;
  a0 = ex2(fmaf(m0, c, -mc0));
  a1 = ex2(fmaf(m1, c, -mc1));
  m0 = mx0;
  m1 = mx1;
  rs0 = 0.f;
  rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
}

template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2], float a0,
                                          float a1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }
}

template <int D>
__global__ void __launch_bounds__(128 * (Tiles<D>::NC + 1), 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, int HQ, int group, int Sq,
                int Sk, Strides os, float scale_log2, int causal) {
  constexpr int NC = Tiles<D>::NC, BK = Tiles<D>::BK, ST = Tiles<D>::ST;
  constexpr bool QR = Tiles<D>::QR;
  constexpr int BQ = 64 * NC, CB = D / 64;  // CB: 64-column blocks
  constexpr uint32_t Q_BYTES = CB * BQ * 128, KV_BYTES = CB * BK * 128;
  extern __shared__ uint8_t smem_raw[];
  // mbarriers: Q full; per stage K full, K empty, V full, V empty.
  __shared__ __align__(8) uint64_t bars[1 + 4 * ST];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + Q_BYTES, v_s = k_s + ST * KV_BYTES;
  const uint32_t bar_q = smem_u32(bars);
  auto k_full = [&](int s) { return bar_q + 8u * (1 + s); };
  auto k_empty = [&](int s) { return bar_q + 8u * (1 + ST + s); };
  auto v_full = [&](int s) { return bar_q + 8u * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return bar_q + 8u * (1 + 3 * ST + s); };

  // The tile schedule (flash_attn/ops.py: tile_schedule has the same
  // formulas): key tiles [0, n_tiles) are visited, [0, n_unmasked) whole.
  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest causal tiles first
  const int b = blockIdx.x / HQ, h = blockIdx.x % HQ, hk = h / group;
  const int q0 = qt * BQ, offset = Sk - Sq;
  const int kv_end = causal ? min(Sk, q0 + BQ + offset) : Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_unmasked = (causal ? min(Sk, q0 + offset + 1) : Sk) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), NC * 4);  // one arrival per consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One if/else for the whole kernel: the two roles never reconverge, so
  // ptxas can honour setmaxnreg.
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Tiles<D>::REG_LOAD));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int c = 0; c < CB; ++c)
        tma_load_4d(q_s + c * BQ * 128, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        const uint32_t ph = (t / ST) & 1;
        mbar_wait(k_empty(s), ph ^ 1);
        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(k_s + s * KV_BYTES + c * BK * 128, &tm_k, k_full(s),
                      64 * c, hk, t * BK, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(v_s + s * KV_BYTES + c * BK * 128, &tm_v, v_full(s),
                      64 * c, hk, t * BK, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(Tiles<D>::REG_MMA));
    const int w = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + 64 * w + 16 * warp + g;  // and row0 + 8
    const uint32_t q_w = q_s + w * 64 * 128;
    float s_acc[BK / 2], o_acc[D / 2];
    uint32_t p[BK / 16][4], qf[QR ? D / 16 : 1][4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float rs0, rs1, a0, a1;

    // The consumers take turns to issue their products (named barrier
    // 1 + w: this warpgroup's 128 threads wait on it, the previous
    // warpgroup's 128 arrive), so one warpgroup's softmax runs while the
    // next one's products are on the tensor cores instead of all of them
    // reaching the same phase together.  Every consumer issues n_tiles + 1
    // batches; the last consumer opens the first turn and does not pass
    // on its last.
    const int next = 1 + (w + 1) % NC;
    const bool pass_last = w != NC - 1;
    if (w == NC - 1) named_arrive(1, 256);

    mbar_wait(bar_q, 0);
    if constexpr (QR) load_q_frags<D>(qf, q_w, BQ, warp, g, t4);
    // Tile 0: S_0 alone.
    mbar_wait(k_full(0), 0);
    named_sync(1 + w, 256);
    wg_fence();
    issue_qk<D, BK, QR>(s_acc, qf, q_w, BQ, k_s);
    wg_commit();
    named_arrive(next, 256);
    wg_wait<0>();
    fence_regs(s_acc);
    if (lane == 0) mbar_arrive(k_empty(0));
    if (0 >= n_unmasked)
      mask_tile<BK>(s_acc, 0, row0, Sk, offset, causal, t4);
    softmax_step<BK>(s_acc, scale_log2, m0, m1, rs0, rs1, a0, a1);
    l0 = rs0;
    l1 = rs1;
    to_bf16_frags<BK>(s_acc, p);

    // Tile t: S_t and P_{t-1} V_{t-1} in flight together; S_t's softmax
    // runs while the second product is still on the tensor cores.  O is
    // rescaled by tile t-1's factor while S_t runs: O P_{t-1} V_{t-1} is
    // then in tile t-1's base, (O a_{t-1} + P_{t-1} V_{t-1}).
    for (int t = 1; t < n_tiles; ++t) {
      const int s = t % ST, sp = (t - 1) % ST;
      mbar_wait(k_full(s), (t / ST) & 1);
      named_sync(1 + w, 256);
      fence_regs(s_acc);
      fence_regs(p);
      wg_fence();
      issue_qk<D, BK, QR>(s_acc, qf, q_w, BQ, k_s + s * KV_BYTES);
      wg_commit();
      rescale_o<D>(o_acc, a0, a1);
      mbar_wait(v_full(sp), ((t - 1) / ST) & 1);
      fence_regs(o_acc);
      wg_fence();
      issue_pv<D, BK>(o_acc, p, v_s + sp * KV_BYTES);
      wg_commit();
      named_arrive(next, 256);
      wg_wait<1>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(k_empty(s));
      if (t >= n_unmasked)
        mask_tile<BK>(s_acc, t * BK, row0, Sk, offset, causal, t4);
      softmax_step<BK>(s_acc, scale_log2, m0, m1, rs0, rs1, a0, a1);
      l0 = fmaf(l0, a0, rs0);
      l1 = fmaf(l1, a1, rs1);
      wg_wait<0>();
      fence_regs(o_acc);
      if (lane == 0) mbar_arrive(v_empty(sp));
      to_bf16_frags<BK>(s_acc, p);
    }
    // The last tile's P V.
    const int sl = (n_tiles - 1) % ST;
    mbar_wait(v_full(sl), ((n_tiles - 1) / ST) & 1);
    named_sync(1 + w, 256);
    rescale_o<D>(o_acc, a0, a1);
    fence_regs(o_acc);
    fence_regs(p);
    wg_fence();
    issue_pv<D, BK>(o_acc, p, v_s + sl * KV_BYTES);
    wg_commit();
    if (pass_last) named_arrive(next, 256);
    wg_wait<0>();
    fence_regs(o_acc);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const int row1 = row0 + 8;
    __nv_bfloat16* o_base = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = 8 * j + 2 * t4;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(o_base + (long long)row0 * os.s + d) =
            pack_bf16(__fdiv_rn(o_acc[4 * j], d0),
                      __fdiv_rn(o_acc[4 * j + 1], d0));
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(o_base + (long long)row1 * os.s + d) =
            pack_bf16(__fdiv_rn(o_acc[4 * j + 2], d1),
                      __fdiv_rn(o_acc[4 * j + 3], d1));
    }
  }
}

// --------------------------------------------------------- host: bf16 path
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map (D, H, S, B) over the model layout's byte strides, boxes
// of 64 columns x 1 head x `rows` rows, 128-byte swizzle; out-of-range
// rows read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
                const Strides& st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

bool rows_aligned(const Strides& st) {
  return st.b % 8 == 0 && st.s % 8 == 0 && st.h % 8 == 0;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int HQ, int HK, int Sq, int Sk, Strides qs, Strides ks,
                 Strides vs, Strides os, float scale, int causal,
                 cudaStream_t stream) {
  using T = Tiles<D>;
  constexpr int BQ = 64 * T::NC, CB = D / 64;
  constexpr int SMEM = CB * 128 * (BQ + 2 * T::ST * T::BK) + 1024;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, HQ, Sq, B, qs, BQ) ||
      !encode_map(&tk, k, D, HK, Sk, B, ks, T::BK) ||
      !encode_map(&tv, v, D, HK, Sk, B, vs, T::BK))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(B * HQ, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, 128 * (T::NC + 1), SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), HQ, HQ / HK, Sq, Sk, os,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
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
// as arguments; returns cudaGetLastError() after the launch.  bfloat16
// runs at D = 64 and 128 only and needs 16-byte aligned bases and strides
// (TMA's condition); float32 at D = 16, 32, 64 and 128.
extern "C" int flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16, int B,
    int HQ, int HK, int Sq, int Sk, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || HQ <= 0 || Sq <= 0) return 0;  // nothing to compute
  if (Sk <= 0 || HK <= 0 || HQ % HK) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
          rows_aligned(qs) && rows_aligned(ks) && rows_aligned(vs) &&
          rows_aligned(os)))
      return (int)cudaErrorMisalignedAddress;
    switch (D) {
      case 64: return launch_wgmma<64>(q, k, v, o, B, HQ, HK, Sq, Sk, qs, ks,
                                       vs, os, scale, causal, st);
      case 128: return launch_wgmma<128>(q, k, v, o, B, HQ, HK, Sq, Sk, qs,
                                         ks, vs, os, scale, causal, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return dispatch(q, k, v, o, B, HQ, HK, Sq, Sk, D, qs, ks, vs, os, scale,
                  causal, st);
}
