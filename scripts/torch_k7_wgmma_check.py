"""The flash attention kernel's Hopper building blocks, one tile at a time.

Builds a small test kernel that includes ``flash_attn.cu`` and uses its
own pieces, as ``flash_fwd_wgmma`` uses them: the 4-D TMA maps with the
128-byte swizzle (``encode_map``), one Q tile of 64 rows and one K and V
tile of 128 keys loaded by TMA onto one mbarrier, S = Q K^T by
``issue_s`` (wgmma, both operands K-major from shared memory), S rounded
to bf16 register fragments (``to_bf16_frags``) and O = P V by ``issue_pv``
(wgmma, P from registers, V MN-major from shared memory); at D = 128 also
S by ``issue_s_rq``, Q's A fragments read from the swizzled tile into
registers (``load_q_frags``), the form the kernel runs at D = 128.  It
writes S (both forms) and O in float32 and holds them against torch
products of the same bf16 values, at D = 64 and 128, on contiguous inputs
and on strided views of one fused (B, S, 3, H, D) tensor at a non-zero
head and batch.  Exits 1 on any difference above float32 rounding.  The test kernel is written
and built under ``build/k7_wgmma_check/`` (git-ignored).

  python3 scripts/torch_k7_wgmma_check.py      (on a CUDA card, with nvcc)
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

BK = 128
CHECK_CU = r"""
#include "%(src)s"

namespace {
template <int D>
__global__ void __launch_bounds__(128) tile_check(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, int h, int hk, int b,
    float* s_out, float* o_out, float* s2_out) {
  constexpr int BK = 128, CB = D / 64;
  extern __shared__ uint8_t raw[];
  __shared__ __align__(8) uint64_t bar_mem;
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = q_s + CB * 64 * 128,
                 v_s = k_s + CB * BK * 128;
  const uint32_t bar = smem_u32(&bar_mem);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, CB * (64 + 2 * BK) * 128);
    for (int c = 0; c < CB; ++c) {
      tma_load_4d(q_s + c * 64 * 128, &tq, bar, 64 * c, h, 0, b);
      tma_load_4d(k_s + c * BK * 128, &tk, bar, 64 * c, hk, 0, b);
      tma_load_4d(v_s + c * BK * 128, &tv, bar, 64 * c, hk, 0, b);
    }
  }
  mbar_wait(bar, 0);
  float s[BK / 2], o[D / 2];
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  wg_fence();
  issue_s<D, BK>(s, q_s, 64, k_s);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  uint32_t p[BK / 16][4];
  to_bf16_frags<BK>(s, p);
  wg_fence();
  issue_pv<D, BK>(o, p, v_s);
  wg_commit();
  wg_wait<0>();
  fence_regs(o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x %% 32;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  for (int j = 0; j < BK / 8; ++j)
    for (int e = 0; e < 4; ++e)
      s_out[(r0 + 8 * (e >> 1)) * BK + 8 * j + c0 + (e & 1)] = s[4 * j + e];
  if constexpr (D == 128) {
    uint32_t qf[D / 16][4];
    load_q_frags<D>(qf, q_s, 64, warp, lane >> 2, lane & 3);
    wg_fence();
    issue_s_rq<D, BK>(s, qf, k_s);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    for (int j = 0; j < BK / 8; ++j)
      for (int e = 0; e < 4; ++e)
        s2_out[(r0 + 8 * (e >> 1)) * BK + 8 * j + c0 + (e & 1)] =
            s[4 * j + e];
  }
  for (int j = 0; j < D / 8; ++j)
    for (int e = 0; e < 4; ++e)
      o_out[(r0 + 8 * (e >> 1)) * D + 8 * j + c0 + (e & 1)] = o[4 * j + e];
}

template <int D>
int run(const void* q, const void* k, const void* v, int H, int HK, int B,
        int Sq, int Sk, const long long* st, int h, int hk, int b, float* s,
        float* o, float* s2, cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]};
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, D, H, Sq, B, qs, 64) ||
      !encode_map(&tk, k, D, HK, Sk, B, ks, 128) ||
      !encode_map(&tv, v, D, HK, Sk, B, vs, 128))
    return (int)cudaErrorInvalidValue;
  const int smem = (D / 64) * (64 + 2 * 128) * 128 + 1024;
  cudaFuncSetAttribute(tile_check<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tile_check<D><<<1, 128, smem, stream>>>(tq, tk, tv, h, hk, b, s, o, s2);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int k7_tile_check(const void* q, const void* k, const void* v,
                             int D, int H, int HK, int B, int Sq, int Sk,
                             const long long* strides, int h, int hk, int b,
                             float* s, float* o, float* s2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return run<64>(q, k, v, H, HK, B, Sq, Sk, strides, h, hk, b, s, o, s2,
                   st);
  if (D == 128)
    return run<128>(q, k, v, H, HK, B, Sq, Sk, strides, h, hk, b, s, o, s2,
                    st);
  return (int)cudaErrorInvalidValue;
}
"""


def build() -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "k7_wgmma_check"
    out.mkdir(parents=True, exist_ok=True)
    src = _build.KERNELS_DIR / "flash_attn" / "csrc" / "flash_attn.cu"
    cu, so = out / "tile_check.cu", out / "libtile_check.so"
    cu.write_text(CHECK_CU % {"src": src})
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.k7_tile_check
    P, I32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P] + [I32] * 6 + [P] + [I32] * 3 + [P, P, P, P]
    fn.restype = I32
    return fn


def case(fn, d, fused, device, gen) -> float:
    """One tile at head dim d; returns the worst relative difference of
    S and O against torch's products of the same bf16 values."""
    b_n, sq, sk, hq, hk = (2, 64, BK, 3, 3) if fused else (1, 64, BK, 1, 1)
    if fused:  # q, k, v: strided views of one (B, S, 3, H, D) tensor
        x = torch.randn(b_n, sk, 3, hq, d, generator=gen, device=device
                        ).to(torch.bfloat16)
        q, k, v = x[:, :sq, 0], x[:, :, 1], x[:, :, 2]
        h, hk_i, b = 2, 1, 1
    else:
        q = torch.randn(1, sq, 1, d, generator=gen, device=device
                        ).to(torch.bfloat16)
        k, v = (torch.randn(1, sk, 1, d, generator=gen, device=device
                            ).to(torch.bfloat16) for _ in range(2))
        h, hk_i, b = 0, 0, 0
    s = torch.empty(64, BK, device=device)
    o = torch.empty(64, d, device=device)
    s2 = torch.full((64, BK), float("nan"), device=device)
    strides = (ctypes.c_longlong * 9)(*[st for t in (q, k, v)
                                        for st in t.stride()[:3]])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), d, hq, hk,
                    b_n, sq, sk, strides, h, hk_i, b, s.data_ptr(),
                    o.data_ptr(), s2.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), "k7_tile_check")
    torch.cuda.synchronize()
    qf, kf, vf = (t[b, :, i].float() for t, i in ((q, h), (k, hk_i),
                                                  (v, hk_i)))
    s_ref = qf[:64] @ kf.T
    o_ref = s.to(torch.bfloat16).float() @ vf
    err_s = float((s - s_ref).abs().max() / s_ref.abs().max())
    err_o = float((o - o_ref).abs().max() / o_ref.abs().max())
    # Q from registers: the same products, summed in the same order
    err_rq = (float((s2 - s_ref).abs().max() / s_ref.abs().max())
              if d == 128 else 0.0)
    print(f"D={d} {'fused strided views' if fused else 'contiguous'}: "
          f"S rel err {err_s:.3e}, O rel err {err_o:.3e}"
          + (f", S with Q in registers rel err {err_rq:.3e}" if d == 128
             else ""), flush=True)
    return max(err_s, err_o, err_rq)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k7_wgmma_check: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    fn = build()
    worst = max(case(fn, d, fused, device, gen)
                for d in (64, 128) for fused in (False, True))
    if worst > 1e-4:  # float32 sums in another order: ~1e-6 relative
        print(f"torch_k7_wgmma_check: FAILED (worst {worst:.3e})",
              file=sys.stderr)
        return 1
    print("torch_k7_wgmma_check: S and O match", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
