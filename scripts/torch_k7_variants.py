"""Variants of the flash attention kernel, timed side by side.

Writes ``flash_attn.cu`` once per variant with a few text edits (the
variants below), builds them all at once under ``build/k7_variants/``
(git-ignored), holds each against the plain version at one prefill
layer's shape (bf16, causal, the inputs of ``chip_smoke.py``) with
``chip_smoke.k7_compare``'s limits, and times each with CUDA events in
rounds that visit the variants forwards and then backwards, beside
``scaled_dot_product_attention`` on the same tensors (``enable_gqa`` where
the kv heads are fewer).  Prints the card, each variant's ptxas registers,
median ms, bound share and the rate at which its K/V tiles leave L2 (the
bytes of every K and V tile copy into shared memory over its ms).  Exits
1 if a checked variant fails its check.

  python3 scripts/torch_k7_variants.py [--shape d64|d128] [--clocks]
      [NAME ...]      (default: d64, every variant of that shape)

With ``--clocks``, each variant (and SDPA) then runs back to back for 3 s
while ``nvidia-smi`` samples the SM clock and the power draw every 100
ms; their medians are printed.

Shapes: d64 is the Qwen prefill's layer, (B, S, H, D) = (1, 32768, 16,
64); d128 granite-8b's, (1, 32768, 32, 128) with 8 kv heads.

The variants, each a design choice of ``flash_fwd_wgmma`` undone or
pushed further:
  loads only         the producer and the full/empty barriers as built,
                     the consumers issue no product and no softmax: the
                     time the K/V ring alone needs (timed, not checked);
  products only      the products as built, no softmax (P is the scores
                     rounded to bf16; timed, not checked);
  softmax only       the softmax as built, no product (timed, not
                     checked);
  tree softmax       the row maxima and sums as trees (the arrays went to
                     the stack: 3x slower);
  lazy rescale       O left alone where no row of the warp has a new
                     maximum (a warp vote a tile);
  no turn-taking     the consumers issue their products without waiting
                     for their turn on the named barriers;
  poly 2/16, 4/16    2 (4) of a tile's 16 chunks of 8 keys take their
                     exponentials from a degree-3 polynomial on the FMA
                     pipe (relative error 7.5e-5) instead of ex2;
  2 stages           (d64) a K/V ring of 2 stages (3 as built);
  2 consumers        (d64) two consumer warpgroups (128 query rows a
                     block, 240 registers each) instead of three;
  Q in shared memory (d128) S = Q K^T reads Q from shared memory at every
                     k-step, the kernel before Q moved into registers;
                     with "loads only" and "3 stages" the same changes to
                     it;
  3 stages           (d128) a K/V ring of 3 stages (2 as built; 225 KB
                     of shared memory);
  BK 64              (d128) K/V tiles of 64 keys (128 as built), Q in
                     shared memory (the register form is n128 only);
  cluster            (d128) thread-block clusters of 2 consecutive query
                     heads of one kv head (the GQA group divides by 2):
                     each CTA's producer copies half of every K/V tile and
                     multicasts it into both CTAs' stages (L2 serves each
                     tile once a cluster), each consumer warp releases a
                     stage to both CTAs' empty barriers, cluster barriers
                     after the set-up and before the exit; with "loads
                     only", "Q in shared memory" and "3 stages" the same
                     changes to it; "cluster 4" clusters of 4 heads;
                     "cluster, cluster-scope arrive" each remote release
                     as mbarrier.arrive.release.cluster (a fence at
                     cluster scope on every arrive).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple, Optional
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import ops, ref  # noqa: E402

# name: ((B, S, HQ, D), HK or None for HQ)
SHAPES = {"d64": ((1, cs.PREFILL_SEQ, 16, 64), None),
          "d128": ((1, cs.PREFILL_SEQ, 32, 128), 8)}
EX2 = ("__device__ __forceinline__ float ex2(float x) {\n  float y;\n"
       "  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));\n"
       "  return y;\n}\n")
# 2^x = 2^j 2^f, j = round(x) by the 1.5 x 2^23 trick, 2^f a degree-3
# fit on [-0.5, 0.5], 2^j added to the exponent field; 0 below 2^-126.
POLY = """
__device__ __forceinline__ float exp2_poly(float x) {
  const float xc = fmaxf(x, -126.f);
  const float t = xc + 12582912.f;
  const float f = xc - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05517166f, f, 0.24261113f), f,
                            0.69326097f), f, 0.99992806f);
  const float r =
      __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
  return x < -126.f ? 0.f : r;
}
"""
EXPS = ("    s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));\n"
        "    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));\n"
        "    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));\n"
        "    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));\n")


def _poly(n: int) -> list:
    mixed = "".join(
        f"{line.split(' = ')[0]} = j < {n} ? exp2_poly({arg}) : ex2({arg});\n"
        for line in EXPS.splitlines()
        for arg in [line.split("= ex2(", 1)[1][:-2]])
    return [(EX2, EX2 + POLY), (EXPS, mixed)]


# The consumers' products, and their softmax, masks, bf16 rounding and
# rescale, each of which a diagnostic variant takes out; the waits,
# arrivals, turns and stores stay.
PRODUCTS = [
    ("    wgmma_ss<BK>(s, desc_sw128(q_base + col * rows_q * 128 + off, 1, "
     "64),\n                 desc_sw128(k_base + col * BK * 128 + off, 1, "
     "64), kk > 0);\n", "    (void)col; (void)off;\n"),
    ("    wgmma_rs<D>(o, p[kk], desc_sw128(v_base + kk * 16 * 128, BK * 128 "
     "/ 16,\n                                     64), 1);\n",
     "    (void)v_base;\n"),
    ("    wgmma_rk128(s, qf[kk], desc_sw128(k_base + col * BK * 128 + off, 1, "
     "64),\n                kk > 0);\n", "    (void)col; (void)off;\n"),
]
SOFTMAX = [
    ("  float mx0 = m0, mx1 = m1;\n",
     "  rs0 = rs1 = 0.f;\n  a0 = a1 = 1.f;\n  return;\n"
     "  float mx0 = m0, mx1 = m1;\n"),
    ("                                          int causal, int t4) {\n",
     "                                          int causal, int t4) {\n"
     "  return;\n"),
    ("                                          float a1) {\n",
     "                                          float a1) {\n  return;\n"),
]
# P as the scores rounded to bf16, skipped too where no product reads it.
ROUND = [
    ("                                              uint32_t (&p)[BK / 16]"
     "[4]) {\n",
     "                                              uint32_t (&p)[BK / 16]"
     "[4]) {\n  return;\n"),
]
# The row maxima and sums as trees of independent pairs instead of one
# chain a row (the maxima are the same; the sums round in another order).
TREE = [
    ("""  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
""", """  float t0[BK / 8], t1[BK / 8];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    t0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
    t1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
  }
#pragma unroll
  for (int w = BK / 16; w > 0; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
      t0[j] = fmaxf(t0[j], t0[j + w]);
      t1[j] = fmaxf(t1[j], t1[j + w]);
    }
  }
  float mx0 = fmaxf(m0, t0[0]), mx1 = fmaxf(m1, t1[0]);
"""),
    ("""    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
}
""", """  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    t0[j] = s[4 * j] + s[4 * j + 1];
    t1[j] = s[4 * j + 2] + s[4 * j + 3];
  }
#pragma unroll
  for (int w = BK / 16; w > 0; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
      t0[j] += t0[j + w];
      t1[j] += t1[j + w];
    }
  }
  rs0 = t0[0];
  rs1 = t1[0];
}
"""),
]
# O left as it is where no row of the warp has a new maximum (a = 1).
LAZY = [("                                          float a1) {\n",
         "                                          float a1) {\n"
         "  if (__all_sync(0xffffffffu, a0 == 1.f && a1 == 1.f)) return;\n")]
# The thread-block cluster at D = 128: kCluster consecutive query heads of
# one kv head a cluster (grid x), each CTA's producer multicasting 1/C of
# every K/V tile into the stage of every CTA, each consumer warp releasing
# a stage to every CTA's empty barrier, cluster barriers after the set-up
# and before the exit.  Text edits of flash_attn.cu, in order.
CLUSTER_HELPERS = r'''// CTAs a thread-block cluster at D = 128.
constexpr int kCluster = 2;

// The same box read from L2 once and written into the shared memory of
// every CTA of the cluster in `mask`, at the same offset `dst`; each
// CTA's barrier at offset `bar` receives the box's bytes.
__device__ __forceinline__ void tma_load_4d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint32_t bar, int c0, int c1,
                                               int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "h"(mask), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Arrive on the mbarrier at offset `bar` of the cluster's CTA `rank`
// (release at CTA scope, after the wgmma reads of the stage completed).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

'''
CLUSTER_LOADS = r'''// One K or V tile (BK keys x D) into ring stage `dst`, in CB column blocks
// of 64.  C = 1: this CTA copies the whole tile.  C > 1: the tile is cut
// into NB = max(CB, C) boxes of BK CB / NB rows, and cluster rank r copies
// boxes [r NB / C, (r + 1) NB / C), each multicast into every CTA.
template <int D, int BK, int C>
__device__ __forceinline__ void load_kv(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int hk, int key0, int b,
                                        uint32_t rank) {
  constexpr int CB = D / 64, NB = C > CB ? C : CB, ROWS = BK * CB / NB;
  constexpr int PER_COL = NB / CB;  // boxes a column block
#pragma unroll
  for (int j = 0; j < NB / C; ++j) {
    const int i = rank * (NB / C) + j;
    const int c = i / PER_COL, r0 = (i % PER_COL) * ROWS;
    const uint32_t at = dst + c * BK * 128 + r0 * 128;
    if constexpr (C == 1)
      tma_load_4d(at, map, bar, 64 * c, hk, key0 + r0, b);
    else
      tma_load_4d_mc(at, map, bar, 64 * c, hk, key0 + r0, b,
                     (uint16_t)((1u << C) - 1));
  }
}

// A consumer warp's release of a ring stage: to its own CTA's empty
// barrier (C = 1), or to that of every CTA of the cluster (lane r arrives
// at rank r's).
template <int C>
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if constexpr (C == 1) {
    if (lane == 0) mbar_arrive(bar);
  } else {
    if (lane < C) mbar_arrive_cluster(bar, lane);
  }
}

'''
DESC = "// A wgmma shared-memory descriptor for a 128-byte-swizzled operand"
KERNEL = ("template <int D>\n__global__ void __launch_bounds__(128 * "
          "(Tiles<D>::NC + 1), 1)")
UNMASKED = ("  const int n_unmasked = (causal ? min(Sk, q0 + offset + 1) : Sk) / "
            "BK;\n")
INIT = '''      mbar_init(k_empty(s), NC * 4);  // one arrival per consumer warp
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
'''
PRODUCER = """        for (int c = 0; c < CB; ++c)
          tma_load_4d(k_s + s * KV_BYTES + c * BK * 128, &tm_k, k_full(s),
                      64 * c, hk, t * BK, b);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int c = 0; c < CB; ++c)
          tma_load_4d(v_s + s * KV_BYTES + c * BK * 128, &tm_v, v_full(s),
                      64 * c, hk, t * BK, b);
      }
    }
"""
LAST_PV = "    // The last tile's P V.\n"
STORED = """                      __fdiv_rn(o_acc[4 * j + 3], d1));
    }
"""
LAUNCH = """  const dim3 grid(B * HQ, (Sq + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, 128 * (T::NC + 1), SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), HQ, HQ / HK, Sq, Sk, os,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
"""
CLUSTER = [
    (DESC, CLUSTER_HELPERS + DESC),
    (KERNEL, CLUSTER_LOADS + KERNEL),
    (UNMASKED, UNMASKED + "  constexpr int C = D == 128 ? kCluster : 1;\n"
     "  const uint32_t rank = C > 1 ? cluster_rank() : 0;\n"),
    (INIT, INIT.replace("NC * 4)", "NC * 4 * C)").replace(
        "  __syncthreads();\n", "  if constexpr (C == 1) {\n"
        "    __syncthreads();\n  } else {\n    cluster_arrive();\n"
        "    cluster_wait();\n  }\n")),
    (PRODUCER, """        load_kv<D, BK, C>(k_s + s * KV_BYTES, &tm_k, k_full(s), hk, t * BK,
                          b, rank);
        mbar_wait(v_empty(s), ph ^ 1);
        mbar_expect_tx(v_full(s), KV_BYTES);
        load_kv<D, BK, C>(v_s + s * KV_BYTES, &tm_v, v_full(s), hk, t * BK,
                          b, rank);
      }
    }
    if constexpr (C > 1) {
      cluster_arrive();
      cluster_wait();
    }
"""),
    *[(f"if (lane == 0) mbar_arrive({x});", f"release<C>({x}, lane);")
      for x in ("k_empty(0)", "k_empty(s)", "v_empty(sp)")],
    (LAST_PV, "    if constexpr (C > 1) cluster_arrive();\n" + LAST_PV),
    (STORED, STORED + "    if constexpr (C > 1) cluster_wait();\n"),
    ("      !encode_map(&tk, k, D, HK, Sk, B, ks, T::BK) ||\n"
     "      !encode_map(&tv, v, D, HK, Sk, B, vs, T::BK))\n",
     "      !encode_map(&tk, k, D, HK, Sk, B, ks, KV_ROWS) ||\n"
     "      !encode_map(&tv, v, D, HK, Sk, B, vs, KV_ROWS))\n"),
    ("  constexpr int SMEM = CB * 128 * (BQ + 2 * T::ST * T::BK) + 1024;\n",
     "  constexpr int SMEM = CB * 128 * (BQ + 2 * T::ST * T::BK) + 1024;\n"
     "  constexpr int C = D == 128 ? kCluster : 1;\n"
     "  constexpr int NB = C > CB ? C : CB, KV_ROWS = T::BK * CB / NB;\n"
     "  if ((HQ / HK) % C) return (int)cudaErrorInvalidValue;\n"),
    (LAUNCH, """  const dim3 grid(B * HQ, (Sq + BQ - 1) / BQ);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  int group = HQ / HK;
  float scale_log2 = scale * 1.4426950408889634f;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(128 * (T::NC + 1));
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&tq, &tk, &tv, &out, &HQ, &group, &Sq, &Sk, &os,
                  &scale_log2, &causal};
  const cudaError_t err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(flash_fwd_wgmma<D>), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
"""),
]


T64 = ("  static constexpr int NC = 3, BK = 128, ST = 3, REG_LOAD = 32, "
       "REG_MMA = 160;")
T128 = ("  static constexpr int NC = 2, BK = 128, ST = 2, REG_LOAD = 24, "
        "REG_MMA = 240;")
# S = Q K^T over a key tile of 64: wgmma m64n64k16, both operands from
# shared memory (the built kernel has only the n128 form).
SS64 = ("template <> __device__ __forceinline__ void wgmma_ss<64>(\n"
        "    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {\n"
        "  asm volatile(\n"
        "      \"{\\n.reg .pred p;\\nsetp.ne.b32 p, %34, 0;\\n\"\n"
        "      \"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {\"\n"
        + "".join(f"      \"{', '.join(f'%{8 * r + i}' for i in range(8))}"
                  f"{',' if r < 3 else ''}\"\n" for r in range(4))
        + "      \"}, %32, %33, p, 1, 1, 0, 0;\\n}\\n\"\n"
        "      : " + ", ".join(f"\"+f\"(d[{i}])" for i in range(32)) + "\n"
        "      : \"l\"(da), \"l\"(db), \"r\"(scale_d));\n}\n")
RS64 = "template <> __device__ __forceinline__ void wgmma_rs<64>(\n"
ST3 = (T128, T128.replace("ST = 2", "ST = 3"))
QSMEM = ("  static constexpr bool QR = true;",
         "  static constexpr bool QR = false;")
LOADS = PRODUCTS + SOFTMAX + ROUND


class Variant(NamedTuple):
    shape: str               # "d64", "d128" or "any"
    edits: list              # [(text in flash_attn.cu, its replacement)]
    checked: bool = True     # held against the plain version
    bk: Optional[int] = None      # keys a K/V tile, if not as built
    cluster: int = 1         # CTAs a thread-block cluster (K/V from L2
    #                          once a cluster)


TURNS = [('  asm volatile("bar.sync %0, %1;\\n" :: "r"(id), "r"(n) : '
          '"memory");\n', ""),
         ('  asm volatile("bar.arrive %0, %1;\\n" :: "r"(id), "r"(n) : '
          '"memory");\n', "")]
VARIANTS = {
    "as built": Variant("any", []),
    "loads only": Variant("any", LOADS, checked=False),
    "products only": Variant("any", SOFTMAX, checked=False),
    "softmax only": Variant("any", PRODUCTS, checked=False),
    "tree softmax": Variant("any", TREE),
    "lazy rescale": Variant("any", LAZY),
    "no turn-taking": Variant("any", TURNS),
    "poly 2/16": Variant("any", _poly(2)),
    "poly 4/16": Variant("any", _poly(4)),
    "2 stages": Variant("d64", [(T64, T64.replace("ST = 3", "ST = 2"))]),
    "2 consumers": Variant("d64", [(T64, T64.replace("NC = 3", "NC = 2")
                                    .replace("REG_LOAD = 32", "REG_LOAD = 24")
                                    .replace("REG_MMA = 160",
                                             "REG_MMA = 240"))]),
    "Q in shared memory": Variant("d128", [QSMEM]),
    "Q in shared memory, loads only": Variant("d128", [QSMEM] + LOADS,
                                              checked=False),
    "Q in shared memory, 3 stages": Variant("d128", [QSMEM, ST3]),
    "3 stages": Variant("d128", [ST3]),
    "BK 64": Variant("d128", [(T128, T128.replace("BK = 128", "BK = 64")),
                              QSMEM, (RS64, SS64 + RS64)], bk=64),
    "cluster": Variant("d128", CLUSTER, cluster=2),
    "cluster, loads only": Variant("d128", CLUSTER + LOADS, checked=False,
                                   cluster=2),
    "cluster, Q in shared memory": Variant("d128", CLUSTER + [QSMEM],
                                           cluster=2),
    "cluster 3 stages": Variant("d128", CLUSTER + [ST3], cluster=2),
    "cluster 4": Variant("d128", CLUSTER + [(
        "constexpr int kCluster = 2;", "constexpr int kCluster = 4;")],
        cluster=4),
    "cluster, cluster-scope arrive": Variant("d128", CLUSTER + [(
        "mbarrier.arrive.shared::cluster.b64",
        "mbarrier.arrive.release.cluster.shared::cluster.b64")], cluster=2),
}


def build(names):
    """Write and build every named variant at once; {name: its
    flash_attn_fwd}."""
    src = (_build.KERNELS_DIR / "flash_attn" / "csrc" / "flash_attn.cu"
           ).read_text()
    out = _build.BUILD_DIR.parent / "k7_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name].edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its target text is "
                                   f"not in flash_attn.cu exactly once")
            text = text.replace(old, new)
        cu, so = out / f"variant{i}.cu", out / f"libvariant{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln or "spill" in ln]
        notes = [ln.split("(C", 1)[1].split(")")[0] for ln in log.splitlines()
                 if "(C7" in ln]
        print(f"{name}: ptxas {regs[:8]} notes {notes}", flush=True)
        fns[name] = ctypes.CDLL(str(so)).flash_attn_fwd
    return fns


def call_with(fn, q, k, v):
    """ops.flash_attention with ``fn`` as its entry point."""
    real = _build.entry

    def entry(name, fname, argtypes):
        if name != "flash_attn":
            return real(name, fname, argtypes)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    with mock.patch.object(_build, "entry", entry):
        return ops.flash_attention(q, k, v, causal=True)


def kv_bytes(shape, bk) -> int:
    """Bytes of every K and V tile the kernel writes into shared memory
    at ``shape`` (causal, S_q = S_k): each visited key tile into each
    block; L2 serves them once a cluster."""
    b, s, hq, d = shape
    bq = ops.BF16_TILES[d][0]
    tiles = sum(n for n, _ in ops.tile_schedule(s, s, bq, bk, True))
    return b * hq * tiles * 2 * bk * d * 2


def clocks_during(fn, device, seconds=3.0) -> tuple:
    """(median SM MHz, median W, samples) while ``fn`` runs back to back
    for ``seconds``; the first 0.5 s of samples are dropped."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(4):
                fn()
            torch.cuda.synchronize(device)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = []
    for line in out.splitlines()[5:]:
        try:
            rows.append(tuple(float(x) for x in line.split(",")))
        except ValueError:
            continue
    if not rows:
        return float("nan"), float("nan"), 0
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows), len(rows))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=SHAPES, default="d64")
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k7_variants: no CUDA device", file=sys.stderr)
        return 1
    names = args.names or [n for n, var in VARIANTS.items()
                           if var.shape in ("any", args.shape)]
    unknown = [n for n in names if n not in VARIANTS
               or VARIANTS[n].shape not in ("any", args.shape)]
    if unknown:
        print(f"unknown variants at {args.shape}: {unknown}; have "
              f"{list(VARIANTS)}", file=sys.stderr)
        return 2
    shape, hk = SHAPES[args.shape]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; shape {shape} kv heads {hk or shape[2]}",
          flush=True)
    device = torch.device("cuda:0")
    fns = build(names)
    q, k, v = cs.k7_path_inputs(device, shape, hk)
    plain = ref.flash_attention_plain(q, k, v, causal=True)
    bad = []
    for name, fn in fns.items():
        out = call_with(fn, q, k, v)
        torch.cuda.synchronize(device)
        if not VARIANTS[name].checked:
            print(f"{name}: ran (timed, not checked)", flush=True)
            continue
        c = cs.k7_compare(out, plain)
        print(f"{name}: {cs.fmt_k7(c)} -> "
              f"{'passes' if c['ok'] else 'fails'}", flush=True)
        if not c["ok"]:
            bad.append(name)
    del plain
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = {"enable_gqa": True} if hk else {}
    runs = {**{n: (lambda fn=fn: call_with(fn, q, k, v))
               for n, fn in fns.items()},
            "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, **gqa)}
    times = {n: [] for n in runs}
    order = list(runs)
    for r in range(8):
        for n in (order if r % 2 == 0 else order[::-1]):
            times[n].append(cs.time_ms(runs[n], device, reps=5, warmup=2,
                                       inner=4))
    bnd, _ = cs.k7_bound(*shape, 2, hk)
    for n, ts in times.items():
        med = statistics.median(ts)
        line = (f"{n}: ms_median={med:.4f} (of {[round(t, 4) for t in ts]})"
                f" bound_share={bnd / med:.3f}")
        if n in VARIANTS:
            var = VARIANTS[n]
            by = kv_bytes(shape, var.bk or ops.BF16_TILES[shape[3]][1])
            c = var.cluster
            line += (f" cluster={c} smem_fill={by / 1e9:.2f}e9 B at "
                     f"{by / med / 1e9:.3f} TB/s, from L2 {by / c / 1e9:.2f}e9"
                     f" B at {by / c / med / 1e9:.3f} TB/s")
        print(line, flush=True)
    if args.clocks:
        for n, fn in runs.items():
            mhz, watts, samples = clocks_during(fn, device)
            print(f"{n}: sm_clock_MHz_median={mhz:.0f} power_W_median="
                  f"{watts:.1f} ({samples} samples)", flush=True)
    print(card, flush=True)
    if bad:
        print(f"variants that fail the check: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
