#!/usr/bin/env python3
"""Variants of the table-batched embedding bag (K6), timed side by side.

Writes ``embed_bag.cu`` once per variant with a few text edits (the
variants below), builds them all at once under ``build/k6_variants/``
(git-ignored), and times them at DLRM-RM2's training lookup (its 26
tables at their published widths, 65,536 one-row bags a field, float32;
the inputs of ``scripts/torch_k6_profile.py``):

  registers, 4 rows, streaming stores (as built)
                     ``bags_kernel``: 4 (bag, field) pairs a lane, every
                     row loaded before the first add, the next ids loaded
                     under them, the sums written with st.global.cs;
  plain stores       the same with plain st.global stores;
  8 rows             8 pairs a lane;
  3 (4) blocks an SM at least
                     ``__launch_bounds__(256, 3)`` (``4``): fewer registers
                     a lane, more lanes in flight;
  bulk copies        ``bags_bulk_kernel``, added for one-row float32 bags
                     into a contiguous output: each row global -> shared
                     by one ``cp.async.bulk`` into a ring of 3 units of 128
                     rows completed on mbarriers, each unit out by one bulk
                     store, no register pass (a -0.0 row stays -0.0, where
                     the plain version's 0 + -0.0 is +0.0);
  26 launches        the single-table call per field and a ``torch.stack``,
                     the lookup's shape before the table-batched kernel
                     (T = 1 calls of the first variant).

Each is held against the plain version bit for bit at the lookup (and
the table-batched ones on ``chip_smoke.k6_small_checks``), then timed in
rounds that visit the variants forwards and then backwards: the device
time with a cold L2 (``chip_smoke.device_ms`` over the 4 id sets) and the
wrapper's time back to back (``chip_smoke.time_ms``); then each
variant's single-table call at ``chip_smoke.k6_single_cases``' six
shapes, device time with a cold L2.  Prints the card, each build's ptxas
registers and each variant's medians.  Exits 1 if a variant fails its
check.

  python3 scripts/torch_k6_variants.py [NAME ...]    (default: all)
"""

from __future__ import annotations

import contextlib
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "scripts")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embed_bag import ops, ref  # noqa: E402
from torch_k6_profile import lookup_inputs  # noqa: E402

ROWS = "constexpr int kRows = 4;"
BOUNDS = "__launch_bounds__(kThreads, 2)"
STORE = "  __stcs(reinterpret_cast<float4*>(p), v);\n"
DISPATCH = "  switch (flags) {\n"
# The bulk-copy kernel, added before the end of the anonymous namespace,
# and the entry's dispatch to it for the cases it takes.
BULK_KERNEL = r"""
// ------------------------------------------- bulk-copy variant (L = 1)
// Each row goes global -> shared with one cp.async.bulk (the TMA's 1-D
// copy, D 4 bytes) into a ring of kStages units, each completed on an
// mbarrier with its byte count; the finished unit leaves with one
// cp.async.bulk shared -> global store, with no register pass.  Float32
// tables with 16-byte rows, L = 1 and a contiguous output only.  A row
// is copied, not added to zero, so a -0.0 stays -0.0 (the plain version's
// 0 + -0.0 is +0.0).
constexpr int kBulkThreads = 128;  // one row per thread per unit
constexpr int kStages = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of `bar` has completed; trap
// after 4 s instead of hanging the card.
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

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBulkThreads)
    bags_bulk_kernel(__grid_constant__ const Tables tabs, const Args a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ Table sh[kMaxTables];
  const unsigned tid = threadIdx.x;
  const uint32_t row_bytes = (uint32_t)a.chunks * 16u;  // D 4 bytes
  const uint32_t unit_bytes = kBulkThreads * row_bytes;
  const unsigned grid = gridDim.x;
  auto unit_len = [&](unsigned u) {
    return min((unsigned)kBulkThreads, a.n_pairs - u * kBulkThreads);
  };
  for (unsigned i = tid; i < a.n_tables; i += kBulkThreads) sh[i] = tabs.t[i];
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s + 1 < kStages; ++s) {
      const unsigned u = blockIdx.x + s * grid;
      if (u < a.n_units)
        mbar_expect_tx(smem_u32(&full[s]), unit_len(u) * row_bytes);
    }
  }
  __syncthreads();
  // This thread's row of unit u: its id, then its copy into stage s.
  auto id_of = [&](unsigned u) -> int {
    const unsigned p = u * kBulkThreads + tid;
    if (u >= a.n_units || p >= a.n_pairs) return 0;
    const unsigned b = p / a.n_tables;
    return __ldg(a.idx + b * a.sb + (p - b * a.n_tables) * a.st);
  };
  auto issue = [&](unsigned u, int s, int id) {
    const unsigned p = u * kBulkThreads + tid;
    if (u >= a.n_units || p >= a.n_pairs) return;
    const Table& tb = sh[p % a.n_tables];
    bulk_load(smem_u32(ring) + s * unit_bytes + tid * row_bytes,
              static_cast<const float*>(tb.base) + (long long)id * tb.ld,
              row_bytes, smem_u32(&full[s]));
  };
  for (int s = 0; s + 1 < kStages; ++s) {
    const unsigned u = blockIdx.x + s * grid;
    issue(u, s, id_of(u));
  }
  int next_id = id_of(blockIdx.x + (kStages - 1) * grid);
  for (unsigned i = 0;; ++i) {
    const unsigned u = blockIdx.x + i * grid;
    if (u >= a.n_units) break;
    const int s = i % kStages;
    const unsigned un = u + (kStages - 1) * grid;  // refills stage (i-1)
    if (tid == 0) {
      mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);
      bulk_store(a.out + (long long)u * kBulkThreads * a.sot,
                 smem_u32(ring) + s * unit_bytes, unit_len(u) * row_bytes);
      // The store of unit i - 1 has read its stage.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      if (un < a.n_units)
        mbar_expect_tx(smem_u32(&full[(i + kStages - 1) % kStages]),
                       unit_len(un) * row_bytes);
    }
    __syncthreads();
    issue(un, (i + kStages - 1) % kStages, next_id);
    next_id = id_of(un + grid);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

cudaError_t launch_bulk(const Tables& tabs, Args a, cudaStream_t s) {
  a.chunks /= 4;  // 16-byte pieces of the row
  a.n_units = (a.n_pairs + kBulkThreads - 1) / kBulkThreads;
  const size_t smem = (size_t)kStages * kBulkThreads * a.chunks * 16;
  static int blocks = 0, smem_set = 0;
  if ((int)smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bags_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = (int)smem;
    blocks = 0;
  }
  if (blocks == 0)
    blocks = resident_blocks(bags_bulk_kernel, kBulkThreads, smem);
  const unsigned grid = min(a.n_units, (unsigned)blocks);
  bags_bulk_kernel<<<grid, kBulkThreads, smem, s>>>(tabs, a);
  return cudaSuccess;
}

"""
BULK_DISPATCH = """  if (n_len == 1 && flags == kPiece16 && sot == d &&
      sob == (long long)d * n_tables) {
    const cudaError_t err = launch_bulk(tabs, a, s);
    if (err != cudaSuccess) return (int)err;
  } else switch (flags) {
"""
# name: text edits of embed_bag.cu
VARIANTS = {
    "registers, 4 rows, streaming stores (as built)": [],
    "registers, 4 rows, plain stores": [
        (STORE, "  *reinterpret_cast<float4*>(p) = v;\n")],
    "registers, 8 rows, streaming stores": [(ROWS, ROWS.replace("4", "8"))],
    "3 blocks an SM at least": [(BOUNDS, BOUNDS.replace("2)", "3)"))],
    "4 blocks an SM at least": [(BOUNDS, BOUNDS.replace("2)", "4)"))],
    "bulk copies": [("}  // namespace\n", BULK_KERNEL + "}  // namespace\n"),
                    (DISPATCH, BULK_DISPATCH)],
}


def build(names):
    """Write and build every named variant's source at once; {name: its
    embed_bags}."""
    src = (_build.KERNELS_DIR / "embed_bag" / "csrc" / "embed_bag.cu"
           ).read_text()
    out = _build.BUILD_DIR.parent / "k6_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its target text is "
                                   f"not in embed_bag.cu exactly once")
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
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"{name}: ptxas {regs}", flush=True)
        fns[name] = ctypes.CDLL(str(so)).embed_bags
    return fns


@contextlib.contextmanager
def variant(fn):
    """``ops`` calling ``fn`` for its kernel."""
    real = _build.entry

    def entry(name, fname, argtypes):
        if name != "embed_bag":
            return real(name, fname, argtypes)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    with mock.patch.object(_build, "entry", entry):
        yield


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_k6_variants: no CUDA device", file=sys.stderr)
        return 1
    unknown = [n for n in argv if n not in VARIANTS]
    if unknown:
        print(f"unknown variants {unknown}; have {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    device = torch.device("cuda:0")
    names = argv or list(VARIANTS)
    fns = build(names)
    cfg, params, id_sets = lookup_inputs(device)
    tables = params["tables"]

    def batched(ids):
        return ops.embedding_bags(tables, ids)

    def singles(ids):
        return torch.stack([ops.embedding_bag(t, ids[:, i:i + 1])
                            for i, t in enumerate(tables)], dim=1)

    runs = {n: (fns[n], batched) for n in names}
    runs["26 launches"] = (fns[names[0]], singles)
    want = ref.embedding_bags_plain(tables, id_sets[0])
    bad = []
    for name, (fn, call) in runs.items():
        with variant(fn), torch.inference_mode():
            ok = cs.bits_equal(call(id_sets[0]), want)
            if ok and call is batched:
                try:
                    cs.k6_small_checks(device)
                except AssertionError as exc:
                    print(f"{name}: {exc}", flush=True)
                    ok = False
        print(f"{name}: {'bit for bit' if ok else 'DIFFERS'} at the lookup",
              flush=True)
        if not ok:
            bad.append(name)
    del want
    times = {n: ([], []) for n in runs}
    order = list(runs)
    for r in range(4):
        for name in (order if r % 2 == 0 else order[::-1]):
            fn, call = runs[name]
            with variant(fn), torch.inference_mode():
                calls = [lambda i=i: call(i) for i in id_sets]
                times[name][0].append(cs.device_ms(calls, device)[0])
                times[name][1].append(cs.time_ms(calls[0], device, reps=5))
    bnd, _, every_row = cs.k6_bound(id_sets[0][:, :, None], cfg.embed_dim,
                                    4)
    for name, (dev, wrap) in times.items():
        med = statistics.median(dev)
        print(f"{name}: device_ms_median={med:.4f} (cold L2, of "
              f"{[round(t, 4) for t in dev]}) wrapper_ms_median="
              f"{statistics.median(wrap):.4f} bound_ms={bnd:.4f} (every "
              f"row read anew: {every_row:.4f}) "
              f"device_of_bound={bnd / med:.3f}", flush=True)
    big = max(range(len(tables)), key=lambda i: tables[i].shape[0])
    cases = cs.k6_single_cases(device, tables[big],
                               id_sets[0][:, big:big + 1], True)
    for name in names:
        with variant(fns[name]), torch.inference_mode():
            dev = {c: cs.device_ms([lambda t=t, i=i: ops.embedding_bag(t, i)],
                                   device)[0]
                   for c, (t, i) in cases.items()}
        print(f"{name}, single table, device_ms (cold L2): "
              + "; ".join(f"{c} {ms:.4f}" for c, ms in dev.items()),
              flush=True)
    print(card, flush=True)
    if bad:
        print(f"variants that fail the check: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
