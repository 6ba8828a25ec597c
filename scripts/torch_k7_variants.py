"""Variants of the flash attention kernel, timed side by side.

Writes ``flash_attn.cu`` once per variant with a few text edits (the
variants below), builds them all at once under ``build/k7_variants/``
(git-ignored), holds each against the plain version at one prefill
layer's shape ((B, S, H, D) = (1, 32768, 16, 64), bf16, causal, the
inputs of ``chip_smoke.py``) with ``chip_smoke.k7_compare``'s limits, and
times each with CUDA events in rounds that visit the variants forwards
and then backwards, beside ``scaled_dot_product_attention`` on the same
tensors.  Prints the card, each variant's ptxas registers and median ms.
Exits 1 if a variant fails its check.

  python3 scripts/torch_k7_variants.py [NAME ...]    (default: all)

The variants, each a design choice of ``flash_fwd_wgmma`` undone or
pushed further:
  no turn-taking     the consumers issue their products without waiting
                     for their turn on the named barriers;
  poly 2/16, 4/16    2 (4) of a tile's 16 chunks of 8 keys take their
                     exponentials from a degree-3 polynomial on the FMA
                     pipe (relative error 7.5e-5) instead of ex2;
  2 stages           a K/V ring of 2 stages at D = 64 (3 as built);
  2 consumers        D = 64 with two consumer warpgroups (128 query rows a
                     block, 240 registers each) instead of three.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import ops, ref  # noqa: E402

SHAPE = (1, cs.PREFILL_SEQ, 16, 64)
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


T64 = ("  static constexpr int NC = 3, BK = 128, ST = 3, REG_LOAD = 32, "
       "REG_MMA = 160;")
# name: [(text in flash_attn.cu, its replacement), ...]
VARIANTS = {
    "as built": [],
    "no turn-taking": [
        ('  asm volatile("bar.sync %0, %1;\\n" :: "r"(id), "r"(n) : '
         '"memory");\n', ""),
        ('  asm volatile("bar.arrive %0, %1;\\n" :: "r"(id), "r"(n) : '
         '"memory");\n', "")],
    "poly 2/16": _poly(2),
    "poly 4/16": _poly(4),
    "2 stages": [(T64, T64.replace("ST = 3", "ST = 2"))],
    "2 consumers": [(T64, T64.replace("NC = 3", "NC = 2").replace(
        "REG_LOAD = 32", "REG_LOAD = 24").replace("REG_MMA = 160",
                                                  "REG_MMA = 240"))],
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
        for old, new in VARIANTS[name]:
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
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        notes = [ln.split("(C", 1)[1].split(")")[0] for ln in log.splitlines()
                 if "(C7" in ln]
        print(f"{name}: ptxas {regs[:2]} notes {notes}", flush=True)
        fns[name] = ctypes.CDLL(str(so)).flash_attn_fwd
    return fns


def call_with(fn, q, k, v):
    real = _build.entry

    def entry(name, fname, argtypes):
        if name != "flash_attn":
            return real(name, fname, argtypes)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    with mock.patch.object(_build, "entry", entry):
        return ops.flash_attention(q, k, v, causal=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_k7_variants: no CUDA device", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
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
    fns = build(names)
    q, k, v = cs.k7_path_inputs(device, SHAPE)
    plain = ref.flash_attention_plain(q, k, v, causal=True)
    bad = []
    for name, fn in fns.items():
        c = cs.k7_compare(call_with(fn, q, k, v), plain)
        print(f"{name}: {cs.fmt_k7(c)} -> "
              f"{'passes' if c['ok'] else 'fails'}", flush=True)
        if not c["ok"]:
            bad.append(name)
    del plain
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    runs = {**{n: (lambda fn=fn: call_with(fn, q, k, v))
               for n, fn in fns.items()},
            "SDPA": lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)}
    times = {n: [] for n in runs}
    order = list(runs)
    for r in range(4):
        for n in (order if r % 2 == 0 else order[::-1]):
            times[n].append(cs.time_ms(runs[n], device, reps=3, warmup=1,
                                       inner=2))
    bnd, _ = cs.k7_bound(*SHAPE, 2)
    for n, ts in times.items():
        med = statistics.median(ts)
        print(f"{n}: ms_median={med:.4f} (of {[round(t, 4) for t in ts]}) "
              f"bound_share={bnd / med:.3f}", flush=True)
    print(card, flush=True)
    if bad:
        print(f"variants that fail the check: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
