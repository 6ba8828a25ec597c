"""Planted faults against K7's check at a prefill layer's shape.

Builds the flash attention kernel (K7) as it is and with each of a few
planted faults, runs each at one prefill layer's shape (bf16, causal, the
inputs ``chip_smoke.py`` uses) and prints how far each lies from the plain
version, beside the limits of ``chip_smoke.k7_compare``.  Exits 1 unless
the sound kernel passes that check and every planted fault fails it.
Shapes: d128 (the default) is granite-8b's layer, (B, S, H, D) = (1,
32768, 32, 128) with 8 kv heads; d64 the Qwen prefill's, (1, 32768, 16,
64).  The faults, in the bf16 kernel ``flash_fwd_wgmma``, touch the last
query tile only (its rows see the most keys, so each key there weighs
least), the hardest place for a check to see them: the key tile of 128
before the diagonal dropped; a stale K/V stage (the producer skips that
tile's TMA copies, so the consumers read the ring stage's older tile);
the normaliser 2 % high; and, at D = 128, where Q sits in registers for
S = Q K^T, the last 16 columns of each Q row read into registers from
the 16 before them (a fragment address off by one k-step).  The faulty
sources are written and built under ``build/k7_faults/`` (git-ignored).

  python3 scripts/torch_k7_fault_check.py [--shape d128|d64]
      (on a CUDA card, with nvcc)
"""

from __future__ import annotations

import argparse
import ctypes
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

# name: ((B, S, HQ, D), HK or None for HQ)
SHAPES = {"d128": ((1, cs.PREFILL_SEQ, 32, 128), 8),
          "d64": ((1, cs.PREFILL_SEQ, 16, 64), None)}
LAST = "blockIdx.y == 0"  # the last query tile (heaviest first)
MASK = ("        mask_tile<BK>(s_acc, t * BK, row0, Sk, offset, causal, t4);"
        "\n")
NORM = "    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);\n"


def _skip_load(x: str) -> tuple:
    """The producer's TMA copy of one K (x = "k") or V ("v") tile, and the
    same with the copy skipped for the last query tile's second-to-last
    key tile: its full barrier completes with no bytes, so the consumers
    read whatever the ring's stage held."""
    load = (f"        mbar_expect_tx({x}_full(s), KV_BYTES);\n"
            f"        for (int c = 0; c < CB; ++c)\n"
            f"          tma_load_4d({x}_s + s * KV_BYTES + c * BK * 128, "
            f"&tm_{x}, {x}_full(s),\n"
            f"                      64 * c, hk, t * BK, b);\n")
    return load, (f"        if ({LAST} && t == n_tiles - 2) {{\n"
                  f"          mbar_arrive({x}_full(s));\n"
                  f"        }} else {{\n{load}        }}\n")


# name: [(text in flash_attn.cu, its replacement), ...]
FAULTS = {
    "drop the key tile before the diagonal": [(
        MASK, MASK + f"      if ({LAST} && t == n_unmasked - 1) {{\n"
        "#pragma unroll\n"
        "        for (int e = 0; e < BK / 2; ++e) s_acc[e] = -INFINITY;\n"
        "      }\n")],
    "stale K/V stage (the producer skips one tile's TMA)": [
        _skip_load("k"), _skip_load("v")],
    "normaliser 2 % high": [(
        NORM, NORM.replace("const float d0", "float d0")
        + f"    if ({LAST}) {{ d0 *= 1.02f; d1 *= 1.02f; }}\n")],
}
# Only where Q sits in registers (Tiles<128>::QR).
QCOL = "      const int col = 16 * kk + 2 * t4 + (r >> 1) * 8;\n"
QREG_FAULTS = {
    "Q's last 16 columns read from the 16 before them": [(
        QCOL, QCOL.replace("16 * kk", f"16 * (kk - ({LAST} && kk == D / 16 "
                                      f"- 1))"))],
}


def build_faults(faults):
    """Write and build every faulty source, all nvcc runs at once;
    returns {name: the library's flash_attn_fwd}."""
    src = (_build.KERNELS_DIR / "flash_attn" / "csrc" / "flash_attn.cu"
           ).read_text()
    out = _build.BUILD_DIR.parent / "k7_faults"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(faults.items()):
        faulty = src
        for old, new in edits:
            if faulty.count(old) != 1:
                raise RuntimeError(f"fault {name!r}: its target text is not "
                                   f"in flash_attn.cu exactly once")
            faulty = faulty.replace(old, new)
        cu, so = out / f"fault{i}.cu", out / f"libfault{i}.so"
        cu.write_text(faulty)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for fault {name!r}:\n{log}")
        fns[name] = ctypes.CDLL(str(so)).flash_attn_fwd
    return fns


def run(shape, hk, fn=None) -> dict:
    """K7 (or, with ``fn``, a faulty build's entry point put in its place)
    against the plain version at ``shape``."""
    device = torch.device("cuda:0")
    q, k, v = cs.k7_path_inputs(device, shape, hk)
    real = _build.entry

    def entry(name, fname, argtypes):
        if fn is None or name != "flash_attn":
            return real(name, fname, argtypes)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    with mock.patch.object(_build, "entry", entry):
        kern = ops.flash_attention(q, k, v, causal=True)
    plain = ref.flash_attention_plain(q, k, v, causal=True)
    return cs.k7_compare(kern, plain)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=SHAPES, default="d128")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k7_fault_check: no CUDA device", file=sys.stderr)
        return 1
    shape, hk = SHAPES[args.shape]
    faults = {**FAULTS, **(QREG_FAULTS if shape[3] == 128 else {})}
    print(f"K7 at {shape} kv heads {hk or shape[2]} bf16 causal against "
          f"its plain version; limits: atol_needed <= "
          f"{cs.K7_BF16_ATOL:g} at rtol {cs.K7_BF16_RTOL:g}, max_row_rel <= "
          f"{cs.K7_ROW_REL:g}", flush=True)
    results = {"sound": run(shape, hk)}
    for name, fn in build_faults(faults).items():
        results[name] = run(shape, hk, fn)
    bad = []
    for name, c in results.items():
        want = name == "sound"
        print(f"{name}: {cs.fmt_k7(c)} -> "
              f"{'passes' if c['ok'] else 'fails'}", flush=True)
        if c["ok"] != want:
            bad.append(name)
    if bad:
        print(f"the check misjudged: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
