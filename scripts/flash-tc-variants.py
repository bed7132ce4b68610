#!/usr/bin/env python3
"""Build variants of the flash kernels on the tensor cores (K4/K5,
``musicstyletransfer_torch/ops/csrc/flash_attention_tc.cu``) and hold each
against the plain versions on one CUDA card; time those that are right.

    python3 scripts/flash-tc-variants.py [NAME ...]

Each variant is the source with the text substitutions of ``VARIANTS``
below, built with nvcc (all at once) into build/variants/. In a process of
its own (a variant that faults cannot stop the others), each is checked in
bfloat16 at head dimensions 16, 32, 64 and 128, at T=333 (key lengths [333,
129, 1, 0]) and at T=2048 causal ([2048, 700, 1, 0]): out and lse of K4,
dq/dk/dv of K5 (chip_smoke's tolerances); then K4 and K5 of the variants
that pass are timed at the long encoder shape (B=4, H=8, T=2047, the corpus
batch's key lengths) at head dimensions 16 and 128, the variants in turns
(first to last, then back), the card held back while the host enqueues.

The forward variants show the fault that 64-key tiles at HD=64 first met:
the forward is wrong whenever its S = Q K^T and O += P V products are one
wgmma shape (BN = HD), and right again when either is split into two
products of half the width. With names, only those variants (and "final")
run. Needs a card and nvcc.
"""

import ctypes
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from musicstyletransfer_torch.ops import _build  # noqa: E402
from musicstyletransfer_torch.ops import flash_attention as fa  # noqa: E402

OUT = os.path.join(REPO, "build", "variants")
ENC_LENS = [2047, 1867, 926, 1016]  # the corpus's first L=2046 batch

_NO_SHAPE_ASSERT = [('  static_assert(BN != HD, "the forward\'s S and P.V products must differ in shape");',
                     "")]
_FWD64_AT_64 = [("template <int HD> constexpr int kFwdTileOf = HD == 128 ? 64 : kFwdTile;",
                 "template <int HD> constexpr int kFwdTileOf = HD >= 64 ? 64 : kFwdTile;")]
# (a 128-key stage at HD=128 is 64 KB: two stages, not four)
_FWD128_AT_128 = [("template <int HD> constexpr int kFwdTileOf = HD == 128 ? 64 : kFwdTile;",
                   "template <int HD> constexpr int kFwdTileOf = kFwdTile;"),
                  ("template <int HD, int NP> constexpr int kStagesOf = NP == 1 ? kStages :",
                   "template <int HD, int NP> constexpr int kStagesOf = NP == 1 ? "
                   "(HD == 128 ? 2 : kStages) :")]
# S of a 64-key tile at HD=64 as two m64n32 products (keys 0-31, 32-63)
_S_SPLIT = [("    if (active) {\n      wgmma_fence();\n      mma_nt<HD, NP>(s, qf, ks);",
             "    if (active) {\n      wgmma_fence();\n"
             "      if constexpr (HD == 64 && BN == 64 && NP == 1) {\n"
             "        float (&sh)[2][16] = *reinterpret_cast<float(*)[2][16]>(&s[0]);\n"
             "#pragma unroll\n"
             "        for (int h = 0; h < 2; ++h)\n"
             "#pragma unroll\n"
             "          for (int kk = 0; kk < 4; ++kk)\n"
             "            wgmma_rs<0>(sh[h], qf[0][kk],\n"
             "                        make_desc<HD>(desc_lo<HD>(ks + h * 32 * 128), kk * 32), kk > 0);\n"
             "      } else {\n"
             "        mma_nt<HD, NP>(s, qf, ks);\n"
             "      }")]
# O += P V at HD=128 as two m64n64 products, one a column block of V
_PV_SPLIT = [("        wgmma_fence();\n        mma_nn<HD, BN, 1>(o, pf, vs);",
              "        wgmma_fence();\n"
              "        if constexpr (HD == 128) {\n"
              "          float (&oh)[2][32] = *reinterpret_cast<float(*)[2][32]>(&o[0]);\n"
              "#pragma unroll\n"
              "          for (int blk = 0; blk < 2; ++blk)\n"
              "#pragma unroll\n"
              "            for (int kk = 0; kk < BN / 16; ++kk)\n"
              "              wgmma_rs<1>(oh[blk], pf[0][kk],\n"
              "                          make_desc<HD>(desc_lo<HD>(vs + blk * BN * 128), kk * 2048), 1);\n"
              "        } else {\n"
              "          mma_nn<HD, BN, 1>(o, pf, vs);\n"
              "        }")]
_BWD128_AT_16 = [
    ("    constexpr int BN = kDqTile, NWG = kDqGroups;",
     "    constexpr int BN = HD == 16 ? 128 : kDqTile, NWG = kDqGroups;"),
    ("    kDkvSmem<HD, kDkvTile, NP> + kDkvGroups",
     "    kDkvSmem<HD, (HD == 16 ? 128 : kDkvTile), NP> + kDkvGroups"),
    ("  constexpr int BN = kDkvTile, NWG = kDkvGroups, smem = kFlashDkvSmem<HD, NP>;",
     "  constexpr int BN = HD == 16 ? 128 : kDkvTile, NWG = kDkvGroups, "
     "smem = kFlashDkvSmem<HD, NP>;")]
# name -> substitutions (old, new) of the source
VARIANTS = {
    "final": [],
    "64-key forward tiles at hd 64": _FWD64_AT_64 + _NO_SHAPE_ASSERT,
    "64-key forward tiles at hd 64, S as two n32 products": _FWD64_AT_64 + _NO_SHAPE_ASSERT
    + _S_SPLIT,
    "128-key forward tiles at hd 128": _FWD128_AT_128 + _NO_SHAPE_ASSERT,
    "128-key forward tiles at hd 128, P.V as two n64 products": _FWD128_AT_128
    + _NO_SHAPE_ASSERT + _PV_SPLIT,
    "128-key backward tiles at hd 16": _BWD128_AT_16,
}


def build(name: str, text: str):
    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        if f.endswith(".cuh"):
            with open(os.path.join(_build.CSRC, f)) as src, open(os.path.join(d, f), "w") as dst:
                dst.write(src.read())
    src = os.path.join(d, "flash_attention_tc.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    p = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                       capture_output=True, text=True)
    return (None, p.stderr[-4000:]) if p.returncode else (lib, "")


def check(name: str) -> bool:
    """The variant's K4/K5 against the plain versions; prints a line a case."""
    ok = True
    for hd in (16, 32, 64, 128):
        for T, causal, lens in ((333, False, [333, 129, 1, 0]), (2048, True, [2048, 700, 1, 0])):
            dt = torch.bfloat16
            q, k, v, dout, g_lse = cs.flash_inputs(len(lens), T, hd, dt, seed=T + hd)
            kl = torch.tensor(lens, dtype=torch.int32).cuda()
            scale = hd ** -0.5
            out, lse = fa.flash_forward(q, k, v, kl, causal, scale)
            pout, plse = fa.flash_forward_reference(q, k, v, kl, causal, scale)
            grads = fa.flash_backward(q, k, v, kl, plse, pout, dout, causal, scale, g_lse)
            pgrads = fa.flash_backward_reference(q, k, v, kl, plse, pout, dout, causal, scale,
                                                 g_lse)
            torch.cuda.synchronize()
            live = plse > -1e29
            out_err = float((out.float() - pout.float()).abs().max())
            lse_err = float((lse - plse)[live].abs().max())
            rel = max(float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
                      for a, b in zip(grads, pgrads))
            good = (out_err <= cs.TOL_CTX[dt] and lse_err <= cs.TOL_LSE[dt]
                    and rel <= cs.TOL_DQKV_REL[dt] and torch.equal(lse > -1e29, live))
            ok &= good
            cs.log(f"  [{name}] hd={hd} T={T} causal={causal}: out max|err| {out_err:.3g}, lse "
                   f"{lse_err:.3g}, dq/dk/dv rel {rel:.3g} -> {'ok' if good else 'WRONG'}")
    return ok


def times(name: str) -> None:
    for hd in (16, 128):
        q, k, v, dout, _ = cs.flash_inputs(len(ENC_LENS), 2047, hd, torch.bfloat16, seed=1)
        kl = torch.tensor(ENC_LENS, dtype=torch.int32).cuda()
        scale = hd ** -0.5
        o, lse = fa.flash_forward(q, k, v, kl, False, scale)
        k4 = cs.time_cuda(lambda: fa.flash_forward(q, k, v, kl, False, scale), 20, queued=True)
        k5 = cs.time_cuda(lambda: fa.flash_backward(q, k, v, kl, lse, o, dout, False, scale), 20,
                          queued=True)
        cs.log(f"  [{name}] encoder B=4 H={cs.FLASH_H} T=2047 hd={hd}: K4 {k4:.4f} ms, K5 "
               f"{k5:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash-tc-variants: needs a CUDA card", file=sys.stderr)
        return 1
    if os.environ.get("VARIANT_LIB"):  # one variant, in a process of its own
        name = os.environ["VARIANT_NAME"]
        _build._loaded["flash_attention_tc"] = ctypes.CDLL(os.environ["VARIANT_LIB"])
        if os.environ.get("VARIANT_TIMES"):
            times(name)
            return 0
        return 0 if check(name) else 3
    names = ["final"] + [n for n in VARIANTS if n in sys.argv[1:] and n != "final"]
    if len(sys.argv) == 1:
        names = list(VARIANTS)
    with open(os.path.join(_build.CSRC, "flash_attention_tc.cu")) as f:
        source = f.read()
    texts = {}
    for n in names:
        text = source
        for old, new in VARIANTS[n]:
            if old not in text:
                raise SystemExit(f"variant {n!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        texts[n] = text
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    cs.log(f"card: {smi}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda n: build(n, texts[n]), texts)))
    cs.log(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    right = []
    for n, (lib, err) in built.items():
        cs.log(f"[{n}]" + (f" build failed:\n{err}" if lib is None else ""))
        if lib is None:
            continue
        env = {**os.environ, "VARIANT_LIB": lib, "VARIANT_NAME": n}
        rc = subprocess.run([sys.executable, __file__], env=env, timeout=300).returncode
        cs.log(f"[{n}] " + ("right" if rc == 0 else f"WRONG or failed (exit {rc})"))
        if rc == 0:
            right.append(n)
    for n in right + right[::-1]:
        env = {**os.environ, "VARIANT_LIB": built[n][0], "VARIANT_NAME": n, "VARIANT_TIMES": "1"}
        subprocess.run([sys.executable, __file__], env=env, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
