#!/usr/bin/env python3
"""Build variants of the tensor-core kernels of the attention core (K2/K3,
the core's entry points of ``musicstyletransfer_torch/ops/csrc/
flash_attention_tc.cu``) and measure each on one CUDA card.

    python3 scripts/core-kernel-variants.py [NAME ...]

Each variant is the source with the text substitutions of ``VARIANTS``
below, built with nvcc (all at once, ``-Xptxas -v``: registers and spills
are printed) into build/variants/. Each is held against the plain versions
in bfloat16 at the wide shapes and at T=333/200 (chip_smoke's tolerances;
a variant that fails is reported and not timed), then K2 and K3 are timed
at both wide shapes with the corpus batch's key lengths, the variants in
turns (first to last, then back), the card held back while the host
enqueues, with each kernel's time from torch.profiler. With names, only
those variants (and "final") run. Needs a card and nvcc.
"""

import ctypes
import math
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
from musicstyletransfer_torch.ops import attention_core as ac  # noqa: E402

CSRC = os.path.join(REPO, "musicstyletransfer_torch", "ops", "csrc")
OUT = os.path.join(REPO, "build", "variants")

_ONE_BLOCK_AN_ITEM = [("static const int blocks = resident_blocks<NWG>(kernel, smem);",
                       "static const int blocks = 1 << 30;")]
_PLAIN_ORDER = [("if (B > kMaxSortedRows) {", "if (true) {")]
_DELTA_KERNEL = [
    ("it = dq_consume<HD, BN, NWG, true>(", "it = dq_consume<HD, BN, NWG, false>("),
    ("template <int HD> cudaError_t launch_core_backward(const MstFlashArgs& a, cudaStream_t stream) {\n",
     "template <int HD> cudaError_t launch_core_backward(const MstFlashArgs& a, cudaStream_t stream) {\n"
     "  const size_t rows = (size_t)a.B * a.H * a.T;\n"
     "  flash_bwd_delta_kernel_tc<HD><<<(unsigned)((rows + 256 / (HD / 8) - 1) / (256 / (HD / 8))),"
     " 256, 0, stream>>>(a);\n"
     "  if (cudaGetLastError() != cudaSuccess) return cudaErrorLaunchFailure;\n")]
_TWO_GROUPS = [("kCoreDqTile = 64, kCoreDqGroups = 1;", "kCoreDqTile = 64, kCoreDqGroups = 2;"),
               ("kCoreDkvTile = 64, kCoreDkvGroups = 1;", "kCoreDkvTile = 64, kCoreDkvGroups = 2;")]
# name -> substitutions (old, new) of the source
VARIANTS = {
    "final": [],
    "one block an item": _ONE_BLOCK_AN_ITEM,
    "plain order": _PLAIN_ORDER,
    "delta kernel": _DELTA_KERNEL,
    "two warpgroups a block (dQ, dK/dV)": _TWO_GROUPS,
    "as K5 (all four above)": _ONE_BLOCK_AN_ITEM + _PLAIN_ORDER + _DELTA_KERNEL + _TWO_GROUPS,
    "forward: 64-key tiles, one warpgroup": [
        ("kCoreFwdTile = 128, kCoreFwdGroups = 2;", "kCoreFwdTile = 64, kCoreFwdGroups = 1;"),
        ('static_assert(!(HD == 64 && BN == 64), "64-key forward tiles at HD=64 give wrong results");',
         "")],
}
ENC_LENS = [78, 183, 331, 513, 30, 513, 513, 513]  # the corpus's first wide batch


def build(name: str, text: str):
    d = os.path.join(OUT, re.sub(r"\W+", "_", name))
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(CSRC):
        if f.endswith(".cuh"):
            with open(os.path.join(CSRC, f)) as src, open(os.path.join(d, f), "w") as dst:
                dst.write(src.read())
    src = os.path.join(d, "flash_attention_tc.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    p = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, src],
                       capture_output=True, text=True)
    if p.returncode:
        return None, p.stderr[-4000:]
    notes, kernel = [], None
    for line in p.stderr.splitlines():
        m = re.search(r"entry function '\w*?(core_\w+?_kernel_tc)I(\w+?)EEEv", line)
        if m:
            kernel = m.group(1) + "<" + ",".join(re.findall(r"Li(\d+)E", m.group(2) + "E")) + ">"
        elif kernel and ("Used" in line or "spill" in line):
            notes.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                kernel = None
    return lib, "\n".join(notes)


def use(lib: str) -> None:
    _build._loaded["flash_attention_tc"] = ctypes.CDLL(lib)
    ac._entry_points.clear()


def check(name: str) -> bool:
    ok = True
    cases = [(513, 64, False, None), (514, 32, True, None), (333, 32, False, [333, 166, 1, 0]),
             (200, 64, True, [200, 100, 1, 0])]
    for T, hd, causal, lens in cases:
        qkv, kl, dout = cs.core_inputs(T, hd, torch.bfloat16, seed=T + hd, lens=lens)
        s = 1.0 / math.sqrt(hd)
        ctx, lse = ac.core_forward(qkv, kl, cs.CORE_H, causal, s)
        pctx, plse = ac.core_forward_reference(qkv, kl, cs.CORE_H, causal, s)
        d = ac.core_backward(qkv, kl, plse, pctx, dout, cs.CORE_H, causal, s)
        pd = ac.core_backward_reference(qkv, kl, plse, pctx, dout, cs.CORE_H, causal, s)
        torch.cuda.synchronize()
        live = plse > -1e29
        ctx_err = float((ctx.float() - pctx.float()).abs().max())
        lse_err = float((lse - plse)[live].abs().max())
        rel = float((d.float() - pd.float()).abs().max()) / float(pd.float().abs().max())
        good = (ctx_err <= cs.TOL_CTX[torch.bfloat16] and lse_err <= cs.TOL_LSE[torch.bfloat16]
                and rel <= cs.TOL_DQKV_REL[torch.bfloat16] and torch.equal(lse > -1e29, live))
        ok &= good
        cs.log(f"  [{name}] T={T} hd={hd} causal={causal}: ctx max|err| {ctx_err:.3g}, lse "
               f"{lse_err:.3g}, dqkv rel {rel:.3g} -> {'ok' if good else 'WRONG'}")
    return ok


def kernel_times(T, hd, causal, lens) -> str:
    from torch.profiler import ProfilerActivity, profile

    qkv, kl, dout = cs.core_inputs(T, hd, torch.bfloat16, seed=1, lens=lens)
    s = 1.0 / math.sqrt(hd)
    ctx, lse = ac.core_forward(qkv, kl, cs.CORE_H, causal, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ac.core_forward(qkv, kl, cs.CORE_H, causal, s)
            ac.core_backward(qkv, kl, lse, ctx, dout, cs.CORE_H, causal, s)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    def short(key):  # "void (anonymous namespace)::core_fwd_kernel_tc<64, 128, 2>(...)"
        return re.sub(r".*::|\(.*", "", key)

    return ", ".join(f"{short(e.key)} "
                     f"{getattr(e, 'self_device_time_total', 0) / max(e.count, 1) / 1e3:.4f} ms"
                     for e in events)


def main() -> int:
    if not torch.cuda.is_available():
        print("core-kernel-variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ["final"] + [n for n in VARIANTS if n in sys.argv[1:] and n != "final"]
    if len(sys.argv) == 1:
        names = list(VARIANTS)
    with open(os.path.join(CSRC, "flash_attention_tc.cu")) as f:
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
    libs = {}
    for n, (lib, notes) in built.items():
        cs.log(f"[{n}] " + ("build failed:\n" if lib is None else "ptxas:\n") + notes)
        if lib is not None:
            use(lib)
            if check(n):
                libs[n] = lib
    seq = [n for n in names if n in libs]
    for label, T, hd, causal, lens in (("encoder", 513, 64, False, ENC_LENS),
                                       ("decoder", 514, 32, True, [n + 1 for n in ENC_LENS])):
        qkv, kl, dout = cs.core_inputs(T, hd, torch.bfloat16, seed=1, lens=lens)
        s = 1.0 / math.sqrt(hd)
        times = {n: ([], []) for n in seq}
        for n in seq + seq[::-1]:
            use(libs[n])
            ctx, lse = ac.core_forward(qkv, kl, cs.CORE_H, causal, s)
            times[n][0].append(cs.time_cuda(lambda: ac.core_forward(qkv, kl, cs.CORE_H, causal, s),
                                            40, queued=True))
            times[n][1].append(cs.time_cuda(
                lambda: ac.core_backward(qkv, kl, lse, ctx, dout, cs.CORE_H, causal, s), 40,
                queued=True))
        for n in seq:
            use(libs[n])
            k2, k3 = times[n]
            cs.log(f"{label} T={T} hd={hd} causal={causal} [{n}]: K2 {min(k2):.4f}-{max(k2):.4f} ms, "
                   f"K3 {min(k3):.4f}-{max(k3):.4f} ms; by kernel: "
                   + kernel_times(T, hd, causal, lens))
    return 0


if __name__ == "__main__":
    sys.exit(main())
