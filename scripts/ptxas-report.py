#!/usr/bin/env python3
"""Registers, stack and spills of every kernel of the port's CUDA sources,
as ptxas reports them (``nvcc -Xptxas -v`` with the flags of
``musicstyletransfer_torch/ops/_build.py``).

    python3 scripts/ptxas-report.py [SOURCE ...]

SOURCE names a file of ``musicstyletransfer_torch/ops/csrc`` without its
``.cu`` (default: flash_attention_tc). Prints one line a kernel (the
demangled template arguments, registers, stack frame, spill stores and
loads, and the highest register its machine code names: ptxas reports the
count a thread starts with, the launch bound's, while code after a
``setmaxnreg.inc`` may use up to the raised count) and every ptxas
performance warning (wgmma serialization, C751x). The build goes to a
temporary file; nothing in the repository changes. Needs nvcc and
cuobjdump (the machine with the card).
"""

import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from musicstyletransfer_torch.ops import _build  # noqa: E402


def template_args(t: str):
    """The template arguments at the start of a mangled list (after its
    ``I``): integers ``Li<n>E``, ``f`` (float), length-prefixed names."""
    out = []
    while t and t[0] != "E":
        m = re.match(r"Li(\d+)E", t)
        if m:
            out.append(m.group(1))
        elif t[0] == "f":
            m = re.match("f", t)
            out.append("float")
        else:
            m = re.match(r"(\d+)", t)
            if m is None:
                break
            n = int(m.group(1))
            out.append(t[m.end():m.end() + n])
            m = re.match(r"\d+" + "." * n, t)
        t = t[m.end():]
    return out


def highest_registers(lib: str) -> dict:
    """{mangled kernel symbol: the highest register index its SASS names}."""
    nvcc = _build.find_nvcc()
    text = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            out[cur] = -1
        elif cur:
            out[cur] = max([out[cur]] + [int(r) for r in re.findall(r"\bR(\d+)\b", line)])
    return out


def report(name: str) -> int:
    src = _build.CSRC / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        p = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                            str(src)], capture_output=True, text=True)
        highest = highest_registers(lib) if p.returncode == 0 else {}
    print(f"{name}.cu: nvcc exit {p.returncode}")
    if p.returncode:
        print(p.stderr[-4000:])
        return p.returncode
    kernel, spill, symbol = None, "", None
    for line in p.stderr.splitlines():
        if "Compiling entry function" in line:
            # _ZN<n>_GLOBAL__N__<hash>_cu_<hash8><len><name>I<template arguments>E...
            symbol = re.search(r"'(\w+)'", line).group(1)
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
            name, rest = (m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):]) if m else (
                symbol, "")
            kernel = name + (f"<{', '.join(template_args(rest[1:]))}>" if rest[:1] == "I" else "")
        elif kernel and "spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line:
            print(f"  {kernel}: {line.split(':', 1)[1].strip()}; {spill}; highest register "
                  f"R{highest.get(symbol, '?')}")
            kernel, spill = None, ""
        elif "C751" in line or "Potential Performance Loss" in line:
            print(f"  warning: {line.split(':', 1)[1].strip()[:160]}")
    return 0


def main() -> int:
    return max(report(n) for n in (sys.argv[1:] or ["flash_attention_tc"]))


if __name__ == "__main__":
    sys.exit(main())
