"""Build the CUDA sources in ``ops/csrc`` with ``nvcc`` and load them with ctypes.

Each source becomes a shared library with a plain C interface, compiled for
Hopper (``sm_90a``) into ``build/kernels/`` under the repository root at
first use, and rebuilt when the source, a header (``*.cuh``) or the flags
change (the file name carries their hash). ``torch.utils.cpp_extension`` is
not used: a source that includes PyTorch's headers takes minutes to compile,
a plain C one seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from ..utils import REPO_ROOT

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if nvcc is None and os.path.exists(fallback):
        nvcc = fallback
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found (neither on PATH nor at {fallback}): the CUDA "
            "kernels of musicstyletransfer_torch are compiled at first use and "
            "need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
