"""Build and load the hand-written CUDA kernels.

Each kernel is one .cu file under csrc/ with a plain extern "C" launcher,
compiled by nvcc into a shared library and bound with ctypes (no PyTorch
headers, so a build takes seconds). The library goes into _build/ next to
this package, named by a hash of the source and the flags, and is built at
first use. A failed build raises with nvcc's output; there is no fallback.

Flags: Hopper only (sm_90a), -fmad=false so no multiply and add is fused,
and the default IEEE -prec-sqrt=true -prec-div=true -ftz=false. Never
--use_fast_math: the recurrence's decisions are bitwise against the numpy
oracle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-prec-sqrt=true", "-prec-div=true", "-ftz=false",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)            # atomic: a concurrent build never sees half
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu's library."""
    return ctypes.CDLL(str(build(name)))
