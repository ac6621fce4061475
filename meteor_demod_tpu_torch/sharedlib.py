"""Shared libraries compiled from the repo's sources at first use.

A library goes into _build/ next to this package, named by a hash of its
source and flags, so an edit of either builds anew. It is compiled into a
temporary file that is then moved into place, so processes that start
together (test workers, a script's subprocesses) may build at once and never
load half a library. kernels/_build.py builds the CUDA kernels this way with
nvcc, io/native.py the host I/O library with the system C++ compiler.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def keyed_path(stem: str, src: Path, flags, build_dir: Path) -> Path:
    """Where the library built from `src` with `flags` goes: build_dir,
    named by a hash of the source and the flags."""
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                         ).hexdigest()[:16]
    return build_dir / f"lib{stem}_{key}.so"


def compile_library(cmd: list, src: Path, out: Path) -> Path:
    """Run `cmd -o <temporary> src` and move the result to `out`. The move
    is atomic, so processes that build at once never load half a library.
    A failed compile raises with the compiler's output and leaves nothing."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp, str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{Path(cmd[0]).name} failed ({proc.returncode}) "
                           f"for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out
