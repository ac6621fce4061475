"""ctypes bindings for the native I/O hot paths of native/meteor_io.cc: the
interleaved I/Q sample decoder and the int8 soft-symbol quantizer (the
reference's own I/O is C: wavfile.c:50-80, main.c:305-316).

The library is compiled from that source with the system C++ compiler at
first use, into the package's _build/ directory under a name keyed by the
source and the flags (sharedlib.py), never loaded from a prebuilt
native/libmeteor_io.so: that file may have been built with -march=native on
another host, and an illegal instruction kills the process where no
exception can catch it. Building into a temporary file that is then moved
into place lets processes that start together build at once.

With no C++ compiler (or no source) every function returns None and the
callers use numpy; a compiler that is present but fails raises with its
output. `available()` says which path runs. Both give the same bytes
(tests/test_torch_native_io.py).
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
from pathlib import Path

import numpy as np

from ..sharedlib import BUILD_DIR, compile_library, keyed_path

SOURCE = Path(__file__).resolve().parents[2] / "native" / "meteor_io.cc"
# No -march=native: the library must run on any x86-64 host it is copied to.
CXX_FLAGS = ("-O3", "-fPIC", "-shared")


def find_cxx() -> str | None:
    """The C++ compiler: $CXX, else g++, c++ or clang++ on PATH; None if
    there is none."""
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    return None


def library_path() -> Path:
    return keyed_path("meteor_io", SOURCE, CXX_FLAGS, BUILD_DIR)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL | None:
    cxx = find_cxx()
    if cxx is None or not SOURCE.exists():
        return None
    out = library_path()
    if not out.exists():
        compile_library([cxx, *CXX_FLAGS], SOURCE, out)
    lib = ctypes.CDLL(str(out))
    # Pointers as c_void_p, filled by _ref: data_as and its casts cost more
    # than the decode of a 32 KiB chunk. Input bytes pass as c_char_p.
    for bps in (8, 16, 32):
        fn = getattr(lib, f"meteor_decode_iq{bps}")
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        fn.restype = ctypes.c_size_t
    lib.meteor_quantize_soft.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_size_t, ctypes.c_void_p]
    lib.meteor_quantize_soft.restype = None
    return lib


def available() -> bool:
    """True when the C++ library is built and loaded (building it now if it
    has to be), False when the numpy paths run."""
    return _library() is not None


def _ref(a: np.ndarray):
    """A reference to a's buffer for a c_void_p argument, without a copy;
    a must be writable, contiguous and not empty."""
    return ctypes.byref(ctypes.c_char.from_buffer(a))


def decode_iq_f32(raw: bytes, bps: int) -> np.ndarray | None:
    """Interleaved I/Q bytes at 8, 16 or 32 bits a component -> (n, 2)
    float32 raw counts (io/wav.py decode_iq's values); a trailing partial
    sample is dropped. None without the library or for another width."""
    lib = _library()
    if lib is None or bps not in (8, 16, 32):
        return None
    raw = bytes(raw)                    # no copy when it is bytes already
    out = np.empty((len(raw) // (2 * bps // 8), 2), dtype=np.float32)
    if len(out):                        # c_char.from_buffer needs a byte
        getattr(lib, f"meteor_decode_iq{bps}")(raw, len(raw), _ref(out))
    return out


def quantize_soft(re: np.ndarray, im: np.ndarray) -> np.ndarray | None:
    """Soft symbol components -> interleaved int8 .s bytes (component / 2,
    clamped to +-127, truncated toward zero; pipeline.quantize's math).
    None without the library. Strided inputs (the fields of a symbol
    array) and read-only ones are copied to contiguous float32 first."""
    lib = _library()
    if lib is None:
        return None
    re = np.require(re, np.float32, "CW")
    im = np.require(im, np.float32, "CW")
    if re.shape != im.shape or re.ndim != 1:
        raise ValueError(f"re and im must be equal 1-d arrays, got "
                         f"{re.shape} and {im.shape}")
    out = np.empty(2 * len(re), dtype=np.int8)
    if len(re):
        lib.meteor_quantize_soft(_ref(re), _ref(im), len(re), _ref(out))
    return out
