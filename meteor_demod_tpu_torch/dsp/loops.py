"""Loop-filter math shared by the carrier PLL and symbol-timing recovery.

- loop_gains: the critically-damped 2nd-order proportional/integral gains
  used by both loops (pll.c:132-140, timing.c:97-105).
- tanh LUT phase detector (pll.c:142-159): error = tanh(I)*Q - tanh(Q)*I with
  tanh evaluated by truncating the argument to an integer in [-16, 15] and
  looking it up; values outside return +-1. Since float32(tanh(x)) == +-1.0
  for |x| >= 9, a single clipped table lookup reproduces every branch of the
  C code exactly.
- Mueller & Muller timing error (timing.c:89-95) with the reference's
  sgn(0) = +1 convention (utils.h:26).
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32

# tanh at integers -16..15, float64 tanh rounded to float32 — identical to the
# reference table construction (pll.c:40-42).
TANH_TABLE = np.tanh(np.arange(-16, 16, dtype=np.float64)).astype(np.float32)


def loop_gains(damp: float, bw: float) -> tuple[np.float32, np.float32]:
    """(alpha, beta) loop gains, float32 (pll.c:132-140)."""
    damp = _F32(damp)
    bw = _F32(bw)
    denom = _F32(_F32(1) + _F32(2) * damp * bw + bw * bw)
    alpha = _F32(_F32(4) * damp * bw / denom)
    beta = _F32(_F32(4) * bw * bw / denom)
    return alpha, beta


def lut_tanh(v: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Truncating tanh lookup (pll.c:153-159). v: float32 tensor; table:
    TANH_TABLE as a float32 tensor on v's device."""
    idx = torch.clamp(torch.trunc(v), -16.0, 15.0).to(torch.int64) + 16
    return table[idx]


def lut_tanh_np(v):
    v = np.asarray(v, dtype=np.float32)
    idx = np.clip(np.trunc(v), -16.0, 15.0).astype(np.int32) + 16
    return TANH_TABLE[idx]


def costas_error_np(re, im):
    """Costas phase detector (pll.c:142-151)."""
    return _F32(lut_tanh_np(re) * _F32(im) - lut_tanh_np(im) * _F32(re))


def sgn_np(x):
    """Reference sgn macro: x < 0 -> -1 else +1 (utils.h:26)."""
    return _F32(-1) if x < 0 else _F32(1)


def mm_error_np(prev, cur):
    """Mueller & Muller timing error (timing.c:89-95)."""
    return _F32(sgn_np(prev) * _F32(cur) - sgn_np(cur) * _F32(prev))
