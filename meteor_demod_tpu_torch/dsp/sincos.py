"""Q14 fixed-point parabolic sine/cosine, bit-compatible with the reference.

The reference NCO avoids libm in the hot loop with an int16/int32 parabolic
approximation (sincos.c:12-47). The integer arithmetic is reproduced exactly
in torch (and numpy for the oracle): phase is mapped to a wrapping 16-bit
fixed-point angle, folded to a quarter-wave parabola in Q14, and evaluated
with two multiply-shift steps. The torch form keeps every value in int32 and
expresses the int16 wrap as (x << 16) >> 16, the form the CUDA kernel uses
(csrc/block_demod.cu). The only deviation from the C code is the
float->fixed conversion, which the C code performs with a float64 divide
(sincos.c:23) and this module with a float32 multiply.

Max absolute error vs sin(x) is ~0.0021 (same as the reference).
"""

from __future__ import annotations

import numpy as np
import torch

Q_SHIFT = 14
# Fixed-point parabola constants (sincos.c:18-19): a=1.0, b=2-pi/4, c=b-1 in Q14.
_A = 1 << Q_SHIFT                                    # 16384
_B = int((2 - 3.14159 / 4) * (1 << Q_SHIFT))         # 19900
_C = _B - (1 << Q_SHIFT)                             # 3516
_PHASE_SCALE = np.float32(65536.0 / (2 * np.pi))
_INV_Q = np.float32(1.0 / (1 << Q_SHIFT))
HALF_PI = np.float32(np.pi / 2)


def fast_sin(fx: torch.Tensor) -> torch.Tensor:
    """Parabolic sine approximation (sincos.c:12-34). fx: float32 tensor."""
    xi = (fx * float(_PHASE_SCALE)).to(torch.int32)  # trunc toward zero
    x16 = (xi << 16) >> 16                           # wrap modulo 2**16
    sign = x16 < 0
    x = (x16 & 0x7FFF) - (1 << Q_SHIFT)
    x2 = (x * x) >> Q_SHIFT
    y = _B - ((x2 * _C) >> Q_SHIFT)
    y = _A - ((x2 * y) >> Q_SHIFT)
    y = torch.where(sign, -y, y)
    return y.to(torch.float32) * float(_INV_Q)


def fast_cos(fx: torch.Tensor) -> torch.Tensor:
    """cos(x) = sin(x + pi/2) (sincos.c:36-40)."""
    return fast_sin(fx + float(HALF_PI))


def fast_sin_np(fx):
    """Bit-identical numpy version of fast_sin, for the scalar oracle."""
    fx = np.asarray(fx, dtype=np.float32)
    xi = np.trunc(fx * _PHASE_SCALE).astype(np.int64).astype(np.int32)
    x16 = xi.astype(np.int16)
    sign = x16 < 0
    x = (x16.astype(np.int32) & 0x7FFF) - (1 << Q_SHIFT)
    x2 = (x * x) >> Q_SHIFT
    y = _B - ((x2 * _C) >> Q_SHIFT)
    y = _A - ((x2 * y) >> Q_SHIFT)
    y = np.where(sign, -y, y)
    return (y.astype(np.float32) * _INV_Q).astype(np.float32)


def fast_cos_np(fx):
    return fast_sin_np(np.asarray(fx, dtype=np.float32) + HALF_PI)
