"""Root-raised-cosine tap generation for the polyphase matched filter.

Numerics mirror the reference tap generator (filter.c:70-94): variable-alpha
RRC closed form with the 0/0 singularity handled at the center tap, a
0.42/0.5/0.08 Blackman window (the reference comment says "Hamming"; the
coefficients are Blackman), and an overall 2/5 normalization. The polyphase
bank layout mirrors filter_init_rrc (filter.c:18-22): bank j, tap i is the
upsampled prototype evaluated at stage i*factor + j, and filter_get
(filter.c:52) indexes banks reversed: phase p uses bank factor-1-p.

All arithmetic is float32 step-by-step, matching the reference's C float
evaluation to within 1 ulp of libm differences.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def rrc_coeffs(taps: int, osf: float, alpha: float) -> np.ndarray:
    """Prototype RRC taps. taps = total tap count, osf = samples per symbol.

    Equivalent to [rrc_coeff(i, taps, osf, alpha) for i in range(taps)]
    in the reference (filter.c:70-94), vectorized, float32.
    """
    norm = _F32(2.0 / 5.0)
    alpha = _F32(alpha)
    osf = _F32(osf)
    order = (taps - 1) // 2

    stage = np.arange(taps, dtype=np.int64)
    t = (np.abs(order - stage).astype(_F32) / osf).astype(_F32)

    pi = _F32(np.pi)
    coeff = (np.sin(pi * t * (_F32(1) - alpha), dtype=_F32)
             + _F32(4) * alpha * t * np.cos(pi * t * (_F32(1) + alpha), dtype=_F32))
    four_at = (_F32(4) * alpha * t).astype(_F32)
    interm = (pi * t * (_F32(1) - four_at * four_at)).astype(_F32)

    # Blackman window (filter.c:90-91)
    w = (_F32(0.42)
         - _F32(0.5) * np.cos(_F32(2 * np.pi) * stage.astype(_F32) / _F32(taps - 1), dtype=_F32)
         + _F32(0.08) * np.cos(_F32(4 * np.pi) * stage.astype(_F32) / _F32(taps - 1), dtype=_F32))
    coeff = (coeff * w).astype(_F32)

    with np.errstate(divide="ignore", invalid="ignore"):
        out = (coeff / interm * norm).astype(_F32)

    # 0/0 singularity at the center tap (filter.c:82-84)
    center_val = _F32(norm * (_F32(1) - alpha + _F32(4) * alpha / pi))
    out[stage == order] = center_val

    # Second removable singularity at t = 1/(4*alpha) (1 - (4*alpha*t)^2 = 0),
    # which the reference does NOT handle — its default configs never land an
    # integer stage there, but e.g. osf*interp = 24 with alpha = 0.6 does,
    # and the C code would emit inf taps. Evaluate the limit numerically from
    # a nudged t instead (float64, then rounded to f32 like everything else).
    bad = ~np.isfinite(out)
    if bad.any():
        t64 = np.abs(order - stage).astype(np.float64) / float(osf) + 1e-6
        c64 = (np.sin(np.pi * t64 * (1 - float(alpha)))
               + 4 * float(alpha) * t64 * np.cos(np.pi * t64
                                                 * (1 + float(alpha))))
        i64 = np.pi * t64 * (1 - (4 * float(alpha) * t64) ** 2)
        out[bad] = (c64[bad] / i64[bad] * w.astype(np.float64)[bad]
                    * float(norm)).astype(_F32)
    return out


def polyphase_rrc_banks(order: int, osf: float, alpha: float, factor: int) -> np.ndarray:
    """Polyphase RRC bank matrix, shape (factor, 2*order+1), float32.

    banks[p, k] is the tap applied to the k-th (oldest-first) delay-line
    sample when evaluating interpolation phase p. This folds in the
    reference's reversed bank indexing (filter.c:52): phase p reads bank
    j = factor - p - 1, whose tap i is prototype stage i*factor + j
    (filter.c:20).
    """
    taps = 2 * order + 1
    proto = rrc_coeffs(taps * factor, float(osf) * factor, alpha)
    banks = np.empty((factor, taps), dtype=np.float32)
    for p in range(factor):
        j = factor - p - 1
        banks[p, :] = proto[np.arange(taps) * factor + j]
    return banks
