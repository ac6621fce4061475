"""The RRC matched filter: taps from the configuration and every
interpolated output of a block.

Taps follow filter.c:70-94 (variable-alpha RRC, the 0.42/0.5/0.08 Blackman
window, 2/5 normalisation) and the polyphase layout of filter.c:18-22 and
52: phase p of sample s is the oldest-first dot product of the taps-1
samples before s and s itself with bank interp-1-p. Tick t = s*interp + p.

fir_block evaluates a block of many lanes in float64 and rounds each output
once to float32: the float32 tick nearest the exact dot product, whatever
order a float32 implementation sums in. A float32 filter that sums in any
order lies within a few units in the last place of it.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = np.float32


def rrc_coeffs(taps: int, osf: float, alpha: float) -> np.ndarray:
    norm, alpha, osf = F32(2.0 / 5.0), F32(alpha), F32(osf)
    order = (taps - 1) // 2
    stage = np.arange(taps, dtype=np.int64)
    t = (np.abs(order - stage).astype(F32) / osf).astype(F32)
    pi = F32(np.pi)
    coeff = (np.sin(pi * t * (F32(1) - alpha), dtype=F32)
             + F32(4) * alpha * t * np.cos(pi * t * (F32(1) + alpha),
                                           dtype=F32))
    four_at = (F32(4) * alpha * t).astype(F32)
    interm = (pi * t * (F32(1) - four_at * four_at)).astype(F32)
    w = (F32(0.42)
         - F32(0.5) * np.cos(F32(2 * np.pi) * stage.astype(F32)
                             / F32(taps - 1), dtype=F32)
         + F32(0.08) * np.cos(F32(4 * np.pi) * stage.astype(F32)
                              / F32(taps - 1), dtype=F32))
    coeff = (coeff * w).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (coeff / interm * norm).astype(F32)
    out[stage == order] = F32(norm * (F32(1) - alpha + F32(4) * alpha / pi))
    if not np.all(np.isfinite(out)):
        raise ValueError("RRC taps hit the 1/(4 alpha) singularity")
    return out


def banks(cfg: dict) -> np.ndarray:
    """(interp, taps) float32: banks[p] is phase p's oldest-first taps."""
    interp, order = int(cfg["interp"]), int(cfg["rrc_order"])
    taps = 2 * order + 1
    proto = rrc_coeffs(taps * interp,
                       cfg["samplerate"] / cfg["symrate"] * interp,
                       cfg["rrc_alpha"])
    return np.stack([proto[np.arange(taps) * interp + interp - p - 1]
                     for p in range(interp)]).astype(F32)


def fir_block(x: torch.Tensor, tail: torch.Tensor,
              bank: np.ndarray) -> np.ndarray:
    """x: (lanes, n, 2), tail: (lanes, taps-1, 2), on one device. Returns
    (lanes, n*interp) complex64 on the host, tick-major."""
    lanes, n, _ = x.shape
    interp, taps = bank.shape
    xin = torch.cat([tail, x], dim=1).to(torch.float64)
    lhs = xin.permute(0, 2, 1).reshape(2 * lanes, 1, n + taps - 1)
    w = torch.as_tensor(bank, dtype=torch.float64, device=x.device)
    out = torch.nn.functional.conv1d(lhs, w[:, None, :])
    out = out.to(torch.float32).cpu().numpy().reshape(lanes, 2, interp, n)
    ticks = np.empty((lanes, n, interp), np.complex64)
    ticks.real = out[:, 0].transpose(0, 2, 1)
    ticks.imag = out[:, 1].transpose(0, 2, 1)
    return ticks.reshape(lanes, n * interp)
