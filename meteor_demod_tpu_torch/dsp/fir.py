"""Block polyphase RRC matched filter.

The reference evaluates one 65-tap complex-by-real dot product per symbol
from a circular delay line (filter.c:38-65). Here ALL interpolated outputs
of a block are computed densely as a 1-D correlation with `interp` output
channels (overlap-save: the previous block's taps-1 samples are carried as
a halo). The recurrence then reads the ticks the timing gate fires on.

IQ layout: float32 (..., 2) re/im pairs, never complex.

F[s, p] equals the reference's filter_get(phase=p) evaluated right after
sample s was pushed (filter.c:45-65): an oldest-first dot product of
x[s-taps+1 .. s] with polyphase bank factor-1-p. Tick t = s*interp + p.

Precision: the FIR feeds the decision path (the budget is ~1e-5 relative),
so it runs in full float32. A cuDNN float32 convolution defaults to TF32
(a 10-bit mantissa) and a CUDA float32 matmul may be set to it, so this
module turns both off when it is imported:
torch.backends.cudnn.allow_tf32 = False and
torch.backends.cuda.matmul.allow_tf32 = False.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .rrc import polyphase_rrc_banks

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def make_fir_banks(cfg) -> np.ndarray:
    """(interp, taps) float32 bank matrix for cfg (demod.c:14 parameters)."""
    return polyphase_rrc_banks(cfg.rrc_order, cfg.osf, cfg.rrc_alpha, cfg.interp)


def polyphase_fir_block(x: torch.Tensor, tail: torch.Tensor,
                        banks: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched dense polyphase FIR over one block, tick-major output.

    Args:
      x: (B, L, 2) float32 input samples (re, im) of B streams.
      tail: (B, taps-1, 2) float32 — the last taps-1 samples of each
        stream's previous block (zeros at stream start, matching the
        calloc'd delay line, filter.c:15).
      banks: (interp, taps) float32 tensor on x's device, oldest-first taps
        per phase (make_fir_banks).

    Returns:
      Ft: (T, 2, B) float32 with T = L*interp; Ft[s*interp + p, c, b] is
        stream b's phase-p output after sample s, component c (0 = re).
        This is the layout of the JAX package's polyphase_fir_block_tmajor:
        each recurrence step reads one tick row of every stream.
      new_tail: (B, taps-1, 2) float32.
    """
    B, L, _ = x.shape
    interp, taps = banks.shape
    xin = torch.cat([tail, x], dim=1)                     # (B, L+taps-1, 2)
    lhs = xin.permute(0, 2, 1).reshape(2 * B, 1, L + taps - 1)
    out = F.conv1d(lhs, banks[:, None, :])                # (2B, interp, L)
    Ft = (out.view(B, 2, interp, L).permute(3, 2, 1, 0)
          .reshape(L * interp, 2, B))
    return Ft, xin[:, L:].contiguous()


def iq_to_f32(x: np.ndarray) -> np.ndarray:
    """complex64 -> (..., 2) float32. Zero-copy view."""
    return np.ascontiguousarray(x, dtype=np.complex64).view(np.float32).reshape(
        x.shape + (2,))


def f32_to_iq(x: np.ndarray) -> np.ndarray:
    """(..., 2) float32 -> complex64."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return x.view(np.complex64).reshape(x.shape[:-1])


def fir_reference_np(x: np.ndarray, tail: np.ndarray, banks: np.ndarray) -> np.ndarray:
    """Direct numpy evaluation of F (oldest-first dots), for the oracle.

    x, tail complex64; returns complex64 (L, interp)."""
    interp, taps = banks.shape
    xin = np.concatenate([tail.astype(np.complex64), x.astype(np.complex64)])
    L = len(x)
    F = np.empty((L, interp), dtype=np.complex64)
    for s in range(L):
        win = xin[s:s + taps]
        for p in range(interp):
            F[s, p] = np.dot(win, banks[p].astype(np.float32))
    return F
