"""Batched block demodulator: FIR, then the per-symbol recurrence.

Contract (the JAX package's demod/backend.py):
  demod(carry, x) -> (carry', BlockOutput)
with a leading (batch,) axis on every carry leaf and x of shape
(batch, block_len, 2) float32, all on one device. BlockOutput leaves are
(batch, steps_per_block).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import DemodConfig
from ..dsp.fir import make_fir_banks, polyphase_fir_block
from ..kernels.block_demod import block_demod, block_demod_torch

BACKENDS = ("auto", "cuda", "torch")


def make_batch_demod(cfg: DemodConfig, batch: int, device="cpu",
                     backend: str = "auto") -> Callable:
    """Batched block demodulator for `batch` streams on `device`.

    backend: "auto" runs the CUDA kernel for a CUDA device and the plain
    torch recurrence for a CPU device; "cuda" requires a CUDA device;
    "torch" runs the plain recurrence on any device (the reference the
    kernel is checked against). A single stream is batch=1."""
    cfg.validate()
    if cfg.oqpsk:
        raise NotImplementedError("OQPSK is not ported yet")
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs a CUDA device, got {device}")
    recurrence = block_demod_torch if backend == "torch" else block_demod
    banks = torch.as_tensor(make_fir_banks(cfg), device=device)

    def demod(carry, x: torch.Tensor):
        if x.shape != (batch, cfg.block_len, 2):
            raise ValueError(f"x must be ({batch}, {cfg.block_len}, 2), "
                             f"got {tuple(x.shape)}")
        Ft, new_tail = polyphase_fir_block(x, carry.fir_tail, banks)
        carry1, outs = recurrence(cfg, carry, Ft)
        carry1.fir_tail = new_tail
        return carry1, outs

    return demod
