"""The demodulation's least work: bytes and float operations.

Counted from the inputs and what they need, not from what a kernel does:
the int16 IQ pairs read once (4 bytes a sample), the outputs written once,
the matched filter's multiply-adds (taps x interp phases x 2 components
a sample, 2 operations each) and OPS_PER_FIRE float operations for each
fire of the timing gate (a QPSK symbol is one fire, an OQPSK symbol two),
counted from the recurrence of csrc/block_demod.cu: AGC, NCO mix, M&M,
Costas, lock detector and the gate.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet; full 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_FIRE = 80


def counts(cfg: dict, samples: int, symbols: int,
           out_bytes_per_symbol: int) -> dict:
    taps = 2 * int(cfg["rrc_order"]) + 1
    fires = symbols * (2 if cfg["oqpsk"] else 1)
    n_bytes = 4 * samples + out_bytes_per_symbol * symbols
    flops = samples * int(cfg["interp"]) * taps * 2 * 2 + OPS_PER_FIRE * fires
    return {"bytes": n_bytes, "flops": flops}


def least_seconds(work: dict) -> tuple[float, str]:
    """The least time the card could take, and which side bounds it."""
    by_bytes = work["bytes"] / HBM_BYTES_PER_S
    by_ops = work["flops"] / FP32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
