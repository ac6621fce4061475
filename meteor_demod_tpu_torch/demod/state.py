"""Explicit demodulator state.

The reference keeps all DSP state in file-scope C statics (pll.c:16-22,
timing.c:13-16, agc.c:9-10, demod.c:54, filter delay line filter.h:5-11).
Here the same quantities form a dataclass of tensors, carried from block to
block. Leaves are float32/int32 tensors of shape (B,) for a batch of B
streams (or 0-d for one stream), plus the (B, taps-1, 2) float32 FIR tail.
The leaves and their order are those of the JAX package's DemodCarry, so a
carry converts to and from its carry_to_numpy dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import select_device

# Flag bits: any nonzero flag means "this block must be recomputed by the
# exact scalar fallback" — a should-never-happen safety net.
# FLAG_WINDOW_MISS: on the TPU, a gate fire landed outside the candidate
# window. The port reads every fired tick directly, so here it marks only
# the two OQPSK events that break the pairing's alignment: a deferred Q fire
# (transaction B found no fire within K ticks with more left; JAX scan.py
# l.262, l.379) and a deferred block-entry pre-fire (scan.py l.456-462).
FLAG_WINDOW_MISS = 1
FLAG_UNCONSUMED = 2    # steps exhausted before the block's ticks were


@dataclasses.dataclass
class DemodCarry:
    # Timing recovery (timing.c:13-16)
    t_phase: torch.Tensor   # f32, NCO phase accumulator
    t_freq: torch.Tensor    # f32, NCO frequency (rad/tick)
    t_prev: torch.Tensor    # f32, previous symbol Q for the M&M error
    # Carrier PLL (pll.c:16-22)
    p_phase: torch.Tensor   # f32
    p_freq: torch.Tensor    # f32
    p_err: torch.Tensor     # f32, lock-detector EMA
    locked: torch.Tensor    # int32 0/1
    locked_once: torch.Tensor  # int32 0/1
    updown: torch.Tensor    # f32 +-1, acquisition sweep direction (pll.c:111)
    # AGC (agc.c:9-10)
    agc_gain: torch.Tensor  # f32
    agc_bias_re: torch.Tensor  # f32, DC-bias tracker real part
    agc_bias_im: torch.Tensor  # f32, DC-bias tracker imag part
    # OQPSK half-symbol state (demod.c:54, timing.c:42)
    inphase: torch.Tensor   # f32
    slot: torch.Tensor      # int32 1/2, dual-timeslot NCO state
    # Block plumbing
    tick: torch.Tensor      # int32, ticks consumed within the current block
    fir_tail: torch.Tensor  # f32 (taps-1, 2), FIR delay-line carry
    flags: torch.Tensor     # int32 bitmask, sticky across blocks


CARRY_FIELDS = tuple(f.name for f in dataclasses.fields(DemodCarry))


@dataclasses.dataclass
class BlockOutput:
    """Per-step outputs of one block, shapes (B, S) for QPSK and (B, S+1)
    for OQPSK (row 0 the block-entry pre-fire)."""
    sym_re: torch.Tensor       # f32 soft symbol I (valid only where valid)
    sym_im: torch.Tensor       # f32 soft symbol Q
    valid: torch.Tensor        # int32 0/1, 1 where a symbol was produced
    locked_once: torch.Tensor  # int32, locked_once state after this step


@dataclasses.dataclass
class PackedOutput:
    """Device-quantized per-step outputs (fleet packed_output=True): the .s
    byte values computed on the device with quantize_symbols' exact math
    (component/2, clamp +-127, truncate toward zero; main.c:305-306), so the
    fleet's readback is int8 end to end, a quarter of BlockOutput's bytes."""
    sym_i: torch.Tensor        # int8 quantized I
    sym_q: torch.Tensor        # int8 quantized Q
    valid: torch.Tensor        # int8 0/1
    locked_once: torch.Tensor  # int8


def _init_values(cfg) -> dict:
    """Initial leaf values, mirroring the reference init paths (pll.c:24-44,
    timing.c:18-27, agc.c:9-10, calloc'd filter memory filter.c:15)."""
    return dict(
        t_phase=0.0, t_freq=float(cfg.timing_freq), t_prev=0.0,
        p_phase=0.0, p_freq=0.0, p_err=1000.0,
        locked=0, locked_once=0, updown=1.0,
        agc_gain=1.0, agc_bias_re=0.0, agc_bias_im=0.0,
        inphase=0.0, slot=1, tick=0, flags=0)


def batch_carry(cfg, batch: int, device=None) -> DemodCarry:
    """Initial carry with a leading (batch,) axis on every leaf, on `device`
    (None: utils.select_device's default, the card)."""
    device = select_device(device)
    leaves = {}
    for k, v in _init_values(cfg).items():
        dtype = torch.float32 if isinstance(v, float) else torch.int32
        leaves[k] = torch.full((batch,), v, dtype=dtype, device=device)
    leaves["fir_tail"] = torch.zeros((batch, cfg.taps - 1, 2),
                                     dtype=torch.float32, device=device)
    return DemodCarry(**leaves)


def init_carry(cfg, device=None) -> DemodCarry:
    """Initial single-stream carry (0-d leaves, (taps-1, 2) FIR tail)."""
    c = batch_carry(cfg, 1, device)
    return DemodCarry(**{k: getattr(c, k)[0] for k in CARRY_FIELDS})


def batch_carry_np(cfg, batch: int) -> dict:
    """batch_carry as a dict of host numpy leaves (carry_to_numpy's layout),
    for bookkeeping that stays on the host."""
    return {k: np.array(v) for k, v in
            carry_to_numpy(batch_carry(cfg, batch, "cpu")).items()}


def carry_to_numpy(carry: DemodCarry) -> dict:
    """Carry -> dict of numpy leaves, in the JAX package's carry_to_numpy
    layout (same keys, shapes and dtypes)."""
    return {k: getattr(carry, k).detach().cpu().numpy() for k in CARRY_FIELDS}


def carry_from_numpy(leaves: dict, device=None) -> DemodCarry:
    """Dict of numpy leaves (carry_to_numpy of either package) -> carry on
    `device` (None: the card, as batch_carry)."""
    device = select_device(device)
    out = {}
    for k in CARRY_FIELDS:
        a = np.asarray(leaves[k])
        dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
        out[k] = torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return DemodCarry(**out)
