"""The recurrence's constants, worked out from a configuration file.

Every value is a float32 computed step by step as the upstream C code does
(demod.c:7-15, pll.c:24-44 and 132-140, timing.c:18-27): the loop gains of
a critically damped second-order loop, the timing NCO's centre and its
2**-12 clamp, and the PLL's frequency limit.
"""

from __future__ import annotations

import math

import numpy as np

F32 = np.float32

FREQ_MAX_DEFAULT = 0.3
ERR_POLE = 0.001
DAMP_PLL = 0.7071067811865475
LOCK_THRESH = 85.0
UNLOCK_THRESH = 105.0
SWEEP_STEP = 1e-6
FREQ_DEV_EXP = 12
DAMP_TIMING = 1.0
AGC_TARGET = 190.0
AGC_BIAS_POLE = 0.001
AGC_GAIN_POLE = 0.0001
RING_SYMBOLS = 512


def loop_gains(damp: float, bw: float) -> tuple:
    damp, bw = F32(damp), F32(bw)
    denom = F32(F32(1) + F32(2) * damp * bw + bw * bw)
    return F32(F32(4) * damp * bw / denom), F32(F32(4) * bw * bw / denom)


def derive(cfg: dict) -> dict:
    """The constants of one configuration (a configs/*.json dict)."""
    fs, sr = float(cfg["samplerate"]), float(cfg["symrate"])
    interp, oqpsk = int(cfg["interp"]), bool(cfg["oqpsk"])
    pll_bw_eff = F32(2 * math.pi * cfg["pll_bw"] / ((1 if oqpsk else 2) * sr))
    fm = cfg["freq_max"]
    fm = FREQ_MAX_DEFAULT if fm < 0 else min(1.0, fm)
    timing_freq = F32(2 * math.pi * sr / (fs * interp))
    fire_spacing = math.pi if oqpsk else 2 * math.pi
    f_min = float(timing_freq) * (1 - 2.0 ** -FREQ_DEV_EXP)
    max_ticks = int(math.ceil((fire_spacing + 1.0) / f_min)) + 2
    a_t, b_t = loop_gains(DAMP_TIMING, F32(cfg["sym_bw"] / interp))
    a_p, b_p = loop_gains(DAMP_PLL, pll_bw_eff)
    return dict(
        oqpsk=oqpsk, interp=interp, taps=2 * int(cfg["rrc_order"]) + 1,
        block_len=int(cfg["block_len"]), osf=fs / sr,
        a_t=a_t, b_t=b_t, a_p=a_p, b_p=b_p,
        t_center=timing_freq, t_dev=F32(timing_freq / (1 << FREQ_DEV_EXP)),
        fmax=F32(fm / 2 if oqpsk else fm),
        gate_candidates=-(-max_ticks // 8) * 8)
