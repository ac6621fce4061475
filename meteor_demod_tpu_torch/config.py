"""Static demodulator configuration and derived block geometry.

A DemodConfig is hashable and immutable. Everything data-dependent lives in
DemodCarry (demod/state.py).

Geometry: a "block" is L input samples. The polyphase FIR produces all
L*interp interpolated outputs ("ticks") of the block densely; the feedback
loops (timing NCO gate, AGC, Costas PLL, M&M retiming) mutate state only
when the timing gate fires — once per symbol for QPSK — so the recurrence
runs S = steps_per_block gate evaluations per block. Each step reads its
fired tick directly from the FIR output (kernels/block_demod.py), so this
config carries none of the candidate-window geometry the TPU kernel needs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import constants as C
from .dsp.loops import loop_gains

_F32 = np.float32


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    samplerate: int
    symrate: float = C.SYM_RATE
    interp: int = C.INTERP_FACTOR
    rrc_order: int = C.RRC_ORDER
    rrc_alpha: float = C.RRC_ALPHA
    pll_bw: float = C.PLL_BW
    sym_bw: float = C.SYM_BW
    oqpsk: bool = False
    # Max carrier deviation in rad/sample at the symbol rate; negative means
    # "use the default 0.3" (pll.c:30-31). The CLI converts Hz via
    # 2*pi/symrate (main.c:136).
    freq_max: float = -1.0
    # Block length in input samples. Pure performance knob; output is
    # block-size invariant.
    block_len: int = 8192

    # ---- loop parameterization (demod.c:7-15, pll.c:24-44, timing.c:18-27)

    @property
    def taps(self) -> int:
        return 2 * self.rrc_order + 1

    @property
    def osf(self) -> float:
        """Oversampling factor, samples per symbol (demod.c:14)."""
        return float(self.samplerate) / float(self.symrate)

    @property
    def pll_bw_eff(self) -> np.float32:
        mult = 1 if self.oqpsk else 2
        return _F32(2 * math.pi * self.pll_bw / (mult * self.symrate))

    @property
    def pll_gains(self) -> tuple[np.float32, np.float32]:
        return loop_gains(C.DAMP_PLL, self.pll_bw_eff)

    @property
    def pll_fmax(self) -> np.float32:
        fm = self.freq_max
        fm = C.FREQ_MAX_DEFAULT if fm < 0 else min(1.0, fm)
        return _F32(fm / 2 if self.oqpsk else fm)

    @property
    def timing_freq(self) -> np.float32:
        """Timing NCO center frequency, rad per interpolated tick."""
        return _F32(2 * math.pi * self.symrate / (self.samplerate * self.interp))

    @property
    def timing_bw(self) -> np.float32:
        return _F32(self.sym_bw / self.interp)

    @property
    def timing_gains(self) -> tuple[np.float32, np.float32]:
        return loop_gains(C.DAMP_TIMING, self.timing_bw)

    @property
    def timing_dev_max(self) -> np.float32:
        return _F32(self.timing_freq / (1 << C.FREQ_DEV_EXP))

    # ---- block geometry

    @property
    def block_ticks(self) -> int:
        return self.block_len * self.interp

    @property
    def fire_spacing(self) -> float:
        """Nominal NCO phase between consecutive gate fires (rad)."""
        return math.pi if self.oqpsk else 2 * math.pi

    @property
    def ticks_per_fire(self) -> float:
        return self.fire_spacing / float(self.timing_freq)

    @property
    def fires_per_step(self) -> int:
        """Gate fires per recurrence step: one for QPSK, two for OQPSK (the
        I half-fire and the Q fire of one symbol paired into one step)."""
        return 2 if self.oqpsk else 1

    @property
    def ticks_per_step(self) -> float:
        return self.ticks_per_fire * self.fires_per_step

    @property
    def max_ticks_per_step(self) -> int:
        """Static bound on ticks consumed per step: steady state plus a
        1-rad M&M correction margin. A step that hits the bound without
        firing continues in the next step — exactness is preserved — so a
        transient retard beyond the margin costs one step of
        steps_per_block's slack."""
        f_min = float(self.timing_freq) * (1 - 2.0 ** -C.FREQ_DEV_EXP)
        return int(math.ceil((self.fire_spacing + 1.0) / f_min)) + 2

    @property
    def gate_candidates(self) -> int:
        """Candidate tick count K of the closed-form timing gate.

        The gate fires at k* = min{k in [1, K] : fl(k*tf) >= fl(thresh - tp)}
        — a multiply and a compare with NO multiply-add pattern, so the
        result is bit-identical across numpy (scalar oracle), torch and the
        CUDA kernel. K is max_ticks_per_step rounded up to a multiple of 8
        (the JAX package's value, kept so non-fire consumption min(rem, K)
        and hence the output rows line up with it)."""
        return -(-self.max_ticks_per_step // 8) * 8

    @property
    def steps_per_block(self) -> int:
        """Steps per block: nominal SYMBOL count (fires / fires_per_step)
        plus slack for timing frequency deviation (clamped to 2**-12
        relative, timing.c:7) and the acquisition transient."""
        nominal = self.block_ticks / self.ticks_per_step
        return int(math.ceil(nominal * (1 + 2.0 ** -(C.FREQ_DEV_EXP - 1)))) + 8

    def validate(self) -> None:
        if self.samplerate <= 0:
            raise ValueError("samplerate must be positive")
        if self.symrate <= 0:
            raise ValueError("symrate must be positive")
        if self.osf < 1.0:
            raise ValueError(
                f"samplerate {self.samplerate} below symbol rate {self.symrate}")
        if self.interp < 1 or self.rrc_order < 1:
            raise ValueError("interp and rrc_order must be >= 1")
        if self.block_len < 4 * self.taps:
            raise ValueError("block_len too small for the FIR order")
