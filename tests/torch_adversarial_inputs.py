"""The three adversarial inputs of tests/test_adversarial.py, made with the
port's sim (not a test module): imported by tests/test_torch_adversarial.py
(stream driver against the oracles, CPU) and tests/test_torch_kernel_card.py
(kernel against the plain recurrence, on the card). Neither imports jax."""

import numpy as np

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.sim import synth_psk

CFG = DemodConfig(samplerate=230400, block_len=2048)
SKEW = 1.5 * 2.0 ** -12     # beyond the 2**-12 timing clamp (timing.c:7)


def full_scale_cold_start(cfg: DemodConfig = CFG) -> np.ndarray:
    """4 blocks of QPSK at amplitude 23000 through the int16 clamp: the
    first M&M errors at gain 1 are the largest the loop can see."""
    n = 4 * cfg.block_len
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, carrier_hz=250.0, amplitude=23000.0,
                     snr_db=25.0, seed=7)
    x = x[:n]
    return (np.clip(np.real(x), -32768, 32767)
            + 1j * np.clip(np.imag(x), -32768, 32767)).astype(np.complex64)


def onset_after_silence(cfg: DemodConfig = CFG) -> np.ndarray:
    """5 blocks of silence (the AGC gain integrates upward), then 2 blocks of
    a full-scale tone at half the symbol rate, whose Q alternates sign every
    symbol so that consecutive M&M errors add up."""
    L = cfg.block_len
    t = np.arange(2 * L)
    tone = (32000.0 * np.exp(
        1j * 2 * np.pi * (cfg.symrate / 2) / cfg.samplerate * t)
    ).astype(np.complex64)
    return np.concatenate([np.zeros(5 * L, np.complex64), tone])


def max_timing_skew(cfg: DemodConfig = CFG) -> np.ndarray:
    """12 blocks whose symbol clock runs SKEW fast (1.5x past the loop's
    clamp): the timing frequency pegs at the clamp for the whole input."""
    n = 12 * cfg.block_len
    x0, _ = synth_psk(int(1.01 * n * cfg.symrate / cfg.samplerate) + 64,
                      cfg.samplerate, carrier_hz=120.0, amplitude=6000.0,
                      snr_db=25.0, seed=11)
    p = np.arange(n) * (1.0 + SKEW)
    return (np.interp(p, np.arange(len(x0)), x0.real)
            + 1j * np.interp(p, np.arange(len(x0)), x0.imag)
            ).astype(np.complex64)


INPUTS = {"full_scale_cold_start": full_scale_cold_start,
          "onset_after_silence": onset_after_silence,
          "max_timing_skew": max_timing_skew}
