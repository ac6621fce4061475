"""The acquisition dead zone near zero through the port's stream driver and
fleet on the CPU: tests/test_golden_reference.py:330's fixture without the
C binary.

A -195.3 Hz, 25 dB carrier at the default +-3.4 kHz band: the reference's
upward-first sweep (pll.c:126-128) stalls in a limit cycle near -10 Hz and
never locks; both the C binary and the JAX package keep that behaviour, and
so must the port. The golden test runs 20 s of signal through the JAX scan;
the port's plain recurrence costs ~3 s a block on the CPU, so this runs the
first N_BLOCKS blocks (0.57 s), enough to show the stall: a free sweep
would be at +470 Hz by then, the stalled one stays within 100 Hz of zero.
StreamDemodulator(cfg, "cpu") and FleetDemodulator(cfg, 1, "cpu") over
those blocks are bitwise to the port's oracle on the port's FIR output with
no block replayed, and equal by decisions to the JAX package's oracle
(tests/torch_oracle_checks.py).
"""

import numpy as np
import pytest

import torch_oracle_checks as chk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.sim import synth_psk

CFG = DemodConfig(samplerate=230400)
N_BLOCKS = 16


@pytest.fixture(scope="module")
def dead_zone():
    """(samples, port oracle, JAX oracle), made once."""
    n = N_BLOCKS * CFG.block_len
    x, _ = synth_psk(int(20 * 72000), 230400, carrier_hz=-195.3,
                         amplitude=6000.0, snr_db=25.0, seed=40)
    x = chk.as_int16(x[:n])
    return (x, *chk.both_oracles(CFG, x))


def _stalled(st) -> None:
    hz = float(st["p_freq"]) * CFG.symrate / (2 * np.pi)
    assert st["locked_once"] == 0 and abs(hz) < 100.0, hz


def test_stream_driver_stalls_like_the_reference(dead_zone):
    x, mine, theirs = dead_zone
    got = chk.check_stream(CFG, x, mine, theirs)
    assert not got["locked_once"].any()
    _stalled(mine.all()[1])


def test_fleet_stalls_like_the_reference(dead_zone):
    x, mine, theirs = dead_zone
    got, = chk.check_fleet(CFG, x[None], [(mine, theirs)])
    assert not got["locked_once"].any()
    _stalled(mine.all()[1])
