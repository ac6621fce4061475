"""Moving carriers through the port's stream driver and fleet on the CPU:
the QPSK fixtures of tests/test_golden_reference.py without the C binary
(the OQPSK ramp is in tests/test_torch_doppler_oqpsk.py, so that each file
stays short on its worker).

- a QPSK ramp, 200 Hz + 800 Hz/s (golden :229);
- a LEO pass profile (sim.leo_doppler_hz, 820 km, 20x time-compressed):
  +155 -> -155 Hz through zero (golden :261).

Each is written as 16-bit samples, as the golden tests' WAV files are, and
goes through StreamDemodulator(cfg, "cpu") whole and through
FleetDemodulator(cfg, 2, "cpu") with both as rows, cut to their common
whole blocks. Both must be bitwise to the port's oracle block by block on the
port's FIR output, with no block replayed, and equal by decisions to the JAX
package's oracle, which is bitwise the port's on the same input
(tests/torch_oracle_checks.py). The stream must hold lock to the end.
"""

import numpy as np
import pytest

import torch_oracle_checks as chk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.sim import leo_doppler_hz, synth_psk

QPSK = DemodConfig(samplerate=230400)


def qpsk_ramp():
    x, _ = synth_psk(32000, 230400, carrier_hz=200.0, carrier_ramp_hz_s=800.0,
                     amplitude=6000.0, snr_db=20.0, seed=21)
    return chk.as_int16(x)


def leo_pass():
    x0, _ = synth_psk(36000, 230400, carrier_hz=0.0, amplitude=6000.0,
                      snr_db=20.0, seed=23)
    prof = leo_doppler_hz(len(x0), 230400, t_ca_s=len(x0) / 230400 / 2,
                          time_scale=20.0)
    assert prof[0] > 150.0 and prof[-1] < -150.0
    x, _ = synth_psk(36000, 230400, carrier_hz=0.0, amplitude=6000.0,
                     snr_db=20.0, seed=23, carrier_profile=prof)
    return chk.as_int16(x)


FIXTURES = {"qpsk_ramp": qpsk_ramp, "leo_pass": leo_pass}


@pytest.fixture(scope="module")
def fixtures():
    """name -> (samples, port oracle, JAX oracle), made once."""
    out = {}
    for name, make in FIXTURES.items():
        x = make()
        out[name] = (x, *chk.both_oracles(QPSK, x))
    return out


@pytest.mark.parametrize("name", list(FIXTURES))
def test_stream_driver_tracks_the_carrier_bitwise(fixtures, name):
    x, mine, theirs = fixtures[name]
    got = chk.check_stream(QPSK, x, mine, theirs)
    _, st = mine.all()
    assert st["locked"] == 1, "lost lock before the end"
    assert got["locked_once"].mean() > 0.5


def test_fleet_tracks_the_carriers_bitwise(fixtures):
    names = list(FIXTURES)
    L = QPSK.block_len
    T = min(len(fixtures[n][0]) for n in names) // L * L
    rows = np.stack([fixtures[n][0][:T] for n in names])
    got = chk.check_fleet(QPSK, rows, [fixtures[n][1:] for n in names])
    for s in got:
        assert s["locked_once"][-1] == 1
