"""An OQPSK carrier ramp through the port's stream driver and fleet on the
CPU: tests/test_golden_reference.py:246's fixture without the C binary,
240 ksps / 80 ksym/s, 150 Hz + 400 Hz/s, written as 16-bit samples.

As tests/test_torch_doppler.py holds the QPSK fixtures: StreamDemodulator
(cfg, "cpu") and FleetDemodulator(cfg, 1, "cpu") over its whole blocks, both
bitwise to the port's oracle block by block on the port's FIR output with no
block replayed, and equal by decisions to the JAX package's oracle
(tests/torch_oracle_checks.py). The paired I/Q fire and the block-entry
pre-fire run on a moving carrier.
"""

import pytest

import torch_oracle_checks as chk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.sim import synth_psk

OQPSK = DemodConfig(samplerate=240000, symrate=80000.0, oqpsk=True)


@pytest.fixture(scope="module")
def ramp():
    """(samples, port oracle, JAX oracle), made once."""
    x, _ = synth_psk(36000, 240000, symrate=80000.0, oqpsk=True,
                     carrier_hz=150.0, carrier_ramp_hz_s=400.0,
                     amplitude=6000.0, snr_db=20.0, seed=22)
    x = chk.as_int16(x)
    return (x, *chk.both_oracles(OQPSK, x))


def test_stream_driver_tracks_the_ramp_bitwise(ramp):
    x, mine, theirs = ramp
    got = chk.check_stream(OQPSK, x, mine, theirs)
    _, st = mine.all()
    assert st["locked"] == 1, "lost lock before the end"
    assert got["locked_once"].mean() > 0.5


def test_fleet_tracks_the_ramp_bitwise(ramp):
    x, mine, theirs = ramp
    T = len(x) // OQPSK.block_len * OQPSK.block_len
    got, = chk.check_fleet(OQPSK, x[None, :T], [(mine, theirs)])
    assert got["locked_once"][-1] == 1
