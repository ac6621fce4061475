"""A negative carrier through the port's stream driver and fleet on the
CPU: tests/test_golden_reference.py:288's fixture without the C binary.

-350 Hz, 20 dB, 130000 symbols, with the carrier band cut to +-500 Hz (CLI
-d 500), written as 16-bit samples. The acquisition sweep walks up first
(pll.c:126-128), turns at +500 Hz after ~0.6 s and comes down to -350 Hz,
locking at symbol 105032 of 129999 (~1.5 s). StreamDemodulator(cfg, "cpu")
runs the whole fixture; FleetDemodulator(cfg, 1, "cpu") runs its last
LAST_BLOCKS whole blocks, the end of the downward sweep and the lock, from
the oracle's carry before them (from the first block the fleet would double
this file's time on blocks of the sweep the stream driver already holds).
Both must be bitwise to the port's oracle block by block on the port's FIR
output with no block replayed, and equal by decisions to the JAX package's
oracle (tests/torch_oracle_checks.py). On its own numpy FIR the JAX oracle
gives other signs to 725 of the unlocked symbols here, the first at 36643,
and the same lock instant and locked symbols (ROADMAP list C). The
near-zero dead zone of golden :330 is in tests/test_torch_dead_zone.py.
"""

import numpy as np
import pytest

import torch_oracle_checks as chk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.pipeline import scalar_state_to_numpy_carry
from meteor_demod_tpu_torch.demod.state import carry_from_numpy
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.sim import synth_psk

CFG = DemodConfig(samplerate=230400, freq_max=500 * 2 * np.pi / 72000.0)
LAST_BLOCKS = 10
# The JAX oracle fed the port's FIR output is held bitwise to the port's on
# the first SAME_INPUT_BLOCKS blocks (the other files hold it throughout).
SAME_INPUT_BLOCKS = 8


@pytest.fixture(scope="module")
def sweep_wrap():
    """(samples, port oracle, JAX oracle), made once."""
    x, _ = synth_psk(130000, 230400, carrier_hz=-350.0, amplitude=6000.0,
                         snr_db=20.0, seed=61)
    x = chk.as_int16(x)
    return (x, *chk.both_oracles(CFG, x, SAME_INPUT_BLOCKS))


def _hz(p_freq) -> float:
    return float(p_freq) * CFG.symrate / (2 * np.pi)


def test_stream_driver_locks_after_the_wrap_bitwise(sweep_wrap):
    x, mine, theirs = sweep_wrap
    got = chk.check_stream(CFG, x, mine, theirs)
    _, st = mine.all()
    # The sweep turned at +fmax (updown -1) and locked near -350 Hz, late:
    # most of the fixture is pre-lock.
    assert st["locked"] == 1 and float(st["updown"]) == -1.0
    assert abs(_hz(st["p_freq"]) + 350.0) < 30.0, _hz(st["p_freq"])
    first = int(np.argmax(got["locked_once"]))
    assert got["locked_once"][first] == 1 and first > 0.6 * len(got)


def test_fleet_through_the_wrap_bitwise(sweep_wrap):
    x, mine, theirs = sweep_wrap
    L = CFG.block_len
    n_blocks = len(x) // L
    b0 = n_blocks - LAST_BLOCKS
    _, st0 = mine.upto(b0)
    # Past the turn, not yet locked.
    assert float(st0["updown"]) == -1.0 and st0["locked_once"] == 0
    fleet = FleetDemodulator(CFG, 1, device="cpu")
    fleet.carry = carry_from_numpy(
        {k: np.asarray(v)[None] for k, v in
         scalar_state_to_numpy_carry(CFG, st0).items()}, "cpu")
    got, = chk.check_fleet(CFG, x[None, b0 * L:n_blocks * L],
                           [(chk.Oracle(mine.parts[b0:], mine.states[b0:]),
                             chk.Oracle(theirs.parts[b0:],
                                        theirs.states[b0:]))],
                           fleet=fleet)
    assert got["locked_once"][-1] == 1
