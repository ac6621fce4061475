"""The port's turbo over a device list: one recording's lanes split over
2 "cpu" shards, against the one-device port and the JAX package's
mesh-sharded turbo (tests/test_turbo_mesh.py).

Lanes are independent within a pass and the boundary hand-off is the
host-side shift, so sharding must not change a bit: symbols, gauges and
passes equal the one-device run's. Against the JAX package's per-pass loop
on its 8-device chunk mesh (test_turbo_mesh.py:101-134) the contract is the
decision level: converged in O(1) passes, the same gauges, symbol count,
signs and locked_once.
"""

import jax
import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.turbo import demod_array_turbo as jax_turbo
from meteor_demod_tpu.demod.turbo import make_chunk_mesh
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.turbo import demod_array_turbo

L = 2048
CHUNKS, KB = 8, 8
MESH = ["cpu"] * 2


@pytest.fixture(scope="module")
def runs():
    """One 8-lane x 8-block recording (18 dB, 180 Hz) through the port on
    one device and on 2 shards, and through the JAX loop on 8 devices."""
    n = CHUNKS * KB * L
    x, _ = synth_psk(int(n * 72000 / 230400) + 64, 230400, carrier_hz=180.0,
                     amplitude=6000.0, snr_db=18.0, seed=52)
    x = x[:n]
    cfg = DemodConfig(samplerate=230400, block_len=L)
    one = demod_array_turbo(cfg, x, chunks=CHUNKS, max_passes=4,
                            device="cpu")
    two = demod_array_turbo(cfg, x, chunks=CHUNKS, max_passes=4, mesh=MESH)
    mp = pytest.MonkeyPatch()
    mp.setenv("METEOR_DEMOD_NO_FUSED", "1")        # the per-pass loop
    try:
        assert len(jax.devices()) == 8, "conftest must force 8 devices"
        ref = jax_turbo(JaxConfig(samplerate=230400, block_len=L), x,
                        chunks=CHUNKS, max_passes=4, mesh=make_chunk_mesh())
    finally:
        mp.undo()
    return cfg, x, one, two, ref


def test_mesh_turbo_equals_one_device(runs):
    _, _, one, two, _ = runs
    assert one.converged and two.converged
    assert two.passes == one.passes and not two.fell_back
    np.testing.assert_array_equal(two.gauges, one.gauges)
    for k in ("re", "im", "locked_once"):
        np.testing.assert_array_equal(two.symbols[k], one.symbols[k],
                                      err_msg=k)


def test_mesh_turbo_against_jax_mesh_loop(runs):
    _, _, _, two, ref = runs
    assert ref.converged and two.converged
    assert two.passes <= 3 and ref.passes <= 3
    np.testing.assert_array_equal(two.gauges, np.asarray(ref.gauges))
    assert len(two.symbols) == len(ref.symbols)
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(two.symbols[k]),
                                      np.sign(ref.symbols[k]), err_msg=k)
    np.testing.assert_array_equal(two.symbols["locked_once"],
                                  ref.symbols["locked_once"])


def test_mesh_turbo_auto_and_validation(runs, monkeypatch):
    cfg, x, one, _, _ = runs
    short = x[:CHUNKS * 2 * L]
    with pytest.raises(ValueError, match="divisible by mesh size 2"):
        demod_array_turbo(cfg, short, chunks=3, mesh=MESH)
    with pytest.raises(ValueError, match="not both"):
        demod_array_turbo(cfg, short, chunks=4, device="cpu", mesh=MESH)
    # "auto" with one device (the CPU here) runs on it, whatever chunks is.
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    a = demod_array_turbo(cfg, short, chunks=3, max_passes=2, mesh="auto")
    b = demod_array_turbo(cfg, short, chunks=3, max_passes=2, device="cpu")
    for k in ("re", "im", "locked_once"):
        np.testing.assert_array_equal(a.symbols[k], b.symbols[k])
