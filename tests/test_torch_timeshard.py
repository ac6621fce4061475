"""The port's time-sharded FIR (meteor_demod_tpu_torch/parallel/timeshard.py)
on "cpu" shards: N shards of one stream, each with its left neighbour's
last taps-1 samples as its delay line, equal to one FIR call bitwise
(tests/test_parallel.py::test_time_sharded_fir_matches_single_device), and
to the JAX package's make_sharded_fir on the 8-device mesh within the FIR
budget of tests/test_torch_fir.py (rtol=1e-5, atol=1e-5 * max|ref|).
"""

import jax
import numpy as np
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.parallel.timeshard import make_sharded_fir as jax_fir
from meteor_demod_tpu.parallel.timeshard import time_mesh as jax_time_mesh
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.dsp.fir import (iq_to_f32, make_fir_banks,
                                            polyphase_fir_block)
from meteor_demod_tpu_torch.parallel.timeshard import make_sharded_fir

BLOCK = 2048
N_DEV = 8                                  # the JAX mesh of tests/conftest.py
CFG = DemodConfig(samplerate=230400, block_len=BLOCK)


def _stream(seed=77, n=N_DEV * BLOCK) -> np.ndarray:
    x, _ = synth_psk(int(n * 72000 / 230400) + 64, 230400, carrier_hz=120.0,
                     amplitude=6000.0, snr_db=25.0, seed=seed)
    return iq_to_f32(x[:n])


def _one_call(x: np.ndarray) -> torch.Tensor:
    x = x[None] if x.ndim == 2 else x
    Ft, _ = polyphase_fir_block(
        torch.as_tensor(x), torch.zeros((x.shape[0], CFG.taps - 1, 2)),
        torch.as_tensor(make_fir_banks(CFG)))
    return Ft


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_time_shards_equal_one_call(n):
    x = _stream()
    parts = make_sharded_fir(CFG, ["cpu"] * n)(x)
    assert len(parts) == n
    assert all(p.shape == (len(x) // n * CFG.interp, 2, 1) for p in parts)
    assert torch.equal(torch.cat(parts), _one_call(x))


def test_time_shards_of_several_streams():
    """A batch of 3 streams split along time equals each stream alone."""
    xs = np.stack([_stream(seed) for seed in (1, 2, 3)])
    got = torch.cat(make_sharded_fir(CFG, ["cpu"] * 4)(xs))
    assert torch.equal(got, _one_call(xs))
    for b in range(3):
        assert torch.equal(got[:, :, b:b + 1], _one_call(xs[b]))


def test_time_shards_against_jax():
    assert len(jax.devices()) == N_DEV, "conftest must force 8 devices"
    x = _stream()
    mesh = jax_time_mesh()
    ref = np.asarray(jax_fir(JaxConfig(samplerate=230400, block_len=BLOCK),
                             mesh)(jax.device_put(
                                 x, jax.NamedSharding(mesh, jax.P("time")))))
    got = torch.cat(make_sharded_fir(CFG, ["cpu"] * N_DEV)(x))
    got = got[:, :, 0].numpy().reshape(ref.shape)       # (N, interp, 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(ref))))


def test_rejects_uneven_shards():
    fir = make_sharded_fir(CFG, ["cpu"] * 3)
    with pytest.raises(ValueError, match="equal time shards"):
        fir(_stream(n=1000))
    with pytest.raises(ValueError, match="delay line"):
        make_sharded_fir(CFG, ["cpu"] * 8)(_stream(n=8 * 16))
