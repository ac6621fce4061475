"""The port's batched tick-major FIR (meteor_demod_tpu_torch/dsp/fir.py)
against the JAX package's FIR and the direct numpy dot products.

Tolerance: both sides are float32 correlations summed in different orders,
so they agree to about 1e-5 relative to the signal scale
(meteor_demod_tpu/dsp/fir.py:59-60 sets the budget)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.dsp.fir import (fir_reference_np, make_fir_banks,
                                      polyphase_fir_block,
                                      polyphase_fir_block_tmajor)

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.dsp import fir as port_fir
from meteor_demod_tpu_torch.dsp.fir import f32_to_iq, iq_to_f32

B = 3
RTOL = 1e-5

CONFIGS = {"qpsk": dict(samplerate=230400, block_len=1024),
           "hifi": dict(samplerate=230400, block_len=1024, rrc_order=64,
                        interp=10)}


def _rand_iq(shape, seed, scale=1000.0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _port_fir(x, tail, banks):
    """x (B, L) complex64, tail (B, taps-1) complex64 -> Ft (T, 2, B),
    new tail (B, taps-1) complex64."""
    Ft, new_tail = port_fir.polyphase_fir_block(
        torch.from_numpy(iq_to_f32(x)), torch.from_numpy(iq_to_f32(tail)),
        torch.from_numpy(banks))
    return Ft.numpy(), f32_to_iq(new_tail.numpy())


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fir_matches_jax_tmajor(name):
    cfg = DemodConfig(**CONFIGS[name])
    banks = port_fir.make_fir_banks(cfg)
    L, taps = cfg.block_len, cfg.taps
    x = _rand_iq((B, L), seed=1)
    tail = _rand_iq((B, taps - 1), seed=2)
    Ft, new_tail = _port_fir(x, tail, banks)
    jFt, jtail = polyphase_fir_block_tmajor(
        jnp.asarray(iq_to_f32(x).transpose(1, 0, 2)),
        jnp.asarray(iq_to_f32(tail).transpose(1, 0, 2)),
        make_fir_banks(JaxConfig(**CONFIGS[name])))
    assert Ft.shape == (L * cfg.interp, 2, B) and Ft.dtype == np.float32
    _close(Ft, np.asarray(jFt))
    np.testing.assert_array_equal(
        new_tail, f32_to_iq(np.asarray(jtail).transpose(1, 0, 2)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fir_tick_major_layout_matches_reference(name):
    """Ft[s*interp + p, :, b] is stream b's phase-p output after sample s."""
    cfg = DemodConfig(**CONFIGS[name])
    banks = port_fir.make_fir_banks(cfg)
    L = 512
    x = _rand_iq((B, L), seed=3)
    tail = _rand_iq((B, cfg.taps - 1), seed=4)
    Ft, _ = _port_fir(x, tail, banks)
    for b in range(B):
        ref = fir_reference_np(x[b], tail[b], banks)          # (L, interp)
        got = f32_to_iq(np.ascontiguousarray(Ft[:, :, b])).reshape(
            L, cfg.interp)
        _close(got, ref)
        jF, _ = polyphase_fir_block(jnp.asarray(iq_to_f32(x[b])),
                                    jnp.asarray(iq_to_f32(tail[b])), banks)
        _close(got, f32_to_iq(np.asarray(jF)))


def test_fir_three_chained_blocks_equal_one_long_block():
    cfg = DemodConfig(**CONFIGS["qpsk"])
    banks = port_fir.make_fir_banks(cfg)
    L, taps = cfg.block_len, cfg.taps
    x = _rand_iq((B, 3 * L), seed=5)
    tail = np.zeros((B, taps - 1), np.complex64)
    F_long, tail_long = _port_fir(x, tail, banks)
    parts = []
    for i in range(3):
        F, tail = _port_fir(x[:, i * L:(i + 1) * L], tail, banks)
        parts.append(F)
    F_chain = np.concatenate(parts)
    assert F_chain.shape == F_long.shape
    _close(F_chain, F_long)
    np.testing.assert_array_equal(tail, tail_long)
    np.testing.assert_array_equal(tail, x[:, -(taps - 1):])
