"""The port's turbo and span turbo on OQPSK, on the CPU
(meteor_demod_tpu_torch/demod/turbo.py), at the production ratio 230.4 ksps /
80 ksym/s (2.88 samples a symbol).

OQPSK's gauge group couples the Costas quadrant with the I/Q labeling of the
half-symbol fire grid: a lane with an odd cumulative gauge calls gauge-0 Q
instants "I", and assembly re-pairs the global half-value stream
(_assemble_oqpsk_gauge); a span's accepted prefix shrinks to an even-gauge
boundary.

Contracts, as in tests/test_torch_turbo.py: against the port's own
sequential stream with strict=True, symbol count, locked_once and the sign of
every component equal on every symbol; against the JAX package's
demod_array_turbo (scan backend), the same count, converged, passes, gauges
mod 4, locked_once and signs, int8 values with mean |difference| < 2.

Seed 33 at 120 Hz, 18 dB (the first fixture tried at this ratio) converges in
3 passes with gauges [0 2 1 1] in both packages: odd gauges, an odd-parity
boundary and a tail in an odd gauge.
"""

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import turbo as jturbo
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   demod_array, quantize)

L = 2048
CHUNKS, KB = 4, 8
CFG = dict(samplerate=230400, symrate=80000.0, oqpsk=True, block_len=L)


def _signal(cfg, n, seed, carrier_hz, snr_db=18.0):
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=True,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=snr_db,
                     seed=seed)
    return x[:n]


def _same_decisions(got, ref, bytes_only=False):
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    view = (lambda v: quantize(v)) if bytes_only else (lambda v: v)
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(view(got[k])),
                                      np.sign(view(ref[k])))


@pytest.fixture(scope="module")
def recording():
    cfg = DemodConfig(**CFG)
    x = _signal(cfg, CHUNKS * KB * L + 3000, seed=33, carrier_hz=120.0)
    seq = demod_array(cfg, x, "cpu")
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    return cfg, x, seq, res


def test_turbo_gauge_oqpsk(recording):
    """The coupled quadrant x half-symbol gauge resolves in O(1) passes;
    assembly re-pairs the half-value stream with its insert/drop stitches,
    through the tail demodulated in the last lane's (odd) gauge."""
    cfg, x, seq, res = recording
    assert res.converged, res.max_residual
    assert res.passes <= 3 and not res.fell_back
    assert np.any(res.gauges % 2) and np.any(np.diff(res.gauges) % 2)
    _same_decisions(res.symbols, seq)


def test_turbo_oqpsk_matches_jax_turbo(recording):
    cfg, x, _, res = recording
    ref = jturbo.demod_array_turbo(JaxConfig(**CFG), x, chunks=CHUNKS,
                                   backend="scan", strict=True)
    assert (res.converged, res.passes, res.fell_back) == (
        ref.converged, ref.passes, ref.fell_back)
    np.testing.assert_array_equal(res.gauges % 4, np.asarray(ref.gauges) % 4)
    _same_decisions(res.symbols, ref.symbols)
    for k in ("re", "im"):
        mad = np.mean(np.abs(quantize(res.symbols[k])
                             - quantize(ref.symbols[k])))
        assert mad < 2.0, (k, mad)


def test_turbo_oqpsk_symbols_mode():
    """"symbols" mode: the dual-slot state machine's parity is part of the
    carry, so the plain fixpoint handles it like any other loop state; with
    chunks+1 passes the carries are exact and so is every value."""
    cfg = DemodConfig(**CFG)
    x = _signal(cfg, CHUNKS * 2 * L, seed=23, carrier_hz=120.0, snr_db=22.0)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=CHUNKS + 1, converge="symbols")
    assert res.converged and res.gauges is None
    seq = demod_array(cfg, x, "cpu")
    _same_decisions(res.symbols, seq)
    np.testing.assert_array_equal(quantize(res.symbols["im"]),
                                  quantize(seq["im"]))


def test_turbo_strict_bounded_fallback_oqpsk(recording, monkeypatch):
    """The bounded strict fallback through the OQPSK assembly: the suffix is
    demodulated in the prefix-exit lane's own gauge (odd here, carry
    untouched) and joins the global re-pairing as the tail stream."""
    cfg, x, seq, res0 = recording
    P, chunk_len = 3, KB * L
    assert res0.gauges[P - 1] % 2 == 1
    real = turbo.gauge_fixpoint

    def poisoned(*a, **k):
        f_np, outs, K, passes, conv, resid, _, stats = real(*a, **k)
        assert conv, "the fixture must converge before poisoning"
        ok = np.ones(CHUNKS, bool)
        ok[P:] = False
        return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats

    monkeypatch.setattr(turbo, "gauge_fixpoint", poisoned)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    assert res.fell_back and not res.converged
    assert res.fallback_samples == len(x) - P * chunk_len
    _same_decisions(res.symbols, seq)


def test_span_stream_oqpsk_matches_sequential():
    """OQPSK span streaming (2 lanes x 8 blocks): the accepted prefix
    shrinks to an even-gauge boundary so the exit carry rotates by pure sign
    flips; unconsumed lanes stay buffered for the next span or the drain at
    finish(). Half-symbol pairing and hand-off give the sequential stream's
    soft-byte signs and lock history."""
    cfg = DemodConfig(**CFG)
    C = 2
    span_n = C * KB * L
    x = _signal(cfg, span_n + 4 * L + 501, seed=29, carrier_hz=60.0)
    seq = demod_array(cfg, x, "cpu")
    d = StreamDemodulator(cfg, "cpu", span_turbo=True, span_chunks=C,
                          span_blocks=KB)
    out = [d.process(x[:span_n])]
    pos = span_n
    rng = np.random.default_rng(1)
    while pos < len(x):
        m = int(rng.integers(3000, 6000))
        out.append(d.process(x[pos:pos + m]))
        pos += m
    out.append(d.finish())
    assert d.spans_run >= 1
    assert seq["locked_once"][-1] == 1
    _same_decisions(np.concatenate(out), seq, bytes_only=True)
