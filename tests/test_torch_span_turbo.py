"""The port's span turbo on the CPU: StreamDemodulator(span_turbo=True) and
turbo.span_submit / span_finish / demod_span_turbo
(meteor_demod_tpu_torch/demod/turbo.py, demod/pipeline.py).

A span continues an ongoing stream from its EXACT carry: lane 0 is the
stream state, warmup and gauge resolution align the other lanes, and the
strict-turbo acceptance (verified lane prefix) makes the emitted decisions
final; anything unverified is left to the sequential path.

Contracts. Against the port's own sequential stream: the same symbol count,
locked_once and the sign of every soft byte, on every symbol (span symbols
are 2x their int8 byte, so values are not compared). Against the JAX
package's demod_span_turbo (scan backend) from the same mid-stream carry,
brought over with carry_from_numpy's layout: the same consumed,
verified_lanes, converged, passes and signs.

Spans are 2 lanes x 8 blocks of 2048 samples: a pass costs the same on the
CPU whatever the lane count, the sequential reference costs lanes x blocks.
One sequential run of the longest input is shared; shorter inputs that end
on a block boundary are its prefixes (the stream is invariant to how it is
fed, tests/test_torch_pipeline_cli.py test_chunk_invariance). Seed 11 at
60 Hz, 18 dB locks at symbol ~2700 (300 Hz, tried first, needs ~40 blocks).
"""

import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import turbo as jturbo
from meteor_demod_tpu.demod.pipeline import StreamDemodulator as JaxDemod
from meteor_demod_tpu.demod.pipeline import egress
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   demod_array, quantize)
from meteor_demod_tpu_torch.demod.state import CARRY_FIELDS, carry_to_numpy
from meteor_demod_tpu_torch.dsp.fir import iq_to_f32
from meteor_demod_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)

L = 2048
C, KB = 2, 8
SPAN = C * KB * L
HEAD = 8 * L           # sequential blocks before a mid-stream span: locked
CFG = dict(samplerate=230400, block_len=L, symrate=72000.0)


def _same_decisions(got, ref):
    """Count, locked_once, and the sign of every soft BYTE: a span's symbols
    are 2x their int8 byte, so a component below 2 in magnitude (a byte of
    0, seen while the AGC settles) has no sign to compare."""
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    for k in ("re", "im"):
        np.testing.assert_array_equal(np.sign(quantize(got[k])),
                                      np.sign(quantize(ref[k])))


def _span_demod(cfg, **kw):
    return StreamDemodulator(cfg, "cpu", span_turbo=True, span_chunks=C,
                             span_blocks=KB, **kw)


@pytest.fixture(scope="module")
def stream():
    """Two spans, three blocks and a 777-sample tail of QPSK from cold; its
    sequential demodulation, fed block by block so that the symbol count
    after every whole block is known; and that count per block."""
    cfg = DemodConfig(**CFG)
    n = 2 * SPAN + 3 * L + 777
    x, _ = synth_psk(int(n / cfg.osf) + 64, cfg.samplerate,
                     symrate=cfg.symrate, carrier_hz=60.0, amplitude=6000.0,
                     snr_db=18.0, seed=11)
    x = x[:n]
    d = StreamDemodulator(cfg, "cpu")
    parts, after = [], [0]
    for at in range(0, n - L + 1, L):
        parts.append(d.process(x[at:at + L]))
        d.sync()
        parts += d._backlog
        d._backlog = []
        after.append(sum(len(p) for p in parts))
    parts += [d.process(x[n - n % L:]), d.finish()]
    return cfg, x, np.concatenate(parts), after


def _prefix(stream, n):
    """The sequential symbols of x[:n], n a whole number of blocks."""
    _, _, seq, after = stream
    assert n % L == 0
    return seq[:after[n // L]]


def test_span_stream_matches_sequential(stream):
    """Span mode fed in arbitrary pieces emits the sequential stream's
    decisions: spans, the drain at finish() and the oracle tail interleave.
    Cold start included: the first span's lane 0 entry is the cold initial
    state, and the lane holding the lock edge runs from an exact entry."""
    cfg, x, seq, _ = stream
    d = _span_demod(cfg)
    out, pos = [], 0
    rng = np.random.default_rng(0)
    while pos < len(x):
        m = int(rng.integers(5000, 50000))
        out.append(d.process(x[pos:pos + m]))
        pos += m
    out.append(d.finish())
    out = np.concatenate(out)
    assert d.spans_run >= 2 and d.span_fallbacks == 0
    assert d.symbols_out == len(out)
    _same_decisions(out, seq)


def test_span_stdin_sized_chunks_run_spans(stream):
    """Feeding at the CLI's stdin granularity (8192 samples a read, far
    below a span) still accumulates and runs spans: span mode BUFFERS
    sub-span input instead of draining it through the sequential paths, so
    nothing is emitted before the first span ran."""
    cfg, x, seq, _ = stream
    n = SPAN + 3 * L
    d = _span_demod(cfg)
    out, before_first = [], None
    for pos in range(0, n, 8192):
        out.append(d.process(x[pos:min(pos + 8192, n)]))
        if before_first is None and d.spans_run:
            before_first = sum(len(o) for o in out[:-1])
    out.append(d.finish())
    assert d.spans_run >= 1 and d.span_fallbacks == 0
    assert before_first == 0
    _same_decisions(np.concatenate(out), _prefix(stream, n))


def test_span_turbo_exit_carry_continues_stream(stream):
    """The exit carry of demod_span_turbo (rotated into the emitted gauge)
    continues the stream: the suffix demodulated sequentially from it joins
    on to the sequential stream's decisions."""
    cfg, x, seq, _ = stream
    d = StreamDemodulator(cfg, "cpu")
    head = [d.process(x[:HEAD])]
    d.sync()
    head += d._backlog
    assert d.pll_locked
    carry0 = {k: v[0] for k, v in carry_to_numpy(d._carry).items()}
    res = turbo.demod_span_turbo(cfg, carry0, iq_to_f32(x[HEAD:HEAD + SPAN]),
                                 chunks=C, device="cpu")
    assert res.converged and res.verified_lanes == C and res.passes <= 3
    assert res.consumed == SPAN
    assert int(res.exit_carry["tick"]) == 0 == int(res.exit_carry["flags"])
    d2 = StreamDemodulator(cfg, "cpu")
    d2.set_carry(res.exit_carry)
    assert d2.pll_locked
    tail = [d2.process(x[HEAD + SPAN:]), d2.finish()]
    _same_decisions(np.concatenate(head + [res.symbols] + tail), seq)
    # Span symbols went through the int8 quantizer: even integers.
    assert np.all(res.symbols["re"] % 2 == 0)


def test_span_turbo_matches_jax_span_turbo(stream):
    """A mid-stream span from the JAX stream's carry, through both
    packages' demod_span_turbo."""
    cfg, x, _, _ = stream
    jcfg = JaxConfig(**CFG)
    jd = JaxDemod(jcfg, backend="scan")
    jd.process(x[:HEAD])
    jd.sync()
    jcarry = egress(jd._carry)
    span = iq_to_f32(x[HEAD:HEAD + SPAN])
    ref = jturbo.demod_span_turbo(jcfg, jcarry, span, chunks=C,
                                  backend="scan")
    carry0 = {k: np.asarray(getattr(jcarry, k)) for k in CARRY_FIELDS}
    got = turbo.demod_span_turbo(cfg, carry0, span, chunks=C, device="cpu")
    assert (got.consumed, got.verified_lanes, got.converged, got.passes) == (
        ref.consumed, ref.verified_lanes, ref.converged, ref.passes)
    assert got.consumed == SPAN
    _same_decisions(got.symbols, ref.symbols)
    for k in ("locked", "locked_once", "slot"):
        assert int(got.exit_carry[k]) == int(getattr(ref.exit_carry, k)), k


@pytest.mark.parametrize("P", [1, 0])
def test_span_unverified_lanes_fall_back(stream, monkeypatch, P):
    """A span whose verdict fails from lane P on consumes only the verified
    prefix; the stream demodulates the rest through its sequential path and
    the whole output still has the sequential decisions. P == 0: nothing is
    consumed, the fallback is counted, and the output IS the sequential
    stream's, value for value. (Spans of 2 x 2 blocks: the verdict is
    forced, and lane 0's entry is exact whatever the fixpoint did.)"""
    cfg, x, seq, _ = stream
    n = C * 2 * L + (L if P else 0)
    real = turbo.gauge_fixpoint

    def poisoned(*a, **k):
        f_np, outs, K, passes, conv, resid, _, stats = real(*a, **k)
        ok = np.zeros(C, bool)
        ok[:P] = True
        return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats

    monkeypatch.setattr(turbo, "gauge_fixpoint", poisoned)
    d = StreamDemodulator(cfg, "cpu", span_turbo=True, span_chunks=C,
                          span_blocks=2)
    out = np.concatenate([d.process(x[:n]), d.finish()])
    assert d.spans_run == 1 and d.span_fallbacks == (0 if P else 1)
    ref = _prefix(stream, n)
    if P:
        _same_decisions(out, ref)
    else:
        np.testing.assert_array_equal(out, ref)


def test_span_noise_only_stream_never_claims_lock():
    """Pure noise through span mode: the span verifies honestly or falls
    back to the sequential path; no lock is claimed either way, and the
    symbol count stays near the free-running gate's nominal rate."""
    cfg = DemodConfig(**CFG)
    n = C * 2 * L + 3 * L
    rng = np.random.default_rng(7)
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
         .astype(np.complex64) * 900.0)
    d = StreamDemodulator(cfg, "cpu", span_turbo=True, span_chunks=C,
                          span_blocks=2)
    out = np.concatenate([d.process(x), d.finish()])
    assert d.spans_run == 1
    assert not out["locked_once"].any() and not d.pll_locked_once
    nominal = n / cfg.osf
    assert abs(len(out) - nominal) < 0.05 * nominal + 64


def test_span_stream_checkpoint_round_trips_pending(stream, tmp_path):
    """A span-mode stream holds less than a span in its buffers; the stream
    checkpoint saves them and the loaded stream finishes the input as the
    sequential stream does. No sweep kick happens in span mode."""
    cfg, x, seq, _ = stream
    n = 3 * L + 100
    d = _span_demod(cfg, sweep_rescue_s=0.001)
    assert len(d.process(x[:2 * L])) == 0 and len(d.process(x[2 * L:n])) == 0
    assert d.spans_run == 0 and d._rescue_pending_samples == 0
    path = str(tmp_path / "span.ckpt")
    save_checkpoint(path, d)
    resumed = load_checkpoint(path, "cpu")
    np.testing.assert_array_equal(resumed._pending, x[:n])
    got = resumed.finish()
    np.testing.assert_array_equal(got, d.finish())
    np.testing.assert_array_equal(got, demod_array(cfg, x[:n], "cpu"))


def test_span_submit_refuses_bad_lengths():
    cfg = DemodConfig(**CFG)
    carry0 = {k: v[0] for k, v in carry_to_numpy(
        StreamDemodulator(cfg, "cpu")._carry).items()}
    for n in (C * L, C * 2 * L + 5):       # kb < 2; not a whole span
        with pytest.raises(ValueError, match="span length"):
            turbo.span_submit(cfg, carry0, np.zeros((n, 2), np.float32),
                              chunks=C, device="cpu")
