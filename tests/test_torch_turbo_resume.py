"""Strict turbo's resume rounds (meteor_demod_tpu_torch/demod/turbo.py
_resume_rounds) on the CPU: after a non-converged fixpoint's verified
prefix of P lanes, the same gauge fixpoint runs again over lanes P..C-1
from lane P-1's exit carry, while a round costs fewer launches than the
sequential path would; what no round accepts goes sequential.

Contract: decision-exact against the port's own sequential stream
(demod_array): symbol count, locked_once and the sign of every component,
on every symbol, with or without rounds. The counters turbo.resumes and
turbo.resumed_samples count the rounds and the samples of the lanes they
accepted; TurboResult.fallback_samples and turbo.sequential_samples count
what the sequential path demodulated.

Fixture: 8 lanes x 4 blocks of 2048 samples of QPSK plus a 3000-sample
tail (seed 31, 150 Hz, 18 dB); its strict run converges in 4 passes with
gauges [0 0 -1 -4 -3 -5 -8 -7]. Each test replays that run's warm-up and
first fixpoint with its verdict cut at lane P, so only the rounds and the
sequential rest run anew. Here a round costs at most 4 passes x 4 = 16
launches, so it runs over 5 lanes or more (P <= 3) and not over 4 (P = 4).
"""

import numpy as np
import pytest
import torch

from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch import profiling
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.demod.pipeline import (_SYM_DTYPE, demod_array,
                                                   quantize)
from meteor_demod_tpu_torch.demod.state import batch_carry_np

L = 2048
CHUNKS, KB = 8, 4
CHUNK_LEN = KB * L


def _signal(cfg, n, seed, carrier_hz, snr_db=18.0):
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=snr_db,
                     seed=seed)
    return x[:n]


def _same_decisions(got, ref):
    """The strict contract: count, locked_once and every sign."""
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    np.testing.assert_array_equal(np.sign(got["re"]), np.sign(ref["re"]))
    np.testing.assert_array_equal(np.sign(got["im"]), np.sign(ref["im"]))


def _counted(fn):
    """fn() and the changes of the profiling counters over it."""
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: v - before.get(k, 0) for k, v in after.items()}


@pytest.fixture(scope="module")
def recording():
    """The recording, its sequential demodulation, and the strict run's
    warm-up and first fixpoint (run_warmup's and gauge_fixpoint's
    returns)."""
    cfg = DemodConfig(samplerate=230400, block_len=L)
    x = _signal(cfg, CHUNKS * KB * L + 3000, seed=31, carrier_hz=150.0)
    first = []

    def keep(real):
        def call(*a, **k):
            first.append(real(*a, **k))
            return first[-1]
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(turbo, "run_warmup", keep(turbo.run_warmup))
        mp.setattr(turbo, "gauge_fixpoint", keep(turbo.gauge_fixpoint))
        res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                      strict=True)
    assert res.converged and len(first) == 2, "the fixture must converge"
    assert not np.any(res.gauges[:2] % 4) and res.gauges[2] % 2 == 1
    return cfg, x, demod_array(cfg, x, "cpu"), first


def _replay(mp, first, P: int, rounds=None):
    """Make the next demod_array_turbo's warm-up and first fixpoint those of
    `first`, the fixpoint's verdict cut at lane P (not converged, lanes P..
    unverified). The rounds' fixpoints run, or with `rounds` (a list of
    gauge_fixpoint returns) are replayed from it in turn. Returns the
    record of the rounds' fixpoints."""
    w_np, (f_np, outs, K, passes, _, resid, _, stats) = first
    real = turbo.gauge_fixpoint
    seen = {"rounds": []}

    def fixpoint(*a, **k):
        if "first" not in seen:
            seen["first"] = True
            ok = np.arange(CHUNKS) < P
            return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats
        got = real(*a, **k) if rounds is None else rounds[len(seen["rounds"])]
        seen["rounds"].append(got)
        return got

    mp.setattr(turbo, "run_warmup", lambda *a, **k: w_np)
    mp.setattr(turbo, "gauge_fixpoint", fixpoint)
    return seen


def _stub_sequential(mp):
    """Replace the sequential path by a record of what it was handed: no
    symbols, the carry it was given back."""
    fed = []

    def sequential(cfg, device, leaves, xf):
        fed.append(np.array(xf))
        return np.zeros(0, dtype=_SYM_DTYPE), leaves

    mp.setattr(turbo, "_sequential_from", sequential)
    return fed


@pytest.fixture(scope="module")
def resumed_at_odd_gauge(recording):
    """The strict run cut at P = 3, whose exit gauge K[2] = -1 is odd: one
    round over lanes 3-7."""
    cfg, x, seq, first = recording
    with pytest.MonkeyPatch.context() as mp:
        seen = _replay(mp, first, 3)
        res, d = _counted(lambda: turbo.demod_array_turbo(
            cfg, x, chunks=CHUNKS, device="cpu", strict=True))
    return res, d, seen


def test_round_resumes_the_fixpoint_after_the_prefix(recording,
                                                     resumed_at_odd_gauge):
    """(a) One round over the 5 unverified lanes: the sequential path gets
    less than the suffix after the prefix, and every decision is the
    sequential stream's. The result's passes, converged and gauges stay
    the first fixpoint's."""
    cfg, x, seq, first = recording
    res, d, seen = resumed_at_odd_gauge
    P, n = 3, len(x)
    assert len(seen["rounds"]) == 1 and d["turbo.resumes"] == 1
    assert 0 < d["turbo.resumed_samples"] <= (CHUNKS - P) * CHUNK_LEN
    assert d["turbo.resumed_samples"] % CHUNK_LEN == 0
    assert res.fell_back and not res.converged and res.passes == first[1][3]
    np.testing.assert_array_equal(res.gauges, first[1][2])
    assert res.fallback_samples < n - P * CHUNK_LEN
    assert res.fallback_samples == (n - P * CHUNK_LEN
                                    - d["turbo.resumed_samples"])
    assert d["turbo.sequential_samples"] == res.fallback_samples
    _same_decisions(res.symbols, seq)


def test_round_continues_an_odd_gauge_exit(recording, resumed_at_odd_gauge):
    """(b) The prefix's exit gauge is odd, so the round's lane 0 enters
    from a carry rotated by a quarter turn, its t_prev the last emitted
    symbol's Q: no symbol is lost, doubled or turned at the boundary
    (decisions and locked_once near it equal the sequential stream's, and
    the soft values within 4 quanta in the mean, the bound of a converged
    run)."""
    cfg, x, seq, first = recording
    res, _, _ = resumed_at_odd_gauge
    assert first[1][2][2] % 2 == 1
    assert len(res.symbols) == len(seq)
    # The boundary's symbol index: what the prefix lanes emitted.
    at = int(first[1][1].valid[:3].sum())
    got, ref = res.symbols[at - 64:at + 64], seq[at - 64:at + 64]
    _same_decisions(got, ref)
    for c in ("re", "im"):
        mad = np.mean(np.abs(quantize(got[c]) - quantize(ref[c])))
        assert mad < 4.0, (c, mad)


def test_round_that_does_not_pay_runs_none(recording, monkeypatch):
    """(c) 4 unverified lanes cost 16 sequential launches, no more than a
    round's 16: no round, and the sequential path gets the whole suffix
    after the prefix, as before rounds existed. At C = 4 no round can pay
    whatever the prefix: _resume_rounds hands the prefix back untouched."""
    cfg, x, seq, first = recording
    P, n = 4, len(x)
    seen = _replay(monkeypatch, first, P)
    fed = _stub_sequential(monkeypatch)
    res, d = _counted(lambda: turbo.demod_array_turbo(
        cfg, x, chunks=CHUNKS, device="cpu", strict=True))
    assert not seen["rounds"] and d["turbo.resumes"] == 0
    assert d.get("turbo.resumed_samples", 0) == 0
    assert res.fell_back and res.fallback_samples == n - P * CHUNK_LEN
    assert [len(f) for f in fed] == [n - P * CHUNK_LEN]
    np.testing.assert_array_equal(
        fed[0], turbo._as_f32_pairs(x)[P * CHUNK_LEN:])
    carry = {k: v[0] for k, v in batch_carry_np(cfg, 1).items()}
    blocks = torch.zeros(4, CHUNK_LEN, 2)
    for P4 in (1, 2, 3):
        out, d4 = _counted(lambda: turbo._resume_rounds(
            cfg, blocks, None, P4, carry, [], (None,) * 4, 4))
        assert out[0] == P4 and out[1] is carry
        assert d4.get("turbo.resumes", 0) == 0


def test_flag_in_a_round_ends_its_accepted_prefix(recording,
                                                  resumed_at_odd_gauge,
                                                  monkeypatch):
    """(d) The round of (a), which accepts all of lanes 3-7, replayed with a
    safety flag on lane 7's exit: the round accepts lanes 3-6 alone, and
    the sequential path takes lane 7 and the tail, decision-equal."""
    cfg, x, seq, first = recording
    _, d_a, seen_a = resumed_at_odd_gauge
    P, n, flagged = 3, len(x), CHUNKS - 1
    assert d_a["turbo.resumed_samples"] == (CHUNKS - P) * CHUNK_LEN
    f_np, *rest = seen_a["rounds"][0]
    f_np = dict(f_np, flags=f_np["flags"].copy())
    f_np["flags"][flagged - P] = 1
    _replay(monkeypatch, first, P, rounds=[(f_np, *rest)])
    res, d = _counted(lambda: turbo.demod_array_turbo(
        cfg, x, chunks=CHUNKS, device="cpu", strict=True))
    assert d["turbo.resumes"] == 1
    assert d["turbo.resumed_samples"] == (flagged - P) * CHUNK_LEN
    assert res.fallback_samples == n - flagged * CHUNK_LEN
    assert d["turbo.sequential_samples"] == res.fallback_samples
    _same_decisions(res.symbols, seq)


def test_unlocked_seeds_take_the_nearest_upstream_locked_seed():
    """A round's seed that is unlocked while its lane's own last exit was
    locked (an unlock handed down the lanes) becomes the nearest upstream
    locked seed; a lane whose exit was unlocked too keeps its seed, and so
    does every lane before the first locked one. FIR tails stay."""
    cfg = DemodConfig(samplerate=230400, block_len=L)
    lanes = 7
    seeds = batch_carry_np(cfg, lanes)
    seeds["locked"][:] = [0, 0, 1, 0, 0, 1, 0]
    seeds["p_freq"][:] = np.arange(lanes, dtype=np.float32)
    seeds["fir_tail"][:] = np.arange(lanes, dtype=np.float32)[:, None, None]
    exit_locked = np.array([1, 1, 1, 1, 0, 1, 1])
    turbo._relock_seeds(seeds, exit_locked)
    np.testing.assert_array_equal(seeds["locked"], [0, 0, 1, 1, 0, 1, 1])
    np.testing.assert_array_equal(seeds["p_freq"], [0, 1, 2, 2, 4, 5, 5])
    np.testing.assert_array_equal(seeds["fir_tail"][:, 0, 0], np.arange(7))


@pytest.mark.parametrize("case", ["oqpsk", "two_devices"])
def test_no_round_where_rounds_do_not_apply(case, monkeypatch):
    """(e) OQPSK, and lanes sharded over two devices: the prefix is
    followed by the sequential path straight away, although a round would
    pay (8 lanes of 1 block, cut at P = 1, two passes: 7 sequential
    launches against a round's 2)."""
    oqpsk = case == "oqpsk"
    cfg = DemodConfig(samplerate=230400, block_len=L,
                      **(dict(symrate=80000.0, oqpsk=True) if oqpsk else {}))
    x = _signal(cfg, CHUNKS * L + 1000, seed=5, carrier_hz=150.0)
    real = turbo.gauge_fixpoint

    def cut(*a, **k):
        f_np, outs, K, passes, _, resid, _, stats = real(*a, **k)
        ok = np.arange(CHUNKS) < 1
        return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats

    monkeypatch.setattr(turbo, "gauge_fixpoint", cut)
    fed = _stub_sequential(monkeypatch)
    where = (dict(device="cpu") if oqpsk else dict(mesh=["cpu"] * 2))
    res, d = _counted(lambda: turbo.demod_array_turbo(
        cfg, x, chunks=CHUNKS, max_passes=2, strict=True, **where))
    assert d["turbo.resumes"] == 0 and res.fell_back
    assert res.fallback_samples == len(x) - L
    assert [len(f) for f in fed] == [len(x) - L]
