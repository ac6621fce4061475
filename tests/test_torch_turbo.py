"""The port's turbo mode (meteor_demod_tpu_torch/demod/turbo.py) on the CPU:
its host functions and fingerprints bitwise against the JAX package's on the
same numpy inputs, demod_array_turbo against the JAX package's (scan backend)
on a QPSK recording, and against the port's own sequential stream in every
mode and on every fallback path.

Contracts. Host functions, fingerprints: bitwise. Against the JAX package's
turbo: same symbol count, converged, passes, gauges mod 4, locked_once and
the sign of every component; int8 soft values with mean |difference| < 2
(the JAX stream drifts from its oracle by an ulp a symbol, ROADMAP list C).
Against the port's own sequential path with strict=True: symbol count,
locked_once and the sign of every component equal on EVERY symbol, converged
or not; a non-converged run reports fallback_samples equal to the unverified
suffix. Best-effort (strict=False) non-converged output is only held to the
reference tests' loose bounds.

Fixtures are 2048-sample blocks and 4 lanes of 8 blocks (the plain
recurrence costs ~0.5 s a block on the CPU whatever the lane count; the
sequential run of each fixture is shared). Seeds: the QPSK fixture (seed 31,
150 Hz, 18 dB) is the first one tried; it converges in 3 passes with gauges
[0 2 4 7] in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import turbo as jturbo
from meteor_demod_tpu.demod.state import BlockOutput as JaxOutput
from meteor_demod_tpu.demod.state import DemodCarry as JaxCarry
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch import profiling
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.demod.pipeline import demod_array, quantize
from meteor_demod_tpu_torch.demod.state import (CARRY_FIELDS, BlockOutput,
                                                batch_carry_np)

L = 2048
CFGS = {
    "qpsk": dict(samplerate=230400, block_len=L),
    "oqpsk": dict(samplerate=230400, symrate=80000.0, oqpsk=True,
                  block_len=L),
}


def _rand_carry(cfg, lanes, seed):
    """A random but plausible host carry: dict of numpy leaves, (lanes,)."""
    rng = np.random.default_rng(seed)
    f32 = lambda lo, hi: rng.uniform(lo, hi, lanes).astype(np.float32)
    c = dict(
        t_phase=f32(0, 2 * np.pi), t_prev=f32(-200, 200),
        t_freq=(np.float32(cfg.timing_freq) * f32(0.9998, 1.0002)),
        p_phase=f32(0, 2 * np.pi), p_freq=f32(-0.05, 0.05),
        p_err=f32(20, 300), updown=rng.choice([-1.0, 1.0], lanes).astype(
            np.float32),
        agc_gain=f32(0.01, 0.05), agc_bias_re=f32(-30, 30),
        agc_bias_im=f32(-30, 30), inphase=f32(-200, 200),
        locked=rng.integers(0, 2, lanes).astype(np.int32),
        locked_once=rng.integers(0, 2, lanes).astype(np.int32),
        slot=rng.integers(1, 3, lanes).astype(np.int32),
        tick=rng.integers(0, 5, lanes).astype(np.int32),
        flags=np.zeros(lanes, np.int32),
        fir_tail=rng.standard_normal((lanes, cfg.taps - 1, 2)).astype(
            np.float32))
    return {k: c[k] for k in CARRY_FIELDS}


def _jc(c: dict) -> JaxCarry:
    return JaxCarry(**c)


def _same_carry(got: dict, ref: JaxCarry):
    for k in CARRY_FIELDS:
        a, b = np.asarray(got[k]), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k


# ---------------------------------------------------------------------------
# Host functions and fingerprints: bitwise against the JAX package.
# ---------------------------------------------------------------------------

def test_constants_and_small_helpers_match_jax():
    for name in ("GAUGE_DELTA_TOL", "GAUGE_PERR_SAFE", "GAUGE_ENTRY_TOL"):
        assert getattr(turbo, name) == getattr(jturbo, name), name
    np.testing.assert_array_equal(turbo._OQ_SIGNS, jturbo._OQ_SIGNS)
    for L_ in (1024, 2048, 8192):
        for kb in (1, 2, 3, 8, 16, 32, 100):
            assert (turbo.default_warmup_blocks(L_, kb)
                    == jturbo.default_warmup_blocks(L_, kb))
    for ok in ([], [True, True], [True, False, True], [False, True],
               [True, True, True, False]):
        ok = np.array(ok, bool)
        assert turbo.verified_prefix(ok) == jturbo.verified_prefix(ok)
    assert turbo.verified_prefix(None) == 0
    re = np.array([1.0, -2.0, 3.5], np.float32)
    im = np.array([4.0, 5.0, -6.0], np.float32)
    for r in range(-5, 6):
        for a, b in zip(turbo.rotate_quadrant(re, im, r),
                        jturbo.rotate_quadrant(re, im, r)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_gauge_measure_and_shift_match_jax(mode):
    """_gauge_measure and _gauge_shift_np on the same random carries, with
    quadrants of every class mod 4 and both signs (odd and even gauges)."""
    cfg, jcfg = DemodConfig(**CFGS[mode]), JaxConfig(**CFGS[mode])
    lanes = 12
    f, w = _rand_carry(cfg, lanes, 1), _rand_carry(cfg, lanes, 2)
    # Exit phases a known quadrant count away from the next lane's estimate,
    # plus loop noise; OQPSK timing parities agree with k on most boundaries
    # and disagree on two (delta poisoned to pi there).
    want_k = np.array([0, 1, 2, 3, -1, -2, -3, 4, 5, 1, 2])
    noise = np.random.default_rng(3).uniform(-0.2, 0.2, lanes - 1)
    f["p_phase"][:-1] = (w["p_phase"][1:].astype(np.float64)
                         + want_k * np.pi / 2 + noise).astype(np.float32)
    if mode == "oqpsk":
        h2 = np.pi / float(cfg.timing_freq)
        par = want_k % 2
        par[[3, 7]] ^= 1
        nq_w = (2 * np.pi - w["t_phase"][1:].astype(np.float64)) \
            / w["t_freq"][1:]
        f["t_phase"][:-1] = (2 * np.pi - (nq_w + par * h2)
                             * f["t_freq"][:-1]).astype(np.float32)
    got = turbo._gauge_measure(f, w, cfg)
    ref = jturbo._gauge_measure(_jc(f), _jc(w), jcfg)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(got[0], want_k)
    if mode == "oqpsk":
        assert (got[1] == np.pi).sum() == 2

    init = batch_carry_np(cfg, 1)
    tails = np.random.default_rng(4).standard_normal(
        (lanes, cfg.taps - 1, 2)).astype(np.float32)
    g = turbo._gauge_shift_np(init, f, w, got[0], tails, cfg)
    _same_carry(g, jturbo._gauge_shift_np(_jc(init), _jc(f), _jc(w), ref[0],
                                          tails, jcfg))
    # The lane shift itself: lane 0 the exact entry, lane c+1 lane c's exit.
    assert g["p_err"][0] == init["p_err"][0]
    np.testing.assert_array_equal(g["p_err"][1:], f["p_err"][:-1])
    assert not g["tick"].any() and not g["flags"].any()


def test_decisions_settled_and_lane_ok_match_jax():
    cfg = DemodConfig(**CFGS["qpsk"])
    lanes = 10
    rng = np.random.default_rng(5)
    for case in range(6):
        a = _rand_carry(cfg, lanes, 10 + case)
        b = {k: v.copy() for k, v in a.items()}
        if case >= 1:      # p_err drift: some lanes safe, some settled, some not
            b["p_err"] = (a["p_err"] * rng.choice(
                [1.0, 1.001, 1.2], lanes)).astype(np.float32)
        if case == 2:
            b["locked"][3] ^= 1
        if case == 3:
            b["slot"][7] = 3 - b["slot"][7]
        got = turbo._decisions_settled(a, b)
        assert got == jturbo._decisions_settled(_jc(a), _jc(b))
        fp = tuple((int(i), int(i) * 3, 7) for i in range(lanes))
        prev_fp = tuple(t if i % 4 else (t[0], t[1] + 1, 7)
                        for i, t in enumerate(fp))
        k = rng.integers(-3, 4, lanes - 1)
        k_prev = np.where(rng.random(lanes - 1) < 0.3, k + 1, k)
        delta = rng.uniform(-0.6, 0.6, lanes - 1)
        for pf, kp in ((None, None), (prev_fp, None), (prev_fp, k_prev),
                       (fp, k)):
            np.testing.assert_array_equal(
                turbo._lane_ok_np(fp, pf, k, kp, delta, a, b),
                jturbo._lane_ok_np(fp, pf, k, kp, delta, _jc(a), _jc(b)))


@pytest.mark.parametrize("kb_w", [2, 4])
def test_warmup_inputs_match_jax(kb_w):
    """build_warmup (kb_w == kb: lane 1's segment starts the recording, so
    its FIR tail is zeros), boundary_tails, finish_warmup_carry."""
    cfg, jcfg = DemodConfig(**CFGS["qpsk"]), JaxConfig(**CFGS["qpsk"])
    lanes, kb, Lb = 5, 4, 256
    chunk_len = kb * Lb
    xf = np.random.default_rng(6).standard_normal(
        (lanes * chunk_len, 2)).astype(np.float32)
    wseg, wtails = turbo.build_warmup(xf, lanes, chunk_len, kb_w, Lb, cfg.taps)
    rblocks, rtails = jturbo.build_warmup(xf, lanes, chunk_len, kb_w, Lb,
                                          jcfg.taps)
    np.testing.assert_array_equal(
        wseg, rblocks.transpose(1, 0, 2, 3).reshape(lanes, kb_w * Lb, 2))
    np.testing.assert_array_equal(wtails, rtails)
    np.testing.assert_array_equal(
        wtails, turbo.warmup_tails(xf, lanes, chunk_len, kb_w * Lb, cfg.taps))
    tails = turbo.boundary_tails(xf, lanes, chunk_len, cfg.taps)
    for c in range(1, lanes):     # the reference builds these in line
        np.testing.assert_array_equal(
            tails[c], xf[c * chunk_len - (cfg.taps - 1):c * chunk_len])
    assert not tails[0].any()
    # The segments demod_array_turbo cuts on the device from the recording.
    blocks = torch.from_numpy(xf).view(lanes, chunk_len, 2)
    V = kb_w * Lb
    np.testing.assert_array_equal(
        torch.cat([blocks[:1, :V], blocks[:-1, chunk_len - V:]]).numpy(), wseg)

    wf = _rand_carry(cfg, lanes, 7)
    for init in (None, {k: v[:1] for k, v in _rand_carry(cfg, 1, 8).items()}):
        _same_carry(
            turbo.finish_warmup_carry(cfg, wf, tails, init),
            jturbo.finish_warmup_carry(
                jcfg, _jc(wf), tails, None if init is None else _jc(init)))


def _rand_outs(rng, kb, lanes, rows, p_valid=0.85):
    """Random block outputs in the JAX layout (kb, C, rows), float32/int32."""
    return dict(
        sym_re=(rng.standard_normal((kb, lanes, rows)) * 90).astype(np.float32),
        sym_im=(rng.standard_normal((kb, lanes, rows)) * 90).astype(np.float32),
        valid=(rng.random((kb, lanes, rows)) < p_valid).astype(np.int32),
        locked_once=rng.integers(0, 2, (kb, lanes, rows)).astype(np.int32))


def _lane_major(a):
    """(kb, C, rows) -> the port's (C, kb*rows)."""
    return np.ascontiguousarray(a.transpose(1, 0, 2).reshape(a.shape[1], -1))


def test_assemble_oqpsk_gauge_matches_jax():
    """Odd and even cumulative gauges, both boundary stitches (predecessor
    exit slot 2: its pending I half is inserted; slot 1: the lane's duplicate
    first half-value is dropped), a lane that emitted nothing, with and
    without a tail."""
    rng = np.random.default_rng(9)
    kb, lanes, rows = 3, 8, 40
    o = _rand_outs(rng, kb, lanes, rows)
    o["valid"][:, 5, :] = 0
    K = np.array([0, 1, 1, 3, 4, 6, 7, 9])
    exit_slot = np.array([2, 1, 2, 1, 2, 1, 1, 2], np.int32)
    odd = (np.diff(K) % 2).astype(bool)
    assert {int(s) for s in exit_slot[:-1][odd]} == {1, 2}
    exit_inphase = rng.standard_normal(lanes).astype(np.float32) * 80
    exit_lonce = rng.integers(0, 2, lanes).astype(np.int32)
    tail = np.zeros(17, dtype=jturbo._SYM_DTYPE)
    tail["re"], tail["im"] = rng.standard_normal((2, 17)) * 70
    tail["locked_once"] = 1
    for tail_syms in (None, tail):
        ref = jturbo._assemble_oqpsk_gauge(
            o["sym_re"], o["sym_im"], o["valid"].astype(bool),
            o["locked_once"], K, exit_slot, exit_inphase, exit_lonce,
            tail_syms)
        got = turbo._assemble_oqpsk_gauge(
            *(_lane_major(o[k]) for k in ("sym_re", "sym_im", "valid",
                                          "locked_once")),
            K, exit_slot, exit_inphase, exit_lonce, tail_syms)
        assert got.dtype == ref.dtype and len(got) == len(ref) > 300
        np.testing.assert_array_equal(got, ref)
    # The port's addition: the half-value the final carry holds unemitted
    # (slot 2). Under the odd last gauge it completes one more symbol exactly
    # when the half-value stream was odd in length; a slot-1 carry, or a
    # pending half that stays unpaired, changes nothing.
    args = [_lane_major(o[k]) for k in ("sym_re", "sym_im", "valid",
                                        "locked_once")]
    base = turbo._assemble_oqpsk_gauge(*args, K, exit_slot, exit_inphase,
                                       exit_lonce, None)
    n_half = 2 * int(o["valid"].sum()) + sum(
        (1 if exit_slot[c - 1] == 2 else -1)
        for c in range(1, lanes) if (K[c] - K[c - 1]) % 2)
    more = turbo._assemble_oqpsk_gauge(*args, K, exit_slot, exit_inphase,
                                       exit_lonce, None,
                                       pending=(2, np.float32(37.5), 1))
    assert len(base) == n_half // 2
    assert len(more) == (n_half + 1) // 2
    np.testing.assert_array_equal(more[:len(base)], base)
    if len(more) > len(base):
        sign = turbo._OQ_SIGNS[int(K[-1]) % 4][0]
        assert more["im"][-1] == sign * np.float32(37.5)
        assert more["locked_once"][-1] == 1
    same = turbo._assemble_oqpsk_gauge(*args, K, exit_slot, exit_inphase,
                                       exit_lonce, None,
                                       pending=(1, np.float32(37.5), 1))
    np.testing.assert_array_equal(same, base)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_assemble_qpsk_gauge_matches_jax(scale):
    """scale 1.0 on float rows (demod_array_turbo), 2.0 on int8 rows (the
    span path); against the vectorized reference and the per-lane
    rotate_quadrant loop of the reference's demod_array_turbo."""
    rng = np.random.default_rng(10)
    kb, lanes, rows = 3, 9, 50
    o = _rand_outs(rng, kb, lanes, rows)
    if scale == 2.0:
        for k in ("sym_re", "sym_im"):
            o[k] = quantize(o[k]).astype(np.int8)
    K = np.array([0, 1, 2, 3, -1, -2, 5, 8, 11])
    ref = jturbo._assemble_qpsk_gauge(
        o["sym_re"], o["sym_im"], o["valid"].astype(bool), o["locked_once"],
        K, scale=scale)
    got = turbo._assemble_qpsk_gauge(
        *(_lane_major(o[k]) for k in ("sym_re", "sym_im", "valid",
                                      "locked_once")), K, scale=scale)
    np.testing.assert_array_equal(got, ref)
    if scale == 1.0:
        at = 0
        for c in range(lanes):
            m = o["valid"][:, c, :].reshape(-1).astype(bool)
            re, im = jturbo.rotate_quadrant(
                o["sym_re"][:, c, :].reshape(-1)[m],
                o["sym_im"][:, c, :].reshape(-1)[m], K[c])
            np.testing.assert_array_equal(got["re"][at:at + len(re)], re)
            np.testing.assert_array_equal(got["im"][at:at + len(im)], im)
            at += len(re)
        assert at == len(got)
        plain = turbo._assemble_qpsk_gauge(
            *(_lane_major(o[k]) for k in ("sym_re", "sym_im", "valid",
                                          "locked_once")), None)
        np.testing.assert_array_equal(
            plain["re"], _lane_major(o["sym_re"])[_lane_major(o["valid"]) > 0])


@pytest.mark.parametrize("rows", [3000, 3001])
def test_fingerprints_match_jax(rows):
    """lane_fingerprint against _lane_fp_body (and its per-block form, the
    sum of _lane_fp_block), output_fingerprint against _fingerprint_fn, on
    outputs long enough that the int32 checksums wrap; last_valid_symbol
    against a loop."""
    rng = np.random.default_rng(11)
    kb, lanes = 4, 6
    o = _rand_outs(rng, kb, lanes, rows, p_valid=0.97)
    o["locked_once"][:] = 1
    o["sym_re"][:, 0, :] = np.abs(o["sym_re"][:, 0, :])   # lane 0 all positive
    o["sym_im"][:, 0, :] = np.abs(o["sym_im"][:, 0, :])
    o["valid"][:, 4, :] = 0                               # an empty lane
    o["valid"][-1, 3, rows // 2:] = 0                     # ends early
    jouts = JaxOutput(**{k: jnp.asarray(v) for k, v in o.items()})
    ref = [np.asarray(t) for t in jturbo._lane_fp_body(jouts)]
    assert abs(int(ref[1][0])) < 2 ** 31 and 8191 * 26 * kb * rows > 2 ** 31
    touts = BlockOutput(**{k: torch.from_numpy(_lane_major(v))
                           for k, v in o.items()})
    got = [t.numpy() for t in turbo.lane_fingerprint(touts)]
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    per_block = [jturbo._lane_fp_block(
        JaxOutput(**{k: jnp.asarray(v[i]) for k, v in o.items()}), i)
        for i in range(kb)]
    for j in range(3):
        np.testing.assert_array_equal(
            got[j], sum(np.asarray(b[j]) for b in per_block).astype(np.int32))

    ref_n, ref_cs = (np.asarray(t) for t in jturbo._fingerprint_fn()(jouts))
    n, cs = turbo.output_fingerprint(touts, rows)
    assert (int(n), int(cs)) == (int(ref_n), int(ref_cs))
    assert cs.dtype == torch.int32

    last_re, last_im = (t.numpy() for t in turbo.last_valid_symbol(touts))
    for c in range(lanes):
        m = np.nonzero(touts.valid[c].numpy())[0]
        want = ((touts.sym_re[c, m[-1]], touts.sym_im[c, m[-1]]) if len(m)
                else (0.0, 0.0))
        assert (last_re[c], last_im[c]) == (float(want[0]), float(want[1]))


# ---------------------------------------------------------------------------
# demod_array_turbo end to end.
# ---------------------------------------------------------------------------

CHUNKS, KB = 4, 8


def _signal(cfg, n, seed, carrier_hz, snr_db=18.0, **kw):
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=snr_db,
                     seed=seed, **kw)
    return x[:n]


def _same_decisions(got, ref):
    """The strict contract: count, locked_once and every sign."""
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    np.testing.assert_array_equal(np.sign(got["re"]), np.sign(ref["re"]))
    np.testing.assert_array_equal(np.sign(got["im"]), np.sign(ref["im"]))


@pytest.fixture(scope="module")
def recording():
    """4 lanes x 8 blocks of QPSK plus a 3000-sample tail (so the tail runs
    from a rotated carry: the last lane's gauge is 7), its sequential
    demodulation, and the strict gauge turbo run."""
    cfg = DemodConfig(**CFGS["qpsk"])
    x = _signal(cfg, CHUNKS * KB * L + 3000, seed=31, carrier_hz=150.0)
    seq = demod_array(cfg, x, "cpu")
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    return cfg, x, seq, res


@pytest.fixture(scope="module")
def short_recording():
    """4 lanes x 2 blocks: chunks much shorter than the p_err EMA memory."""
    cfg = DemodConfig(**CFGS["qpsk"])
    x = _signal(cfg, CHUNKS * 2 * L, seed=21, carrier_hz=150.0, snr_db=22.0)
    return cfg, x, demod_array(cfg, x, "cpu")


def test_turbo_gauge_converges_in_constant_passes(recording):
    """Gauge mode: O(1) passes whatever the lane count, nonzero gauges
    resolved, no fallback, the non-multiple tail continued from the last
    lane's carry rotated into chunk 0's gauge; decisions equal to the
    sequential stream's on every symbol, soft values within 4 quanta in the
    mean (the slow p_freq integrator is a pass or two from its asymptote)."""
    cfg, x, seq, res = recording
    assert res.converged, res.max_residual
    assert res.passes <= 3 and not res.fell_back and res.fallback_samples == 0
    assert np.any(res.gauges % 4) and res.gauges[-1] % 4 != 0
    _same_decisions(res.symbols, seq)
    mad = np.mean(np.abs(quantize(res.symbols["re"]) - quantize(seq["re"])))
    assert mad < 4.0, mad


def test_turbo_matches_jax_turbo(recording):
    """The same recording through the JAX package's demod_array_turbo (scan
    backend, its fused program): see the module docstring's contract."""
    cfg, x, _, res = recording
    ref = jturbo.demod_array_turbo(JaxConfig(**CFGS["qpsk"]), x,
                                   chunks=CHUNKS, backend="scan", strict=True)
    assert (res.converged, res.passes, res.fell_back) == (
        ref.converged, ref.passes, ref.fell_back)
    np.testing.assert_array_equal(res.gauges % 4, np.asarray(ref.gauges) % 4)
    _same_decisions(res.symbols, ref.symbols)
    for k in ("re", "im"):
        mad = np.mean(np.abs(quantize(res.symbols[k])
                             - quantize(ref.symbols[k])))
        assert mad < 2.0, (k, mad)


@pytest.mark.parametrize("converge", ["bitwise", "symbols"])
def test_turbo_exact_modes_equal_sequential(short_recording, converge):
    """"bitwise": with max_passes >= chunks+1 exact carries reach every
    lane, and the result IS the sequential stream's, value for value (the
    port's batched program and its batch-1 program are the same arithmetic).
    "symbols" stops no later, on equal int8 output."""
    cfg, x, seq = short_recording
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=CHUNKS + 1, converge=converge)
    assert res.converged and res.gauges is None and not res.fell_back
    assert res.passes <= CHUNKS + 1
    if converge == "bitwise":
        assert res.max_residual == 0.0
        np.testing.assert_array_equal(res.symbols, seq)
    else:
        _same_decisions(res.symbols, seq)


def test_turbo_slow_state_propagation_blocks_convergence(short_recording):
    """Chunks much shorter than the p_err EMA memory: decisions stabilize
    while the lock state still propagates one chunk per pass, and the
    entry-residual criterion keeps convergence undeclared. Two passes report
    converged=False with a residual; strict then accepts the verified prefix
    (here lane 0 at most), resumes the fixpoint from it over the other three
    lanes (a round of at most 2 x 2 launches against their 6 sequential
    ones),
    and demodulates sequentially after what that round verified, ending
    decision-equal."""
    cfg, x, seq = short_recording
    before = profiling.counters().get("turbo.resumed_samples", 0)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=2, strict=True)
    resumed = profiling.counters().get("turbo.resumed_samples", 0) - before
    assert not res.converged and res.passes in (0, 2)
    assert res.fell_back
    assert res.fallback_samples + resumed in (len(x), len(x) - 2 * L)
    _same_decisions(res.symbols, seq)


def test_turbo_non_convergence_reported(recording):
    """One pass cannot report convergence: converged=False, a nonzero
    residual, no fallback without strict, and still a valid demodulation
    (each cold lane may sit in its own quadrant, hence the flag)."""
    cfg, x, seq, _ = recording
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=1)
    assert not res.converged and res.passes == 1
    assert res.max_residual > 0.0 and not res.fell_back
    assert abs(len(res.symbols) - len(seq)) <= 2 * CHUNKS
    assert res.symbols["locked_once"][-1] == 1
    mag = np.hypot(res.symbols["re"], res.symbols["im"])[-500:]
    assert 100.0 < float(np.median(mag)) < 300.0


def test_turbo_strict_falls_back_whole_when_nothing_verified(short_recording):
    """strict with max_passes=1: no lane can verify, so the whole recording
    is redone sequentially, bitwise the sequential stream."""
    cfg, x, seq = short_recording
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=1, strict=True)
    assert res.fell_back and not res.converged
    assert res.fallback_samples == len(x) and res.passes == 0
    np.testing.assert_array_equal(res.symbols, seq)


def test_turbo_flagged_lane_falls_back_sequential(short_recording,
                                                  monkeypatch):
    """A safety flag on any lane's exit carry invalidates the fast path:
    the recording is redone sequentially. The CUDA kernels and the plain
    recurrence flag only a deferred OQPSK pre-fire or an unconsumed block,
    so the flag is forced on lane 2's exit."""
    cfg, x, seq = short_recording
    real = turbo.make_pass_runner

    def flagging(cfg_, blocks, **kw):
        run = real(cfg_, blocks, **kw)

        def flagged(g_np):
            f_np, outs, stats = run(g_np)
            f_np["flags"] = f_np["flags"].copy()
            f_np["flags"][2] = 1
            return f_np, outs, stats
        return flagged

    monkeypatch.setattr(turbo, "make_pass_runner", flagging)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=2)
    assert res.fell_back and not res.converged
    assert res.fallback_samples == len(x)
    np.testing.assert_array_equal(res.symbols, seq)


def test_turbo_strict_bounded_fallback_resumes_from_prefix(recording,
                                                           monkeypatch):
    """strict with a non-converged fixpoint does NOT redo the whole file:
    the verified prefix of lanes is accepted and the sequential path resumes
    from that boundary's carry, so the cost is the divergent SUFFIX. The
    verdict of an otherwise converged run is poisoned from lane P on; the
    sequential work is counted through the stream demodulator."""
    cfg, x, seq, _ = recording
    P, n, chunk_len = 3, len(x), KB * L
    real = turbo.gauge_fixpoint

    def poisoned(*a, **k):
        f_np, outs, K, passes, conv, resid, _, stats = real(*a, **k)
        assert conv, "the fixture must converge before poisoning"
        ok = np.ones(CHUNKS, bool)
        ok[P:] = False
        return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats

    monkeypatch.setattr(turbo, "gauge_fixpoint", poisoned)
    fed = []

    class Counting(turbo.StreamDemodulator):
        def process(self, samples):
            fed.append(len(samples))
            return super().process(samples)

    monkeypatch.setattr(turbo, "StreamDemodulator", Counting)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    assert res.fell_back and not res.converged
    assert res.fallback_samples == sum(fed) == n - P * chunk_len
    _same_decisions(res.symbols, seq)


def test_turbo_noise_only_input():
    """Pure noise: the PLL never locks and the warmup estimates mean
    nothing; the fixpoint converges on the unlocked stream or reports that it
    did not, and never claims a lock. strict: a wholly unverified run is the
    sequential stream bitwise; a bounded fallback costs less than a redo."""
    cfg = DemodConfig(**CFGS["qpsk"])
    rng = np.random.default_rng(7)
    n = CHUNKS * 2 * L
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
         .astype(np.complex64) * 900.0)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  max_passes=3, strict=True)
    seq = demod_array(cfg, x, "cpu")
    assert not seq["locked_once"].any()
    assert not res.symbols["locked_once"].any()
    if res.fell_back and res.fallback_samples == n:
        np.testing.assert_array_equal(res.symbols, seq)
    elif res.fell_back:
        assert 0 < res.fallback_samples < n
        assert abs(len(res.symbols) - len(seq)) <= 2 * CHUNKS
    else:
        assert res.converged and len(res.symbols) == len(seq)


def test_turbo_gauge_doppler_ramp():
    """A moving carrier, the regime of a real pass (31 Hz/s is a LEO pass's
    peak rate): each lane's warmup sees signal from one chunk earlier, and
    the fixpoint pulls the per-chunk carrier estimates forward. Still O(1)
    passes, decisions equal to the sequential stream's on every symbol."""
    cfg = DemodConfig(**CFGS["qpsk"])
    x = _signal(cfg, CHUNKS * KB * L, seed=31, carrier_hz=100.0,
                carrier_ramp_hz_s=31.0)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu",
                                  strict=True)
    assert res.converged and res.passes <= 3 and not res.fell_back
    _same_decisions(res.symbols, demod_array(cfg, x, "cpu"))


def test_turbo_short_input_and_bad_mode():
    """Fewer samples than one block a lane: the sequential path whole. An
    unknown converge mode raises."""
    cfg = DemodConfig(**CFGS["qpsk"])
    x = _signal(cfg, 3 * L + 100, seed=3, carrier_hz=80.0)
    res = turbo.demod_array_turbo(cfg, x, chunks=CHUNKS, device="cpu")
    assert res.fell_back and res.converged and res.passes == 0
    assert res.fallback_samples == len(x)
    np.testing.assert_array_equal(res.symbols, demod_array(cfg, x, "cpu"))
    with pytest.raises(ValueError, match="converge"):
        turbo.demod_array_turbo(cfg, x, device="cpu", converge="nope")
