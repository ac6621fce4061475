"""The arithmetic of the CUDA kernels' O(1) timing gate
(meteor_demod_tpu_torch/csrc/block_demod.cu: gate), mirrored in numpy
float32 step for step and held EQUAL to the definition the kernels must
reproduce: demod/scalar.py gate_fire_np.

The mirror below follows the CUDA source line by line (one float32
rounding per operation, the same clamps and selects), so a case that
breaks it breaks the kernel; the kernels themselves are compared with
the plain version on the card (tests/test_torch_kernel_card.py).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.scalar import gate_fire_np

F = np.float32
PI = F(np.pi)
TWO_PI = F(2 * np.pi)
CONFIGS = {
    "qpsk": DemodConfig(samplerate=230400),
    "oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True),
    "hifi_qpsk": DemodConfig(samplerate=230400, rrc_order=64, interp=10),
    "hifi_oqpsk": DemodConfig(samplerate=230400, symrate=80000.0, oqpsk=True,
                              rrc_order=64, interp=10),
}


def _ceil_to_int(x: np.float32) -> int:
    """__float2int_ru: round up, saturate, NaN -> 0."""
    if np.isnan(x):
        return 0
    return int(np.clip(np.ceil(np.float64(x)), -2 ** 31, 2 ** 31 - 1))


def gate_search(diff, tf, kmax):
    """gate_search of the CUDA source: the serial definition."""
    for k in range(1, kmax + 1):
        prod = F(F(k) * tf)
        if prod >= diff:
            return True, k, prod
    return False, kmax, (F(F(kmax) * tf) if kmax > 0 else F(0.0))


def gate_o1(tp, tf, thresh, rem, K, inv_tc):
    """gate<true> of the CUDA source. Returns (fired, k, prod, searched):
    `searched` says that the estimate proved nothing and the serial search
    ran."""
    tp, tf, thresh, inv_tc = F(tp), F(tf), F(thresh), F(inv_tc)
    with np.errstate(all="ignore"):
        diff = F(thresh - tp)
        kmax = min(K, rem)
        ke = max(1, min(_ceil_to_int(F(diff * inv_tc)), K))
        fk = F(ke)
        pm2 = F(F(fk - F(2.0)) * tf)
        pm1 = F(F(fk - F(1.0)) * tf)
        p0 = F(fk * tf)
        pp1 = F(F(fk + F(1.0)) * tf)
        am2 = ke > 2 and pm2 >= diff
        am1 = ke > 1 and pm1 >= diff
        a0 = p0 >= diff
        ap1 = pp1 >= diff
        fm1, f0, fp1 = am1 and not am2, a0 and not am1, ap1 and not a0
        kf = ke - 1 if fm1 else (ke if f0 else ke + 1)
        pf = pm1 if fm1 else (p0 if f0 else pp1)
        found = fm1 or f0 or fp1
        none = (not ap1) and ke + 1 >= kmax
        if tf > 0.0 and (found or none):
            if found and kf <= kmax:
                return True, kf, pf, False
            return (False, kmax,
                    F(F(kmax) * tf) if kmax > 0 else F(0.0), False)
        return (*gate_search(diff, tf, kmax), True)


def check_gate(tp, tf, thresh, rem, K, inv_tc) -> bool:
    """gate_o1 against gate_fire_np (and the selected product against the
    definition's); returns whether the serial search ran."""
    ks = np.arange(1, K + 1, dtype=F)
    with np.errstate(all="ignore"):
        want_fired, want_k = gate_fire_np(F(tp), F(tf), F(thresh), rem, ks)
        want_prod = F(F(want_k) * F(tf)) if want_k > 0 else F(0.0)
    fired, k, prod, searched = gate_o1(tp, tf, thresh, rem, K, inv_tc)
    ctx = (tp, tf, thresh, rem, K)
    assert (fired, k) == (want_fired, want_k), ctx
    assert np.array_equal(F(prod).view(np.uint32),
                          F(want_prod).view(np.uint32)) or (
        np.isnan(prod) and np.isnan(want_prod)), ctx
    return searched


def _inv(cfg) -> np.float32:
    return F(1.0) / cfg.timing_freq


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_in_clamp_equals_definition_and_never_searches(name):
    """Timing frequency inside t_center*(1 +- 2**-12) (its clamp), timing
    phase anywhere a locked or acquiring loop puts it, every rem: equal to
    gate_fire_np, and the estimate always suffices."""
    cfg = CONFIGS[name]
    K, tc, dev = cfg.gate_candidates, cfg.timing_freq, cfg.timing_dev_max
    rng = np.random.default_rng(3)
    searched = 0
    n = 6000
    for i in range(n):
        tf = F(tc + F(rng.uniform(-1, 1)) * dev)
        if i % 7 == 0:
            tf = F(tc + dev) if i % 2 else F(tc - dev)
        thresh = PI if (cfg.oqpsk and i % 2) else TWO_PI
        tp = F(rng.uniform(-2.0, float(thresh) + 1.0))
        rem = int(rng.integers(0, K + 2)) if i % 3 == 0 else 40960
        searched += check_gate(tp, tf, thresh, rem, K, _inv(cfg))
    assert searched == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_exact_multiples_of_the_frequency(name):
    """diff within a few ulps of k*tf, where the estimate's ceil and the
    predicate's rounding can disagree by one."""
    cfg = CONFIGS[name]
    K, tc = cfg.gate_candidates, cfg.timing_freq
    searched = 0
    for k in range(1, K + 2):
        for ulps in range(-3, 4):
            for tf in (tc, F(tc + cfg.timing_dev_max),
                       F(tc - cfg.timing_dev_max)):
                diff = F(F(k) * tf)
                for _ in range(abs(ulps)):
                    diff = np.nextafter(diff, F(np.inf if ulps > 0 else -np.inf))
                tp = F(TWO_PI - diff)
                for rem in (K + 5, k, max(k - 1, 0)):
                    searched += check_gate(tp, tf, TWO_PI, rem, K, _inv(cfg))
    assert searched == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_every_rem_near_the_block_end(name):
    cfg = CONFIGS[name]
    K, tc = cfg.gate_candidates, cfg.timing_freq
    rng = np.random.default_rng(5)
    for rem in range(0, K + 2):
        for _ in range(60):
            tp = F(rng.uniform(-1.0, 7.0))
            assert not check_gate(tp, tc, TWO_PI, rem, K, _inv(cfg))


@pytest.mark.parametrize("thresh", [PI, TWO_PI])
def test_gate_threshold_already_passed(thresh):
    """diff <= 0: the first tick fires (k = 1) without a search."""
    cfg = CONFIGS["oqpsk"]
    K, tc = cfg.gate_candidates, cfg.timing_freq
    for tp in (thresh, F(thresh + F(0.5)), F(50.0), np.nextafter(thresh, F(9))):
        for rem in (0, 1, 2, K, 1000):
            assert not check_gate(tp, tc, thresh, rem, K, _inv(cfg))
            if rem > 0:
                assert gate_o1(tp, tc, thresh, rem, K, _inv(cfg))[:2] == (
                    True, 1)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_far_behind_never_fires_without_a_search(name):
    """An acquisition transient: the phase far behind the threshold. No k
    in [1, K] fires; the estimate, clamped to K, proves it."""
    cfg = CONFIGS[name]
    K, tc = cfg.gate_candidates, cfg.timing_freq
    for tp in (-30.0, -300.0, -1e6, -3e38):
        for rem in (0, 3, K, K + 1, 40960):
            assert not check_gate(F(tp), tc, TWO_PI, rem, K, _inv(cfg))
            assert gate_o1(F(tp), tc, TWO_PI, rem, K, _inv(cfg))[:2] == (
                False, min(rem, K))


@pytest.mark.parametrize("tf", [0.0, -0.0, -0.4363, -1e-30, float("nan"),
                                float("inf"), float("-inf"), 1e-30, 1e30])
def test_gate_degenerate_frequency_equals_definition(tf):
    """A crafted carry: zero, negative, NaN, infinite or absurd timing
    frequency. Whatever the estimate cannot prove runs the serial search,
    so the result is the definition's."""
    cfg = CONFIGS["qpsk"]
    K = cfg.gate_candidates
    rng = np.random.default_rng(11)
    for _ in range(200):
        tp = F(rng.uniform(-8.0, 8.0))
        rem = int(rng.integers(0, 2 * K))
        check_gate(tp, F(tf), TWO_PI, rem, K, _inv(cfg))
    if not tf > 0:
        assert gate_o1(F(1.0), F(tf), TWO_PI, 100, K, _inv(cfg))[3]


@pytest.mark.parametrize("factor", [0.3, 0.6, 0.9, 0.99, 1.01, 1.3, 3.0, 40.0])
def test_gate_frequency_outside_the_clamp_equals_definition(factor):
    """tf off its clamp (a crafted carry): the estimate may be off by more
    than one; the result still equals the definition."""
    for cfg in CONFIGS.values():
        K, tc = cfg.gate_candidates, cfg.timing_freq
        rng = np.random.default_rng(13)
        for _ in range(300):
            tp = F(rng.uniform(-3.0, 7.0))
            rem = int(rng.integers(0, 2 * K))
            thresh = PI if rng.integers(2) else TWO_PI
            check_gate(tp, F(tc * F(factor)), thresh, rem, K, _inv(cfg))


@settings(max_examples=400, deadline=None)
@given(tp=st.floats(width=32, allow_nan=True, allow_infinity=True),
       tf=st.floats(width=32, allow_nan=True, allow_infinity=True),
       half=st.booleans(), rem=st.integers(0, 60),
       name=st.sampled_from(list(CONFIGS)))
def test_gate_any_float_equals_definition(tp, tf, half, rem, name):
    cfg = CONFIGS[name]
    check_gate(F(tp), F(tf), PI if half else TWO_PI, rem,
               cfg.gate_candidates, _inv(cfg))


@settings(max_examples=400, deadline=None)
@given(frac=st.floats(-1.0, 1.0), tp=st.floats(-4.0, 8.0, width=32),
       half=st.booleans(), rem=st.integers(0, 60),
       name=st.sampled_from(list(CONFIGS)))
def test_gate_in_clamp_hypothesis_never_searches(frac, tp, half, rem, name):
    cfg = CONFIGS[name]
    tf = F(cfg.timing_freq + F(frac) * cfg.timing_dev_max)
    assert not check_gate(F(tp), tf, PI if half else TWO_PI, rem,
                          cfg.gate_candidates, _inv(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate_along_a_free_running_nco(name):
    """The gate iterated as the recurrence iterates it (phase advanced by
    the selected product, wrapped by the threshold on a fire) over one
    block's ticks: the same fire pattern as the definition, no search."""
    cfg = CONFIGS[name]
    K, tc, T = cfg.gate_candidates, cfg.timing_freq, cfg.block_ticks // 8
    thresh = PI if cfg.oqpsk else TWO_PI
    ks = np.arange(1, K + 1, dtype=F)
    tp, t, fires = F(0.3), 0, 0
    while t < T:
        want = gate_fire_np(tp, tc, thresh, T - t, ks)
        fired, k, prod, searched = gate_o1(tp, tc, thresh, T - t, K,
                                           _inv(cfg))
        assert (fired, k) == want and not searched
        tp = F(tp + prod)
        if fired:
            tp = F(tp - thresh)
            fires += 1
        t += k
    assert abs(fires - T * float(tc) / float(thresh)) <= 2


def test_packed_params_carry_the_gate_estimate():
    """The kernel's Params end with fl(1 / t_center), float32 arithmetic."""
    from meteor_demod_tpu_torch.kernels.block_demod import _packed_params
    for cfg in CONFIGS.values():
        p = _packed_params(cfg)
        assert p.dtype == F and p[-1] == F(1.0) / cfg.timing_freq
        assert p[4] == cfg.timing_freq and len(p) == 20 + 32 + 1
