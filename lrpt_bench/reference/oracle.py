"""The demodulator's recurrence, one fire at a time, over many lanes at once.

A copy of the upstream loop (demod.c:23-91, agc.c:12-25, pll.c:50-130,
timing.c:59-95, sincos.c:12-47) in float32, one rounding per operation,
written over a vector of independent lanes so that NumPy carries the
per-fire Python cost once for all of them. Each lane is one stream (or one
stretch of one recording) with its own state and its own FIR output; lanes
never mix. Each call consumes one block of ticks in every lane, as the
block demodulator is called block by block: the timing gate is evaluated in
closed form, k* = min{k in [1, K] : fl(k*tf) >= fl(thresh - tp)}, limited
to the ticks left in the block, and a gate that does not fire by the end of
the block consumes what is left and resumes in the next.
"""

from __future__ import annotations

import math

import numpy as np

from . import params as P

F32 = np.float32
TWO_PI = F32(2 * np.pi)
PI = F32(np.pi)
HALF_PI = F32(np.pi / 2)
ONE, ZERO = F32(1), F32(0)
TANH_TABLE = np.tanh(np.arange(-16, 16, dtype=np.float64)).astype(F32)
_PHASE_SCALE = F32(65536.0 / (2 * np.pi))
_INV_Q = F32(1.0 / (1 << 14))
_A = 1 << 14
_B = int((2 - 3.14159 / 4) * (1 << 14))
_C = _B - (1 << 14)
FLOAT_LEAVES = ("t_phase", "t_freq", "t_prev", "p_phase", "p_freq", "p_err",
                "updown", "agc_gain", "agc_bias_re", "agc_bias_im",
                "inphase")
INT_LEAVES = ("locked", "locked_once", "slot")


def _fast_sin_formula(x16: np.ndarray) -> np.ndarray:
    """The Q14 parabolic sine of sincos.c:12-34 at 16-bit angles."""
    sign = x16 < 0
    x = (x16.astype(np.int32) & 0x7FFF) - (1 << 14)
    x2 = (x * x) >> 14
    y = _B - ((x2 * _C) >> 14)
    y = _A - ((x2 * y) >> 14)
    y = np.where(sign, -y, y)
    return (y.astype(F32) * _INV_Q).astype(F32)


# The sine at every 16-bit angle, by its unsigned bits.
SIN_TABLE = _fast_sin_formula(np.arange(65536).astype(np.uint16)
                              .view(np.int16))
# tanh at -16..15 stored so that a negative index reads its own entry.
TANH_WRAP = np.concatenate([TANH_TABLE[16:], TANH_TABLE[:16]])


def fast_sin(fx: np.ndarray) -> np.ndarray:
    """sin of a float32 phase: the phase becomes a wrapped 16-bit angle by
    a float32 multiply and truncation toward zero (sincos.c:23), then the
    parabola's value at that angle."""
    return SIN_TABLE[(fx * _PHASE_SCALE).astype(np.int32) & 0xFFFF]


def lut_tanh(v: np.ndarray) -> np.ndarray:
    """tanh by the truncated argument, clamped to -16..15 (pll.c:153-159)."""
    return TANH_WRAP[np.minimum(np.maximum(v, -16.0), 15.0).astype(np.int32)]


def initial_state(lanes: int, cst: dict) -> dict:
    """The state every stream starts from (pll.c:24-44, timing.c:18-27,
    agc.c:9-10)."""
    z = lambda v: np.full(lanes, v, F32)
    st = dict(t_phase=z(0), t_freq=z(cst["t_center"]), t_prev=z(0),
              p_phase=z(0), p_freq=z(0), p_err=z(1000), updown=z(1),
              agc_gain=z(1), agc_bias_re=z(0), agc_bias_im=z(0), inphase=z(0))
    st.update(locked=np.zeros(lanes, np.int32),
              locked_once=np.zeros(lanes, np.int32),
              slot=np.ones(lanes, np.int32))
    return st


def _gate(tp, tf, thresh, rem, K):
    """The closed-form timing gate for every lane: (fired, k). k* is the
    least k >= 1 with fl(k*tf) >= fl(thresh - tp); fl(k*tf) rises with k,
    so k* lies within four of floor(diff/tf) - 1 and is found by stepping
    up from there. A gate that does not fire within min(rem, K) ticks
    consumes min(rem, K)."""
    diff = thresh - tp
    k = np.maximum(np.ceil(diff / tf) - ONE, ONE)
    for _ in range(3):
        k += k * tf < diff
    lim = np.minimum(rem, K)
    fired = k <= lim
    return fired, np.where(fired, k, lim)


def run_block(cst: dict, st: dict, ticks: np.ndarray):
    """Consume one block of ticks (lanes, T) complex64 in every lane.

    st is updated in place. Returns (re, im, locked_once, count): the
    symbols each lane produced, left-justified in (lanes, S) arrays, and
    their number a lane."""
    lanes, T = ticks.shape
    oqpsk = cst["oqpsk"]
    K = cst["gate_candidates"]
    c = lambda v: np.full(lanes, v, F32)
    K = c(cst["gate_candidates"])
    a_t, b_t, a_p, b_p = (c(cst[k]) for k in ("a_t", "b_t", "a_p", "b_p"))
    t_center, t_dev, fmax = c(cst["t_center"]), c(cst["t_dev"]), c(cst["fmax"])
    n_dev, n_fmax = -t_dev, -fmax
    bias_keep, bias_pole = c(1 - P.AGC_BIAS_POLE), c(P.AGC_BIAS_POLE)
    gain_pole, target = c(P.AGC_GAIN_POLE), c(P.AGC_TARGET)
    err_keep, err_pole = c(1 - P.ERR_POLE), c(P.ERR_POLE)
    sweep, lock_th = c(P.SWEEP_STEP), c(P.LOCK_THRESH)
    unlock_th = c(P.UNLOCK_THRESH)
    two_pi, pi, half_pi, one, zero = (c(v) for v in (TWO_PI, PI, HALF_PI,
                                                     ONE, ZERO))
    m_one = -one

    s = {k: np.array(v) for k, v in st.items()}
    tp, tf, prev = s["t_phase"], s["t_freq"], s["t_prev"]
    pp, pf, perr = s["p_phase"], s["p_freq"], s["p_err"]
    updown, gain, inphase = s["updown"], s["agc_gain"], s["inphase"]
    b_re, b_im = s["agc_bias_re"], s["agc_bias_im"]
    locked, lonce = s["locked"] != 0, s["locked_once"] != 0
    slot2 = s["slot"] == 2

    per_fire = float(cst["t_center"]) * (1 - 2.0 ** -P.FREQ_DEV_EXP)
    cap = int(T * per_fire / (2 * np.pi)) + 16
    o_re = np.zeros((lanes, cap), F32)
    o_im = np.zeros((lanes, cap), F32)
    o_lo = np.zeros((lanes, cap), np.int32)
    count = np.zeros(lanes, np.int64)
    t = np.zeros(lanes, F32)          # ticks consumed: exact below 2**24
    Tf = F32(T)
    tr, ti = ticks.real.astype(F32).reshape(-1), ticks.imag.astype(F32
                                                                  ).reshape(-1)
    base = np.arange(lanes, dtype=np.int64) * T
    every = np.arange(lanes)
    while True:
        act = t < Tf
        n_act = np.count_nonzero(act)
        if not n_act:
            break
        thresh = np.where(slot2, two_pi, pi) if oqpsk else two_pi
        fired, k = _gate(tp, tf, thresh, Tf - t, K)
        if n_act < lanes:
            k = np.where(act, k, zero)
            fired &= act
        tp = tp + k * tf
        t = t + k
        n_fired = np.count_nonzero(fired)
        if not n_fired:
            continue
        all_fired = n_fired == lanes
        at = base + t.astype(np.int64) - 1
        zr0, zi0 = tr[at], ti[at]
        fire_slot2 = slot2
        if oqpsk:
            slot2 = slot2 ^ fired

        # AGC (agc.c:12-25)
        nb_re = b_re * bias_keep + bias_pole * zr0
        nb_im = b_im * bias_keep + bias_pole * zi0
        if not all_fired:
            nb_re = np.where(fired, nb_re, b_re)
            nb_im = np.where(fired, nb_im, b_im)
        b_re, b_im = nb_re, nb_im
        zr = (zr0 - b_re) * gain
        zi = (zi0 - b_im) * gain
        mag = np.sqrt(zr * zr + zi * zi)
        ng = np.maximum(gain + gain_pole * (target - mag), zero)
        gain = ng if all_fired else np.where(fired, ng, gain)

        # PLL mix (pll.c:50-97)
        npp = -pp
        sn, cn = fast_sin(npp), fast_sin(npp + half_pi)
        mre = zr * cn - zi * sn
        mim = zr * sn + zi * cn
        pp2 = pp + pf
        pp2 = np.where(pp2 >= two_pi, pp2 - two_pi, pp2)
        pp = pp2 if all_fired else np.where(fired, pp2, pp)

        if oqpsk:
            inphase = np.where(fired & ~fire_slot2, mre, inphase)
            sym = fired & fire_slot2
            s_re = inphase
            n_sym = np.count_nonzero(sym)
            if not n_sym:
                continue
            all_sym = n_sym == lanes
        else:
            sym, s_re, all_sym = fired, mre, all_fired
        s_im = mim

        # M&M retiming (timing.c:59-95); sgn(0) = +1 (utils.h:26)
        err_t = (np.where(prev < 0, m_one, one) * s_im
                 - np.where(s_im < 0, m_one, one) * prev)
        ntp = tp - (two_pi + a_t * err_t)
        fd = np.minimum(np.maximum((tf - t_center) - b_t * err_t, n_dev),
                        t_dev)
        ntf = t_center + fd

        # Costas loop, lock detector and sweep (pll.c:99-130)
        e = lut_tanh(s_re) * s_im - lut_tanh(s_im) * s_re
        npp = np.fmod(pp + a_p * e, two_pi)
        npf = pf + b_p * e
        nerr = perr * err_keep + np.abs(e) * err_pole
        go = (nerr < lock_th) & ~locked
        drop = (nerr > unlock_th) & locked
        nlocked = (locked | go) & ~drop
        nlonce = lonce | go
        npf = np.where(nlocked, npf, npf + sweep * updown)
        nud = np.where(npf >= fmax, m_one,
                       np.where(npf <= n_fmax, one, updown))
        npf = np.minimum(np.maximum(npf, n_fmax), fmax)
        if all_sym:
            prev, tp, tf, pp, pf, perr = s_im, ntp, ntf, npp, npf, nerr
            locked, lonce, updown = nlocked, nlonce, nud
            idx = every
        else:
            prev = np.where(sym, s_im, prev)
            tp = np.where(sym, ntp, tp)
            tf = np.where(sym, ntf, tf)
            pp = np.where(sym, npp, pp)
            pf = np.where(sym, npf, pf)
            perr = np.where(sym, nerr, perr)
            locked = np.where(sym, nlocked, locked)
            lonce = np.where(sym, nlonce, lonce)
            updown = np.where(sym, nud, updown)
            idx = np.nonzero(sym)[0]
        pos = count[idx]
        o_re[idx, pos] = s_re[idx]
        o_im[idx, pos] = s_im[idx]
        o_lo[idx, pos] = lonce[idx]
        count[idx] += 1

    st.update(t_phase=tp, t_freq=tf, t_prev=prev, p_phase=pp, p_freq=pf,
              p_err=perr, updown=updown, agc_gain=gain, agc_bias_re=b_re,
              agc_bias_im=b_im, inphase=inphase,
              locked=locked.astype(np.int32),
              locked_once=lonce.astype(np.int32),
              slot=np.where(slot2, 2, 1).astype(np.int32))
    return o_re, o_im, o_lo, count


def run_block_one(cst: dict, st: dict, ticks: np.ndarray):
    """run_block for a single lane, fire by fire on float32 scalars: the
    same operations in the same order, each rounded once, so the same
    bits; several times faster than the vector form at one lane, which
    is what a lane through a whole acquisition needs. st holds (1,)
    leaves; ticks is (1, T)."""
    T = ticks.shape[-1]
    oqpsk = cst["oqpsk"]
    K = F32(cst["gate_candidates"])
    a_t, b_t, a_p, b_p = (F32(cst[k]) for k in ("a_t", "b_t", "a_p", "b_p"))
    t_center, t_dev, fmax = (F32(cst[k]) for k in ("t_center", "t_dev",
                                                    "fmax"))
    n_dev, n_fmax = -t_dev, -fmax
    bias_keep, bias_pole = F32(1 - P.AGC_BIAS_POLE), F32(P.AGC_BIAS_POLE)
    gain_pole, target = F32(P.AGC_GAIN_POLE), F32(P.AGC_TARGET)
    err_keep, err_pole = F32(1 - P.ERR_POLE), F32(P.ERR_POLE)
    sweep, lock_th = F32(P.SWEEP_STEP), F32(P.LOCK_THRESH)
    unlock_th = F32(P.UNLOCK_THRESH)
    m_one, f16, f15 = -ONE, F32(-16.0), F32(15.0)
    two_pi_f = float(TWO_PI)

    g = {k: v.reshape(-1)[0] for k, v in st.items()}
    tp, tf, prev = g["t_phase"], g["t_freq"], g["t_prev"]
    pp, pf, perr = g["p_phase"], g["p_freq"], g["p_err"]
    updown, gain, inphase = g["updown"], g["agc_gain"], g["inphase"]
    b_re, b_im = g["agc_bias_re"], g["agc_bias_im"]
    locked, lonce = bool(g["locked"]), bool(g["locked_once"])
    slot2 = int(g["slot"]) == 2
    tr = ticks.real.astype(F32).reshape(-1)
    ti = ticks.imag.astype(F32).reshape(-1)
    sin_t, tanh_t, scale = SIN_TABLE, TANH_WRAP, _PHASE_SCALE

    def tanh1(v):
        v = v if v >= f16 else f16
        return tanh_t[int(v if v <= f15 else f15)]

    o_re, o_im, o_lo = [], [], []
    t, Tf = ZERO, F32(T)
    while t < Tf:
        thresh = (TWO_PI if slot2 else PI) if oqpsk else TWO_PI
        diff = thresh - tp
        k = np.ceil(diff / tf) - ONE
        k = k if k >= ONE else ONE
        for _ in range(3):
            if k * tf < diff:
                k = k + ONE
        rem = Tf - t
        lim = rem if rem <= K else K
        fired = k <= lim
        if not fired:
            k = lim
        tp = tp + k * tf
        t = t + k
        if not fired:
            continue
        at = int(t) - 1
        zr0, zi0 = tr[at], ti[at]
        fire_slot2 = slot2
        if oqpsk:
            slot2 = not slot2

        b_re = b_re * bias_keep + bias_pole * zr0
        b_im = b_im * bias_keep + bias_pole * zi0
        zr = (zr0 - b_re) * gain
        zi = (zi0 - b_im) * gain
        mag = np.sqrt(zr * zr + zi * zi)
        ng = gain + gain_pole * (target - mag)
        gain = ng if ng >= ZERO else ZERO

        npp = -pp
        sn = sin_t[int(npp * scale) & 0xFFFF]
        cn = sin_t[int((npp + HALF_PI) * scale) & 0xFFFF]
        mre = zr * cn - zi * sn
        mim = zr * sn + zi * cn
        pp2 = pp + pf
        pp = pp2 - TWO_PI if pp2 >= TWO_PI else pp2

        if oqpsk:
            if not fire_slot2:
                inphase = mre
                continue
            s_re = inphase
        else:
            s_re = mre
        s_im = mim

        err_t = ((-s_im if prev < ZERO else s_im)
                 - (-prev if s_im < ZERO else prev))
        ntp = tp - (TWO_PI + a_t * err_t)
        fd = (tf - t_center) - b_t * err_t
        fd = fd if fd >= n_dev else n_dev
        fd = fd if fd <= t_dev else t_dev
        ntf = t_center + fd

        e = tanh1(s_re) * s_im - tanh1(s_im) * s_re
        npp = F32(math.fmod(float(pp + a_p * e), two_pi_f))
        npf = pf + b_p * e
        nerr = perr * err_keep + abs(e) * err_pole
        go = nerr < lock_th and not locked
        drop = nerr > unlock_th and locked
        nlocked = (locked or go) and not drop
        lonce = lonce or go
        if not nlocked:
            npf = npf + sweep * updown
        if npf >= fmax:
            updown = m_one
        elif npf <= n_fmax:
            updown = ONE
        npf = npf if npf >= n_fmax else n_fmax
        npf = npf if npf <= fmax else fmax
        prev, tp, tf, pp, pf, perr = s_im, ntp, ntf, npp, npf, nerr
        locked = nlocked
        o_re.append(s_re)
        o_im.append(s_im)
        o_lo.append(lonce)

    a = lambda v: np.array([v], F32)
    st.update(t_phase=a(tp), t_freq=a(tf), t_prev=a(prev), p_phase=a(pp),
              p_freq=a(pf), p_err=a(perr), updown=a(updown),
              agc_gain=a(gain), agc_bias_re=a(b_re), agc_bias_im=a(b_im),
              inphase=a(inphase),
              locked=np.array([int(locked)], np.int32),
              locked_once=np.array([int(lonce)], np.int32),
              slot=np.array([2 if slot2 else 1], np.int32))
    n = len(o_re)
    return (np.array(o_re, F32)[None], np.array(o_im, F32)[None],
            np.array(o_lo, np.int32)[None], np.array([n], np.int64))
