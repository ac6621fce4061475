"""Sequential numpy oracle: per-fire, float32-exact demodulation.

This is the executable specification of the demodulator semantics
(demod.c:23-91 and the dsp/ blocks), written to perform the *same float32
operations in the same order* as kernels/block_demod.py's plain torch
recurrence and its CUDA kernel. It serves three purposes:

1. Differential testing: the batched paths must match this oracle
   bit-for-bit when both consume the same FIR outputs.
2. Exact fallback: if a block trips a safety flag (unconsumed ticks —
   pathological inputs only), StreamDemodulator recomputes that block here
   and resumes the fast path with the corrected carry.
3. Documentation of the recurrence in its simplest form.

Timing-gate semantics (shared by all three implementations): the gate fires
at candidate k* = min{k in [1, K] : fl(k*tf) >= fl(thresh - tp)} with
K = cfg.gate_candidates; the phase then advances by fl(k* * tf) in one
multiply+add. Every operation is a plain IEEE f32 multiply, subtract, add or
compare, rounded separately (the CUDA kernel is built with -fmad=false and
writes its chains with __fmul_rn/__fadd_rn), so numpy, torch and the kernel
agree bitwise. This deliberately differs from the C reference's per-tick
`_phase += _freq` accumulation (timing.c:31-38) by bounded rounding (<= K
ulp per symbol period); parity with the C binary is within the SNR bound,
as it must be for any float32 implementation, since the C retime mixes
double and float arithmetic.

It is deliberately slow (pure Python per fire); use it on test-sized inputs.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..config import DemodConfig
from ..dsp.fir import make_fir_banks, fir_reference_np
from ..dsp.sincos import fast_sin_np, fast_cos_np
from ..dsp.loops import costas_error_np, mm_error_np

_F32 = np.float32
_TWO_PI = _F32(2 * np.pi)
_PI = _F32(np.pi)


def initial_state(cfg: DemodConfig) -> dict:
    return dict(
        t_phase=_F32(0.0), t_freq=_F32(cfg.timing_freq), t_prev=_F32(0.0),
        p_phase=_F32(0.0), p_freq=_F32(0.0), p_err=_F32(1000.0),
        locked=0, locked_once=0, updown=_F32(1.0),
        agc_gain=_F32(1.0), agc_bias=np.complex64(0.0),
        inphase=_F32(0.0), slot=1,
        fir_tail=np.zeros(cfg.taps - 1, dtype=np.complex64),
    )


def gate_fire_np(tp, tf, thresh, rem, ks):
    """Closed-form timing gate (see module docstring).

    Returns (fired, k): k ticks are consumed; fired says whether tick
    t+k-1 is a symbol sample. When not fired, k = min(rem, K).
    """
    diff = _F32(thresh - tp)
    prod = (ks * tf).astype(_F32)
    ok = np.logical_and(prod >= diff, ks <= _F32(rem))
    if not ok.any():
        return False, min(int(rem), len(ks))
    return True, int(ok.argmax()) + 1


def demod_stream_np(cfg: DemodConfig, x: np.ndarray, state: dict | None = None,
                    F: np.ndarray | None = None):
    """Demodulate x (complex64) sequentially.

    Args:
      cfg: demod configuration.
      x: (N,) complex64 input samples.
      state: carry dict (from initial_state or a previous call); mutated copy
        is returned.
      F: optional precomputed (N, interp) FIR outputs (e.g. from the torch
        conv path) — pass to make the comparison with
        kernels/block_demod.py bit-exact.

    Returns:
      (symbols, state): symbols is a structured array with fields
      re, im (float32) and locked_once (int32), one row per produced symbol.
    """
    st = dict(state) if state is not None else initial_state(cfg)
    banks = make_fir_banks(cfg)
    if F is None:
        F = fir_reference_np(x, st["fir_tail"], banks)
    F_flat = np.ascontiguousarray(F).reshape(-1)

    a_t, b_t = cfg.timing_gains
    a_p, b_p = cfg.pll_gains
    t_center = cfg.timing_freq
    t_dev = cfg.timing_dev_max
    fmax = cfg.pll_fmax
    oqpsk = cfg.oqpsk
    ks = np.arange(1, cfg.gate_candidates + 1, dtype=np.float32)

    bias_keep = _F32(1.0 - C.AGC_BIAS_POLE)
    bias_pole = _F32(C.AGC_BIAS_POLE)
    gain_pole = _F32(C.AGC_GAIN_POLE)
    agc_target = _F32(C.AGC_TARGET)
    err_keep = _F32(1.0 - C.ERR_POLE)
    err_pole = _F32(C.ERR_POLE)
    sweep = _F32(C.SWEEP_STEP)
    lock_th = _F32(C.LOCK_THRESH)
    unlock_th = _F32(C.UNLOCK_THRESH)

    tp = st["t_phase"]; tf = st["t_freq"]; prev = st["t_prev"]
    pp = st["p_phase"]; pf = st["p_freq"]; perr = st["p_err"]
    locked = st["locked"]; locked_once = st["locked_once"]; updown = st["updown"]
    gain = st["agc_gain"]; bias = st["agc_bias"]
    inphase = st["inphase"]; slot = st["slot"]

    out_re, out_im, out_lo = [], [], []
    T = len(F_flat)
    t = 0
    while t < T:
        thresh = _F32(slot) * _PI if oqpsk else _TWO_PI
        fired, k = gate_fire_np(tp, tf, thresh, T - t, ks)
        tp = _F32(tp + _F32(_F32(k) * tf))
        t += k
        if not fired:
            continue
        tau = t - 1
        fire_slot = slot
        if oqpsk:
            slot = (slot % 2) + 1

        z = F_flat[tau]

        # AGC (agc.c:12-25)
        bias = np.complex64(bias * bias_keep + bias_pole * z)
        zc = np.complex64((z - bias) * gain)
        zr = _F32(zc.real); zi = _F32(zc.imag)
        mag = _F32(np.sqrt(_F32(zr * zr + zi * zi)))
        gain = _F32(gain + gain_pole * (agc_target - mag))
        gain = max(_F32(0.0), gain)

        # PLL mix (pll.c:50-97)
        sn = fast_sin_np(_F32(-pp))
        cn = fast_cos_np(_F32(-pp))
        mre = _F32(zr * cn - zi * sn)
        mim = _F32(zr * sn + zi * cn)
        pp = _F32(pp + pf)
        if pp >= _TWO_PI:
            pp = _F32(pp - _TWO_PI)

        if oqpsk and fire_slot == 1:
            inphase = mre
            continue
        if oqpsk:
            sym_re, sym_im = inphase, mim
        else:
            sym_re, sym_im = mre, mim

        # M&M retiming (timing.c:59-95)
        err_t = mm_error_np(prev, sym_im)
        prev = sym_im
        tp = _F32(tp - _F32(_TWO_PI + _F32(a_t * err_t)))
        fd = _F32(_F32(tf - t_center) - _F32(b_t * err_t))
        fd = max(-t_dev, min(t_dev, fd))
        tf = _F32(t_center + fd)

        # Costas update (pll.c:99-130)
        e = costas_error_np(sym_re, sym_im)
        pp = _F32(np.fmod(_F32(pp + _F32(a_p * e)), _TWO_PI))
        pf = _F32(pf + b_p * e)
        perr = _F32(perr * err_keep + _F32(abs(e)) * err_pole)
        if perr < lock_th and not locked:
            locked = 1
            locked_once = 1
        elif perr > unlock_th and locked:
            locked = 0
        if not locked:
            pf = _F32(pf + sweep * updown)
        updown = _F32(-1.0) if pf >= fmax else (_F32(1.0) if pf <= -fmax
                                                else updown)
        pf = max(-fmax, min(fmax, pf))

        out_re.append(sym_re)
        out_im.append(sym_im)
        out_lo.append(locked_once)

    taps = cfg.taps
    xin = np.concatenate([st["fir_tail"], x.astype(np.complex64)])
    st.update(
        t_phase=tp, t_freq=tf, t_prev=prev,
        p_phase=pp, p_freq=pf, p_err=perr,
        locked=locked, locked_once=locked_once, updown=updown,
        agc_gain=gain, agc_bias=bias, inphase=inphase, slot=slot,
        fir_tail=xin[-(taps - 1):].copy(),
    )
    symbols = np.zeros(len(out_re),
                       dtype=[("re", np.float32), ("im", np.float32),
                              ("locked_once", np.int32)])
    symbols["re"] = out_re
    symbols["im"] = out_im
    symbols["locked_once"] = out_lo
    return symbols, st
