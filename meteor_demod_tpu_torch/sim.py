"""Test-signal synthesizer: QPSK/OQPSK baseband IQ with impairments.

Generates RRC-shaped (O)QPSK at an arbitrary sample rate with carrier offset,
phase, timing skew, gain, DC bias, and AWGN — the fixture generator for
golden tests against the reference demodulator and for benchmarks. Pure
numpy; float64 synthesis quantized at the end.
"""

from __future__ import annotations

import numpy as np

from .dsp.rrc import rrc_coeffs


def synth_psk(num_symbols: int,
              samplerate: float,
              symrate: float = 72000.0,
              alpha: float = 0.6,
              oqpsk: bool = False,
              carrier_hz: float = 0.0,
              carrier_phase: float = 0.0,
              amplitude: float = 8000.0,
              snr_db: float = 30.0,
              dc_offset: complex = 0.0,
              seed: int = 0,
              timing_offset: float = 0.0,
              carrier_ramp_hz_s: float = 0.0,
              carrier_profile=None):
    """Returns (iq complex64 at samplerate, symbols (I,Q) in {+-1}).

    The signal is synthesized on a fine integer grid (R x symbol rate, with
    R*symrate an integer multiple of samplerate when possible) and decimated,
    so fractional sample-per-symbol ratios like 230400/72000 = 3.2 are exact.

    Carrier dynamics (the reference's actual operating regime — a LEO
    satellite's Doppler ramp, the reference's pll.c:99-106 tracks it with
    the loop's frequency integrator): `carrier_ramp_hz_s` adds a linear
    frequency ramp, and `carrier_profile` (a per-sample instantaneous
    frequency array in Hz, e.g. from `leo_doppler_hz`) adds an arbitrary
    trajectory; both are additive with `carrier_hz`. The phase is the
    cumulative integral of the instantaneous frequency, so any profile is
    phase-continuous. When both are zero/None the original closed-form
    constant-carrier phase is used, keeping existing fixtures bit-identical.
    """
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(num_symbols, 2))
    sym = (2 * bits - 1).astype(np.float64)          # (+-1, +-1)

    # Fine grid: R samples per symbol such that decim = R*symrate/samplerate
    # is an integer.
    R = None
    for cand in (16, 20, 24, 32, 40, 48, 64, 80, 100):
        d = cand * symrate / samplerate
        if abs(d - round(d)) < 1e-9 and round(d) >= 1:
            R = cand
            decim = int(round(d))
            break
    if R is None:
        # Exact rational grid for arbitrary ratios: decim/R must equal
        # symrate/samplerate EXACTLY — rounding it (the old fallback)
        # synthesizes a signal whose true baud is off by up to ~1%, far
        # beyond the demod's 2^-12 M&M clamp, producing marginal
        # pseudo-locks instead of a clean signal (e.g. 230400/80000 needs
        # R = 72k, not any small candidate).
        from fractions import Fraction
        fr = Fraction(float(symrate) / float(samplerate))
        fr = fr.limit_denominator(4096)
        k = max(1, -(-16 // fr.denominator))     # fine grid >= 16 samp/sym
        if fr.denominator * k % 2:
            k *= 2                               # R even: exact R//2 Q delay
        R, decim = k * fr.denominator, k * fr.numerator

    up_i = np.zeros(num_symbols * R)
    up_q = np.zeros(num_symbols * R)
    up_i[::R] = sym[:, 0]
    up_q[::R] = sym[:, 1]
    if oqpsk:
        # Half-symbol delay on Q (the mode's defining property).
        up_q = np.roll(up_q, R // 2)
        up_q[:R // 2] = 0.0

    span = 16  # symbols of pulse on each side
    taps = rrc_coeffs(2 * span * R + 1, float(R), alpha).astype(np.float64)
    taps = taps / np.sqrt(np.sum(taps ** 2)) * np.sqrt(R)
    shaped = (np.convolve(up_i, taps, mode="same")
              + 1j * np.convolve(up_q, taps, mode="same"))

    # Timing offset (fraction of a symbol), then decimate to samplerate.
    shift = int(round(timing_offset * R))
    if shift:
        shaped = np.roll(shaped, shift)
    x = shaped[::decim] * amplitude

    # Carrier offset + phase.
    n = np.arange(len(x))
    if carrier_ramp_hz_s == 0.0 and carrier_profile is None:
        # Constant carrier: keep the exact original closed form so legacy
        # fixtures stay bit-identical (seeded tests pin these streams).
        x = x * np.exp(1j * (2 * np.pi * carrier_hz / samplerate * n
                             + carrier_phase))
    else:
        t = n / samplerate
        f_inst = carrier_hz + carrier_ramp_hz_s * t
        if carrier_profile is not None:
            prof = np.asarray(carrier_profile, dtype=np.float64)
            if len(prof) != len(x):
                raise ValueError(
                    f"carrier_profile length {len(prof)} != {len(x)} samples")
            f_inst = f_inst + prof
        # theta[n] = phase + 2*pi/fs * sum_{k<n} f[k]  (rectangle rule on the
        # sample grid; reduces to the closed form for constant f).
        theta = carrier_phase + (2 * np.pi / samplerate) * np.concatenate(
            ([0.0], np.cumsum(f_inst[:-1])))
        x = x * np.exp(1j * theta)

    # AWGN at the requested SNR (relative to mean signal power).
    p_sig = np.mean(np.abs(x) ** 2)
    p_noise = p_sig / (10 ** (snr_db / 10))
    noise = (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    x = x + noise * np.sqrt(p_noise / 2)
    x = x + dc_offset

    return x.astype(np.complex64), sym.astype(np.float32)


def leo_doppler_hz(num_samples: int,
                   samplerate: float,
                   f_center_hz: float = 137.9e6,
                   altitude_km: float = 820.0,
                   cross_track_km: float = 0.0,
                   t_ca_s: float = 0.0,
                   time_scale: float = 1.0) -> np.ndarray:
    """Per-sample Doppler shift (Hz) of a LEO pass — the carrier trajectory
    the reference demodulator actually tracks (Meteor-M at ~820 km on
    137.1/137.9 MHz, the reference's README.md:1-9).

    Straight-line flyby model: the satellite moves at circular-orbit speed
    v = sqrt(GM/(Re+h)) along a line whose closest approach to the receiver
    is d0 = sqrt(altitude^2 + cross_track^2) at time `t_ca_s` (seconds into
    the recording).  Radial velocity v_r(t) = v^2 (t-tca)/sqrt(d0^2 +
    v^2 (t-tca)^2), Doppler f_d = -f_c v_r / c.  For an overhead Meteor-M
    pass this gives the familiar S-curve: excursion ~±3.4 kHz with the
    steepest slope ~31 Hz/s at closest approach.

    `time_scale` > 1 compresses the pass (multiplies every rate by that
    factor) so short CI fixtures can traverse a realistic frequency span —
    the loop stress is the Hz/s slope, which scales linearly.
    """
    GM = 3.986004418e14          # m^3/s^2
    RE = 6.371e6                 # m
    C = 2.99792458e8             # m/s
    h = altitude_km * 1e3
    v = np.sqrt(GM / (RE + h))   # ~7.45 km/s at 820 km
    d0 = np.hypot(h, cross_track_km * 1e3)
    t = (np.arange(num_samples) / samplerate - t_ca_s) * time_scale
    vr = v * v * t / np.sqrt(d0 * d0 + (v * t) ** 2)
    return -(f_center_hz / C) * vr


def encode_iq(iq: np.ndarray, bps: int = 16) -> bytes:
    """Interleaved I/Q payload bytes in the reference's sample formats."""
    n = len(iq)
    if bps == 16:
        data = np.empty(2 * n, dtype="<i2")
        data[0::2] = np.clip(np.round(np.real(iq)), -32768, 32767).astype("<i2")
        data[1::2] = np.clip(np.round(np.imag(iq)), -32768, 32767).astype("<i2")
    elif bps == 8:
        data = np.empty(2 * n, dtype=np.uint8)
        data[0::2] = np.clip(np.round(np.real(iq)) + 128, 0, 255).astype(np.uint8)
        data[1::2] = np.clip(np.round(np.imag(iq)) + 128, 0, 255).astype(np.uint8)
    elif bps == 32:
        data = np.empty(2 * n, dtype="<f4")
        data[0::2] = np.real(iq).astype("<f4")
        data[1::2] = np.imag(iq).astype("<f4")
    else:
        raise ValueError(f"bps {bps}")
    return data.tobytes()


def write_wav(path: str, iq: np.ndarray, samplerate: int, bps: int = 16) -> None:
    """Write IQ as a canonical 2-channel WAV the reference can read."""
    import struct
    payload = encode_iq(iq, bps)
    byte_rate = samplerate * 2 * bps // 8
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload), b"WAVE", b"fmt ", 16,
        3 if bps == 32 else 1, 2, samplerate, byte_rate,
        2 * bps // 8, bps, b"data", len(payload))
    with open(path, "wb") as f:
        f.write(header)
        f.write(payload)


def write_raw(path: str, iq: np.ndarray, bps: int = 16) -> None:
    """Write raw interleaved IQ (the rtl_sdr-pipe format, README.md:75)."""
    with open(path, "wb") as f:
        f.write(encode_iq(iq, bps))
