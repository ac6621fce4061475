"""Meteor-M LRPT baseband, made on the device from a seed.

A torch rewrite of the repo's test-signal synthesizer (meteor_demod_tpu_torch
sim.synth_psk and leo_doppler_hz) for the benchmark's sizes: the symbols
are drawn with a torch.Generator on the device, pulse-shaped by the exact
root-raised-cosine spectrum in the frequency domain (the signal is periodic
over its length, a whole number of symbols), and the carrier is either a
whole number of cycles over that length (a circular shift of the spectrum)
or an overhead pass's Doppler in closed form. So a fleet's loop runs on
across its seam with no jump in symbol clock, carrier or pulse tails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

GM = 3.986004418e14          # m^3/s^2
R_EARTH = 6.371e6            # m
C_LIGHT = 2.99792458e8       # m/s


def rrc_spectrum(f: torch.Tensor, symrate: float, alpha: float
                 ) -> torch.Tensor:
    """|P(f)| of a root-raised-cosine pulse, 1 in the flat band."""
    af = f.abs() / symrate                  # in units of the symbol rate
    lo, hi = (1 - alpha) / 2, (1 + alpha) / 2
    roll = torch.sqrt(0.5 * (1 + torch.cos(math.pi / alpha * (af - lo))))
    return torch.where(af <= lo, torch.ones_like(af),
                       torch.where(af <= hi, roll, torch.zeros_like(af)))


def psk_spectrum(n_streams: int, n_samples: int, fs: float, symrate: float,
                 alpha: float, oqpsk: bool, gen: torch.Generator,
                 device) -> torch.Tensor:
    """(n_streams, n_samples) complex64 DFT of periodic (O)QPSK baseband:
    random +-1 symbols on I and Q, each stream its own, RRC-shaped; for
    OQPSK Q is delayed by half a symbol. n_samples * symrate / fs must be
    whole. Scaled so that each component has unit mean power."""
    n_sym = n_samples * symrate / fs
    if abs(n_sym - round(n_sym)) > 1e-9:
        raise ValueError(f"{n_samples} samples hold {n_sym} symbols: the "
                         f"period must be a whole number of symbols")
    n_sym = int(round(n_sym))
    bits = torch.randint(0, 2, (2, n_streams, n_sym), generator=gen,
                         device=device, dtype=torch.int8)
    sym = bits.to(torch.float32) * 2 - 1
    s_i = torch.fft.fft(sym[0], dim=-1)
    s_q = torch.fft.fft(sym[1], dim=-1)
    del bits, sym
    k = torch.fft.fftfreq(n_samples, d=1.0 / n_samples, device=device,
                          dtype=torch.float64).to(torch.int64)
    f = k.to(torch.float64) * (fs / n_samples)
    keep = (f.abs() <= (1 + alpha) / 2 * symrate).nonzero()[:, 0]
    idx = k[keep] % n_sym
    h = rrc_spectrum(f[keep], symrate, alpha)
    q = s_q[:, idx]
    if oqpsk:
        q = q * torch.exp(-1j * math.pi * f[keep] / symrate).to(
            torch.complex64)
    spec = torch.zeros((n_streams, n_samples), dtype=torch.complex64,
                       device=device)
    spec[:, keep] = (s_i[:, idx] + 1j * q) * h.to(torch.float32)
    # Parseval: mean |x|^2 = sum |X|^2 / n^2; each component gets half.
    power = (spec.abs() ** 2).sum(-1, keepdim=True) / n_samples ** 2
    return spec / torch.sqrt(power / 2)


def pass_phase(n_samples: int, fs: float, f_center_hz: float,
               altitude_km: float, t_ca_s: float, device,
               start: int = 0) -> torch.Tensor:
    """Carrier phase (rad, float64) of an overhead LEO pass's Doppler at
    samples start..start+n_samples: a straight-line flyby at circular-orbit
    speed, closest approach `t_ca_s` into the recording. The Doppler shift
    is -f_c v_r / c with v_r = v^2 t / sqrt(d0^2 + v^2 t^2), so the phase
    is -2 pi f_c / c (sqrt(d0^2 + v^2 t^2) - d0), exactly."""
    h = altitude_km * 1e3
    v = math.sqrt(GM / (R_EARTH + h))
    t = (torch.arange(start, start + n_samples, device=device,
                      dtype=torch.float64) / fs - t_ca_s)
    rng = torch.sqrt(h * h + (v * t) ** 2) - h
    return torch.remainder(-2 * math.pi * f_center_hz / C_LIGHT * rng,
                           2 * math.pi)


def pass_doppler_hz(sample: float, fs: float, f_center_hz: float,
                    altitude_km: float, t_ca_s: float) -> float:
    """The pass's Doppler shift (Hz) at one sample."""
    h = altitude_km * 1e3
    v = math.sqrt(GM / (R_EARTH + h))
    t = sample / fs - t_ca_s
    return -f_center_hz / C_LIGHT * v * v * t / math.sqrt(h * h + (v * t) ** 2)


def seeded(seed: int, device) -> tuple[torch.Generator, np.random.Generator]:
    """The device generator for bulk draws and a host one for per-stream
    parameters, both from the run's seed (any whole number >= 0)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen, np.random.default_rng(int(seed))


def fleet_loop(cfg: dict, mix: dict, seed: int, device) -> tuple:
    """The fleet's loop of IQ: (streams, loop_blocks*block_len, 2) int16 on
    `device`, and the per-stream parameters drawn (a dict of numpy arrays).

    Each live stream has its own symbols, a carrier drawn uniformly over
    mix["carrier_hz"] and snapped to whole cycles of the loop, a phase, an
    amplitude, an SNR and a DC offset; the last mix["dead_streams"] streams
    carry noise only, at the noise level of a stream of the middle SNR."""
    n, fs = int(mix["streams"]), float(cfg["samplerate"])
    n_samples = int(mix["loop_blocks"]) * int(cfg["block_len"])
    gen, rng = seeded(seed, device)
    lo, hi = mix["carrier_hz"]
    bins = np.round(rng.uniform(lo, hi, n) * n_samples / fs).astype(np.int64)
    p = dict(carrier_hz=bins * fs / n_samples,
             phase=rng.uniform(0, 2 * np.pi, n),
             amplitude=rng.uniform(*mix["amplitude"], n),
             snr_db=rng.uniform(*mix["snr_db"], n),
             dc=rng.uniform(-1, 1, (n, 2)) * mix["dc_offset"])
    dead = int(mix["dead_streams"])
    signal = np.ones(n, bool)
    if dead:
        signal[-dead:] = False
    p["signal"] = signal
    spec = psk_spectrum(n, n_samples, fs, float(cfg["symrate"]),
                        float(cfg["rrc_alpha"]), bool(cfg["oqpsk"]), gen,
                        device)
    for b in range(n):                   # the carrier: a circular shift
        spec[b] = torch.roll(spec[b], int(bins[b]))
    x = torch.fft.ifft(spec, dim=-1)
    del spec
    rot = torch.exp(1j * torch.as_tensor(p["phase"], device=device))
    amp = torch.as_tensor(np.where(signal, p["amplitude"], 0.0),
                          device=device)
    x = x * (rot * amp).to(torch.complex64)[:, None]
    mid = 10 ** (-np.mean(mix["snr_db"]) / 20) * np.mean(mix["amplitude"])
    sigma = np.where(signal, p["amplitude"] * 10 ** (-p["snr_db"] / 20), mid)
    noise = torch.randn((n, n_samples, 2), generator=gen, device=device)
    noise *= torch.as_tensor(sigma, dtype=torch.float32,
                             device=device)[:, None, None]
    noise += torch.as_tensor(p["dc"], dtype=torch.float32,
                             device=device)[:, None, :]
    pairs = torch.stack([x.real, x.imag], dim=-1)
    del x
    pairs += noise
    del noise
    return torch.clamp(torch.round(pairs), -32768, 32767).to(torch.int16), p


def pass_samples(cfg: dict, mix: dict, seed: int, device,
                 start: int = 0, n_samples: int | None = None):
    """The pass's IQ: (n, 2) int16 on `device`, samples start..start+n of a
    recording of mix["seconds"] seconds (default: all of it). The carrier
    follows the pass's Doppler with a seeded phase; the noise is at
    mix["snr_db"]. The symbols are periodic over the whole recording, so a
    piece is the same as that part of the whole."""
    fs = float(cfg["samplerate"])
    total = int(round(mix["seconds"] * fs))
    n_samples = total - start if n_samples is None else n_samples
    gen, rng = seeded(seed, device)
    phase0 = rng.uniform(0, 2 * np.pi)
    spec = psk_spectrum(1, total, fs, float(cfg["symrate"]),
                        float(cfg["rrc_alpha"]), bool(cfg["oqpsk"]), gen,
                        device)
    x = torch.fft.ifft(spec[0])[start:start + n_samples]
    del spec
    ph = pass_phase(n_samples, fs, mix["f_center_hz"], mix["altitude_km"],
                    mix["t_ca_s"], device, start=start) + phase0
    x = x * torch.polar(torch.full_like(ph, float(mix["amplitude"])),
                        ph).to(torch.complex64)
    del ph
    sigma = float(mix["amplitude"]) * 10 ** (-float(mix["snr_db"]) / 20)
    # The noise of the whole recording is drawn in pieces of a fixed size,
    # so a piece of it is reproduced without drawing the rest.
    piece = 1 << 22
    first, last = start // piece, -(-(start + n_samples) // piece)
    noise = []
    for i in range(first, last):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1000003 + i) % (2 ** 63))
        noise.append(torch.randn((piece, 2), generator=g, device=device))
    noise = torch.cat(noise)[start - first * piece:][:n_samples] * sigma
    pairs = torch.stack([x.real, x.imag], dim=-1) + noise
    return (torch.clamp(torch.round(pairs), -32768, 32767).to(torch.int16),
            dict(phase0=phase0))


def pass_phase_at(sample: float, fs: float, mix: dict, phase0: float
                  ) -> float:
    """The pass's carrier phase (rad) at a fractional sample time."""
    h = mix["altitude_km"] * 1e3
    v = math.sqrt(GM / (R_EARTH + h))
    t = sample / fs - mix["t_ca_s"]
    rng = math.sqrt(h * h + (v * t) ** 2) - h
    return (phase0 - 2 * math.pi * mix["f_center_hz"] / C_LIGHT * rng
            ) % (2 * math.pi)


def write_wav(path: str, pairs: np.ndarray, samplerate: int) -> None:
    """A canonical 16-bit 2-channel WAV of int16 (n, 2) IQ pairs."""
    import struct
    data = np.ascontiguousarray(pairs, dtype="<i2")
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + data.nbytes,
                         b"WAVE", b"fmt ", 16, 1, 2, samplerate,
                         samplerate * 4, 4, 16, b"data", data.nbytes)
    with open(path, "wb") as f:
        f.write(header)
        data.tofile(f)
