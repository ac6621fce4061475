"""Bit-level end-to-end proof on the port: transmitted bits -> the port's
CLI (python -m meteor_demod_tpu_torch, on the CPU) -> .s -> exact bits.

The cases of tests/test_bits_end_to_end.py: a known symbol sequence is
modulated (sim.synth_psk) at 12 dB, demodulated through the port's CLI file
path, the .s byte stream is hard-decided, and the transmitted symbols must
come back with ZERO errors modulo the demodulator's gauge group (the Costas
4-fold quadrant ambiguity x spectral conjugation; for OQPSK also the
half-symbol I/Q re-pairing) over more than 0.7 of the transmission.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from meteor_demod_tpu_torch.sim import synth_psk, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNR_DB = 12.0
N_SYM = 40000


def _run_cli(wav, out, extra):
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu", PYTHONPATH=REPO)
    subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu_torch", "-B", "-q", "-o",
         out] + extra + [wav],
        check=True, env=env, timeout=600, cwd=REPO)


def _align_and_count(tx: np.ndarray, rx: np.ndarray):
    """Best (errors, overlap) over lag x {4 quadrants} x {conjugate}."""
    best = None
    for conj in (False, True):
        z = np.conj(rx) if conj else rx
        L = 1 << int(np.ceil(np.log2(len(tx) + len(z))))
        c = np.fft.ifft(np.fft.fft(tx, L) * np.conj(np.fft.fft(z, L)))
        lag = int(np.argmax(np.abs(c)))
        if lag > L // 2:
            lag -= L
        s_tx, s_rx = max(0, lag), max(0, -lag)
        n = min(len(tx) - s_tx, len(z) - s_rx)
        if n <= 100:
            continue
        a, b = tx[s_tx:s_tx + n], z[s_rx:s_rx + n]
        g = np.mean(a * np.conj(b))          # snap to the nearest quadrant
        b = b * (1j) ** int(np.round(np.angle(g) / (np.pi / 2)))
        errs = int(np.count_nonzero(
            (np.sign(a.real) != np.sign(b.real))
            | (np.sign(a.imag) != np.sign(b.imag))))
        if best is None or errs < best[0]:
            best = (errs, n)
    assert best is not None, "no usable alignment"
    return best


def _recover(tx: np.ndarray, s_path: str, oqpsk: bool):
    raw = np.fromfile(s_path, np.int8).astype(np.float32).reshape(-1, 2)
    I, Q = np.sign(raw[:, 0]), np.sign(raw[:, 1])
    variants = [I + 1j * Q]
    if oqpsk:
        # An odd-quadrant OQPSK lock relabels the half-symbol-offset
        # streams one slot apart: the decoder's ambiguity group includes the
        # two re-pairings.
        variants += [I[1:] + 1j * Q[:-1], I[:-1] + 1j * Q[1:]]
    errs, n = min(_align_and_count(tx, v) for v in variants)
    return errs, n, len(raw)


@pytest.mark.parametrize("oqpsk,symrate,fs,extra", [
    (False, 72000.0, 230400, []),
    (True, 80000.0, 240000, ["-m", "oqpsk", "-r", "80000"]),
], ids=["qpsk", "oqpsk"])
def test_prbs_bits_recovered_exactly(tmp_path, oqpsk, symrate, fs, extra):
    x, sym = synth_psk(N_SYM, fs, symrate=symrate, oqpsk=oqpsk,
                       carrier_hz=250.0, amplitude=6000.0,
                       snr_db=SNR_DB, seed=31)
    wav, out = str(tmp_path / "p.wav"), str(tmp_path / "p.s")
    write_wav(wav, x, fs, 16)
    _run_cli(wav, out, extra + ["-s", str(fs)])
    tx = (sym[:, 0] + 1j * sym[:, 1]).astype(np.complex128)
    errs, overlap, _ = _recover(tx, out, oqpsk)
    assert errs == 0, f"{errs} bit errors over {overlap} symbols"
    assert overlap > 0.7 * N_SYM, (overlap, N_SYM)


def test_prbs_bits_recovered_under_doppler_ramp(tmp_path):
    """The same on a carrier ramping at 400 Hz/s (~13x a real LEO pass's
    peak rate): tracking the ramp costs no bit."""
    fs = 230400
    x, sym = synth_psk(N_SYM, fs, carrier_hz=150.0, carrier_ramp_hz_s=400.0,
                       amplitude=6000.0, snr_db=SNR_DB, seed=32)
    wav, out = str(tmp_path / "p.wav"), str(tmp_path / "p.s")
    write_wav(wav, x, fs, 16)
    _run_cli(wav, out, ["-s", str(fs)])
    tx = (sym[:, 0] + 1j * sym[:, 1]).astype(np.complex128)
    errs, overlap, _ = _recover(tx, out, oqpsk=False)
    assert errs == 0, f"{errs} bit errors over {overlap} symbols"
    assert overlap > 0.7 * N_SYM, (overlap, N_SYM)
