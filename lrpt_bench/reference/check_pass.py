"""The pass's reference run and its comparison with the .s file.

The .s of `-T 0` is the sequential demodulation of the whole recording,
the rest after its first chunk in every hard decision (turbo's contract
with strict=True). The sequential's acquisition carries every rounding
forward: a float32 filter that sums in another order locks a few symbols
earlier or later, in another quadrant, and (OQPSK) creeps from its first,
marginal lock to the carrier over a different stretch. So the reference
cannot reproduce the acquisition's bytes, and checks what every sound
float32 program shares:

- the start: one lane from the recording's first sample and the initial
  state (fire by fire, oracle.run_block_one) until it has tracked the
  pass's carrier for `settle_blocks` blocks. It fixes where the .s is
  checked from, and where its symbols lie;
- segments: lanes started `segment_warmup_blocks` before segments drawn
  from the seed over the rest of the recording (from twice the start
  lane's length on, as another rounding may acquire later; one there, one
  at the end), each from a state worked out from the traffic itself
  (carrier phase and Doppler, symbol timing, locked), which converge onto
  the sequential's locked trajectory. Each is found in the .s under the
  demodulator's phase symmetry (QPSK: a quarter turn; OQPSK: a quarter turn
  with the half-symbol relabelling), and every hard decision must agree.
  The first is searched for over the whole acquisition (first_span: from
  the .s's first symbol to where it would lie had the program written from
  the recording's first sample, within the reference's acquisition of its
  prediction; search_all), since the program's acquisition may lock many
  rings from the reference's (OQPSK: a marginal lock that creeps to the
  carrier over hundreds of blocks); the others near their predicted
  places, moved by the offset the first was found at.
  All segments must share one symmetry, the first segment's, and one offset
  from the predicted places within `drift_symbols`, so a chunk assembled in
  another quadrant, or one that drops or repeats symbols, is caught;
- the length: the .s ends where the last segment's place says it does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from . import fir, oracle
from .params import RING_SYMBOLS
from .quantize import first_written_ring, quantize

KEEP = 8        # places of best correlation that search_all judges exactly


def informed_state(cst: dict, cfg: dict, lanes: list) -> dict:
    """lanes: [dict(phase=carrier phase at the lane's first tick's signal
    time, freq_hz=Doppler there, u0=symbol time there, gain=AGC gain)]."""
    st = oracle.initial_state(len(lanes), cst)
    fire_rate = cfg["symrate"] * (2 if cfg["oqpsk"] else 1)
    for i, ln in enumerate(lanes):
        st["p_phase"][i] = np.float32(ln["phase"] % (2 * math.pi))
        st["p_freq"][i] = np.float32(2 * math.pi * ln["freq_hz"] / fire_rate)
        st["locked"][i] = st["locked_once"][i] = 1
        st["p_err"][i] = np.float32(30.0)
        st["agc_gain"][i] = np.float32(ln["gain"])
        fr = ln["u0"] % 1.0
        if not cfg["oqpsk"]:
            st["t_phase"][i] = np.float32(2 * math.pi * fr)
        elif fr < 0.5:
            st["slot"][i] = 2
            st["t_phase"][i] = np.float32(math.pi + 2 * math.pi * fr)
        else:
            st["slot"][i] = 1
            st["t_phase"][i] = np.float32(2 * math.pi * (fr - 0.5))
    return st


def _blocks(x: np.ndarray, first: np.ndarray, L: int, taps: int):
    """Block `first[i]` of the recording x ((N, 2) int16) for each lane,
    and the taps-1 samples before it (zeros before the first sample)."""
    xb = np.zeros((len(first), L, 2), np.int16)
    tb = np.zeros((len(first), taps - 1, 2), np.int16)
    for i, s in enumerate(first):
        p = s * L
        xb[i] = x[p:p + L]
        if p:
            tb[i] = x[p - taps + 1:p]
    return xb, tb


def start_lane(cst: dict, bank: np.ndarray, x: np.ndarray, device,
               tracking, settle: int, max_blocks: int) -> dict:
    """One lane from the first sample and the initial state, block by
    block, until tracking(state, block) has held for `settle` blocks in a
    row or max_blocks have run. Returns its symbols a block, its first
    written ring and the blocks it ran."""
    L, taps = cst["block_len"], bank.shape[1]
    st = oracle.initial_state(1, cst)
    out, held, b = [], 0, 0
    while b < max_blocks and held < settle:
        xb, tb = _blocks(x, np.array([b]), L, taps)
        ticks = fir.fir_block(torch.as_tensor(xb, device=device).float(),
                              torch.as_tensor(tb, device=device).float(),
                              bank)
        re, im, lo, cnt = oracle.run_block_one(cst, st, ticks)
        out.append((re[0, :cnt[0]], im[0, :cnt[0]], lo[0, :cnt[0]]))
        held = held + 1 if tracking(st, b) else 0
        b += 1
    lo = np.concatenate([p[2] for p in out])
    return dict(blocks=out, end=b, tracked=held >= settle,
                first_ring=first_written_ring(lo),
                counts=np.array([len(p[0]) for p in out]))


def run_lanes(cst: dict, bank: np.ndarray, x: np.ndarray, starts: list,
              state: dict, n_blocks: int, device) -> list:
    """Run lane i over blocks starts[i] .. starts[i]+n_blocks of the
    recording x ((N, 2) int16) from state. Returns per lane a list of
    (re, im, locked_once) per block."""
    L, taps = cst["block_len"], bank.shape[1]
    out = [[] for _ in starts]
    for b in range(n_blocks):
        xb, tb = _blocks(x, np.asarray(starts) + b, L, taps)
        ticks = fir.fir_block(torch.as_tensor(xb, device=device).float(),
                              torch.as_tensor(tb, device=device).float(),
                              bank)
        re, im, lo, cnt = oracle.run_block(cst, state, ticks)
        for i in range(len(starts)):
            out[i].append((re[i, :cnt[i]], im[i, :cnt[i]], lo[i, :cnt[i]]))
    return out


def soft_bytes(syms) -> np.ndarray:
    """(n, 2) int8 .s bytes of (re, im, lo) per-block lists."""
    re = np.concatenate([s[0] for s in syms])
    im = np.concatenate([s[1] for s in syms])
    return np.stack([quantize(re), quantize(im)], 1)


def signs(b: np.ndarray) -> np.ndarray:
    return np.sign(b.astype(np.int8))


def rotate(pairs: np.ndarray, rot: int) -> np.ndarray:
    """Multiply (I, Q) pairs by j**rot: exact on int8 .s bytes."""
    i, q = pairs[:, 0], pairs[:, 1]
    return np.stack([(i, q), (-q, i), (-i, -q), (q, -i)][rot % 4], 1)


def pattern(pat: int, start: int, n: int) -> np.ndarray:
    """Signs for bytes start..start+n: pattern pat's (even, odd) signs."""
    se, so = ((1, 1), (-1, 1), (-1, -1), (1, -1))[pat]
    par = (np.arange(start, start + n) % 2)
    return np.where(par == 0, se, so).astype(np.int8)


def _transformed(ref: np.ndarray, shift: int, tr: int, oqpsk: bool):
    """The reference's bytes in symmetry tr, flat, for a .s placed at
    `shift` (symbols for QPSK, bytes for OQPSK)."""
    if not oqpsk:
        return rotate(ref, tr).reshape(-1)
    flat = ref.reshape(-1)
    return (flat * pattern(tr, shift, len(flat))).astype(np.int16)


def _agreements(prog: np.ndarray, r: np.ndarray, lo: int, hi: int,
                oqpsk: bool) -> np.ndarray:
    """(hi - lo + 1, 4): the share of the probe's signs r ((n, 2)) that the
    .s (m, 2) matches at each place lo..hi in each symmetry. QPSK: places
    in symbols, a quarter-turn rotation of each pair; OQPSK: places in half
    symbols (bytes), a sign for even and odd bytes."""
    n_r = len(r) * (2 if oqpsk else 1)
    flat = signs((prog.reshape(-1) if oqpsk else prog)[lo:hi + n_r])
    if oqpsk:
        win = sliding_window_view(flat, n_r)[:hi - lo + 1]
        rf = r.reshape(-1)
        agree = np.stack([
            (win == rf * pattern(pat, 0, n_r)).mean(1) for pat in range(4)],
            1)
        # The pattern's parity follows the byte's place in the .s.
        par = (np.arange(lo, hi + 1) % 2)[:, None]
        return np.where(par == 0, agree, agree[:, [0, 3, 2, 1]])
    win = sliding_window_view(flat, len(r), axis=0)
    win = win[:hi - lo + 1].transpose(0, 2, 1)
    return np.stack([(win == rotate(r, rot)).mean((1, 2))
                     for rot in range(4)], 1)


def align(prog: np.ndarray, ref: np.ndarray, pred: int, oqpsk: bool,
          search: int, probe: int = 512):
    """Best (shift, transform, agreement) of the reference's (n, 2) bytes
    against the .s (m, 2) within `search` symbols of symbol `pred`. QPSK:
    shift in symbols and a quarter-turn rotation of each pair; OQPSK: shift
    in half symbols (bytes) and a sign for even and odd bytes."""
    r = signs(ref[:probe])
    unit = 2 if oqpsk else 1
    n_r = len(r) * unit
    lo = max(0, unit * (pred - search))
    hi = min(unit * (pred + search), unit * len(prog) - n_r)
    if hi < lo:
        return None, None, -1.0
    agree = _agreements(prog, r, lo, hi, oqpsk)
    k, tr = np.unravel_index(int(np.argmax(agree)), agree.shape)
    return lo + int(k), int(tr), float(agree[k, tr])


def _correlate(x: np.ndarray, h: np.ndarray, n: int) -> np.ndarray:
    """sum_m x[k + m] * conj(h[m]) for k in 0..n-1, by FFT: a circular
    correlation of a length that nothing wraps in."""
    size = 1 << int(len(x) - 1).bit_length()
    return np.fft.ifft(np.fft.fft(x, size) * np.conj(np.fft.fft(h, size))
                       )[:n]


def first_span(pred: int, s: int, per_block: float, start_blocks: int,
               search: int) -> tuple:
    """The symbols (lo, hi) of the .s where the first segment, at block s
    and predicted at symbol pred, is searched for: from the .s's first
    symbol to where it would lie had the program written from the
    recording's first sample, plus `search`, and no further from pred than
    the reference's acquisition took (start_blocks' symbols). A program
    that starts writing later or earlier than the reference is found; a
    head of symbols dropped beyond that is a failed segment."""
    room = int(start_blocks * per_block)
    return (max(0, pred - room),
            min(pred + room, int(s * per_block) + search))


def search_all(prog: np.ndarray, ref: np.ndarray, start: int, end: int,
               oqpsk: bool, probe: int = 512, chunk: int = 1 << 20):
    """align's (shift, transform, agreement) over every place of the .s
    from symbol `start` to symbol `end`, a span whose sliding windows
    would not fit in memory. The probe's signs are cross-correlated with
    the .s's by FFT, a piece of `chunk` places at a time (some 150 MB
    whatever the span), as one complex correlation c: QPSK's pairs as
    I + jQ, whose four quarter turns score +-Re c and +-Im c; OQPSK's even
    probe bytes as the real part and odd ones as the imaginary, whose four
    sign patterns score +-Re c +-Im c. The KEEP places whose best symmetry
    scores highest are judged by align's agreement, which alone picks the
    symmetry (a byte of 0 scores 0 but may agree); the best is the result,
    ties to the earliest place and symmetry, as align breaks them."""
    r = signs(ref[:probe])
    unit = 2 if oqpsk else 1
    n_r = len(r) * unit
    lo0 = unit * max(0, start)
    hi = min(unit * end, unit * len(prog) - n_r)
    if hi < lo0:
        return None, None, -1.0
    if oqpsk:
        rf = r.reshape(-1)
        even = np.arange(n_r) % 2 == 0
        h = np.where(even, rf, 0) + 1j * np.where(even, 0, rf)
        flat = prog.reshape(-1)
    else:
        h = r[:, 0] + 1j * r[:, 1]
        flat = prog
    step = max(1, min(chunk, hi - lo0 + n_r) - n_r + 1)
    best = []
    for lo in range(lo0, hi + 1, step):
        n = min(step, hi + 1 - lo)
        piece = signs(flat[lo:lo + n + n_r - 1])
        if not oqpsk:
            piece = piece[:, 0] + 1j * piece[:, 1]
        c = _correlate(piece, h, n)
        score = (np.abs(c.real) + np.abs(c.imag) if oqpsk
                 else np.maximum(np.abs(c.real), np.abs(c.imag)))
        k = min(KEEP, n)
        best += [(score[i], lo + int(i))
                 for i in np.argpartition(score, -k)[-k:]]
    places = sorted({k for _, k in sorted(best, reverse=True)[:KEEP]})
    agree = np.concatenate([_agreements(prog, r, k, k, oqpsk)
                            for k in places])
    i, tr = np.unravel_index(int(np.argmax(agree)), agree.shape)
    return places[i], int(tr), float(agree[i, tr])


def decisions_off(prog: np.ndarray, ref: np.ndarray, shift: int, tr: int,
                  oqpsk: bool) -> tuple:
    """Hard decisions of the aligned segment that disagree (a byte of 0 has
    no decision and is not counted), and the mean |byte difference|."""
    if not oqpsk:
        p = prog[shift:shift + len(ref)].reshape(-1).astype(np.int16)
    else:
        p = prog.reshape(-1)[shift:shift + 2 * len(ref)].astype(np.int16)
    q = _transformed(ref, shift, tr, oqpsk)[:len(p)].astype(np.int16)
    a, b = np.sign(p), np.sign(q)
    both = (a != 0) & (b != 0)
    return (int(np.count_nonzero((a != b) & both)),
            float(np.abs(p - q).mean()) if len(p) else 0.0)
