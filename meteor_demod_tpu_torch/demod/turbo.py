"""Turbo mode: one long recording demodulated across the kernel's lanes.

The per-symbol recurrence serializes a single stream: one stream is one lane
of the block demodulator, and a launch costs the same for one lane as for a
hundred. Turbo mode maps C time-chunks of ONE recording onto the batch lanes
of the block demodulator and iterates the chunk-boundary carries to a
fixpoint:

  pass p:  f[i] = Demod(g[i], chunk_i)         for all i in parallel
           g'[0] = exact initial state; g'[i+1] = f[i]
  stop when g' == g bitwise (then, by induction from chunk 0, every chunk
  started from its exact sequential carry and the result equals the
  sequential demodulation bit-for-bit), or after `max_passes`.

Two facts make few-pass convergence work:
- The FIR delay-line tail at every chunk boundary is known exactly from the
  input data itself; it never participates in the iteration.
- The loop states (PLL phase/freq, AGC gain/bias, timing phase) are
  contractive once locked: a cold-started chunk re-acquires within the
  chunk, so each chunk quickly starts from a near-exact carry and symbol
  decisions match the sequential result.

One loop state is NOT contractive: the Costas quadrant. A QPSK signal is
invariant under 90-degree rotations (pll.c's tanh detector has the same
symmetry), so every cold-started chunk locks in an arbitrary quadrant, and
the naive fixpoint resolves that gauge only one chunk per pass. The `gauge`
convergence mode (the default) removes the serialization:

  1. warmup: each lane demodulates a short window of REAL data preceding
     its chunk from cold, producing w[c]: an estimate of the true state at
     its own chunk start, in the lane's own arbitrary quadrant gauge.
  2. pass 1 runs every chunk from w[c]; decisions are already correct
     up to each lane's gauge.
  3. the per-boundary quadrant k[c] = round((f[c-1].p_phase -
     w[c].p_phase) / (pi/2)) is measured from two estimates of the SAME
     physical boundary state; all cumulative gauges are then resolved in
     ONE host-side O(chunks) scan, not one chunk per pass.
  4. refinement passes enter each lane with its predecessor's exit carry
     rotated INTO the lane's own gauge, a tiny perturbation, so the
     fixpoint contracts in O(1) passes; convergence is declared when two
     consecutive passes emit the identical decision stream (sign-level
     fingerprint) and every gauge residual is far from the pi/4 decision
     boundary.
  5. assembly rotates lane c's symbols by the cumulative quadrant K[c]
     (exact sign/swap ops, no rounding) into chunk 0's gauge, the gauge the
     sequential demodulator would have used.

If the fixpoint is not reached, the result is still a valid demodulation
whose soft symbols agree with the sequential path to within the loop noise
(the `converged` flag and residuals report the state); callers needing the
sequential decisions pass strict=True.

Layout. A pass is make_fleet_demod's chain (parallel/mesh.py) over the
recording viewed as (C, kb*L, 2): lane c is chunk c, and its output row
holds its kb blocks step-concatenated, so column k*S + s of lane c is step s
of block k (S rows a block; S+1 for OQPSK, row 0 of each block its
pre-fire). A carry on the host is the dict of numpy leaves of
state.carry_to_numpy, with a leading lane axis; the gauge bookkeeping stays
on the host in float64 and one carry crosses to the device and back a pass.

Several devices (demod_array_turbo's mesh=): the lanes split into equal
contiguous shards (parallel/mesh.py Shards), one per device of the list,
each running the same per-lane program on its own lanes (on a CUDA stream
of its own when shards share a card), so the result is bitwise the
one-device result. The lane shift, the gauges and the
fingerprints stay on the host in global lane order; the sequential tail and
any fallback run on the first device.

This is the JAX package's demod/turbo.py without its fused single-dispatch
program, its locked passes and its packed carry, all of which served the
TPU's host link or window geometry (ROADMAP.md list D); the per-pass loop
they were held equal to is the one implementation here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..config import DemodConfig
from ..dsp.fir import f32_to_iq, iq_to_f32
from ..parallel.mesh import Shards, make_fleet_demod
from ..utils import make_mesh, select_device, to_device, to_host
from .pipeline import _SYM_DTYPE, StreamDemodulator, quantize
from .state import (CARRY_FIELDS, BlockOutput, PackedOutput, batch_carry_np,
                    carry_from_numpy, carry_to_numpy)


@dataclasses.dataclass
class TurboResult:
    symbols: np.ndarray          # structured (re, im, locked_once)
    converged: bool              # fixpoint reached (by the mode's criterion)
    passes: int                  # passes executed
    max_residual: float          # largest |g' - g| float-leaf residual, last pass
    fell_back: bool = False      # True if a sequential redo produced symbols
    gauges: np.ndarray | None = None  # per-lane cumulative quadrant K (gauge mode)
    # Samples re-demodulated sequentially by a fallback (0 on the fast
    # path). The strict-mode bounded fallback resumes from the last
    # verified chunk boundary, so this is proportional to the divergent
    # SUFFIX, not the whole recording.
    fallback_samples: int = 0


_HALF_PI = np.float32(np.pi / 2)
# Gauge residuals must sit far from the pi/4 quantization boundary for the
# quadrant measurement to be trustworthy; pi/8 leaves a 2x margin over the
# worst residual observed at 6 dB SNR (~0.26 rad).
GAUGE_DELTA_TOL = float(np.pi / 8)
# A stable decision fingerprint is only trustworthy if no future lock
# transition can invalidate it: with chunks shorter than the p_err EMA
# memory, decisions look stable for a pass or two while the lock state is
# still propagating one chunk per pass. The gate: every lane's entry p_err
# must be either safely below the lock threshold (no flip possible: the
# slow p_freq/p_err asymptotics that keep crawling for many passes cannot
# change decisions from there) or settled to relative tolerance.
GAUGE_PERR_SAFE = 0.7 * float(C.LOCK_THRESH)
GAUGE_ENTRY_TOL = 5e-3

_INT_LEAVES = ("locked", "locked_once", "slot", "flags")


def _wrap_i32(t: torch.Tensor) -> torch.Tensor:
    """An int64 sum reduced mod 2^32 into int32: the value a wrapping int32
    accumulation of the same terms ends at."""
    return ((t + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def lane_fingerprint(outs: BlockOutput):
    """Per-lane decision fingerprint of a pass's outputs, on their device.

    outs leaves are (C, kb*rows), lane-major: column k*rows + s is step s of
    block k, and the column index is the position the weights run over.
    Folds the sign bits (the decoded hard decisions), the valid pattern and
    the locked_once telemetry with positional weights into TWO wrapping
    int32 checksums per chunk lane (independent weight moduli and
    coefficient sets: a collision must fool both), plus the per-lane valid
    count. Two passes with equal fingerprints emitted identical decision
    streams up to that collision bound. Signs, not int8 levels: quantization
    LSBs keep twitching at loop-noise amplitude long after the decisions are
    stable. Returns three (C,) int32 tensors (n_valid, cs, cs2)."""
    v = outs.valid.to(torch.int64)
    sr = torch.where(outs.sym_re >= 0, 1, -1) * v
    si = torch.where(outs.sym_im >= 0, 1, -1) * v
    lo = outs.locked_once.to(torch.int64)
    idx = torch.arange(v.shape[1], dtype=torch.int64, device=v.device)[None]
    cs = ((idx % 8191 + 1) * (7 * v + 3 * sr + 5 * si + 11 * lo)).sum(1)
    cs2 = ((idx % 8087 + 1) * (13 * v + 17 * sr + 19 * si + 23 * lo)).sum(1)
    return v.sum(1).to(torch.int32), _wrap_i32(cs), _wrap_i32(cs2)


def output_fingerprint(outs: BlockOutput, rows: int, lane0: int = 0,
                       lanes: int | None = None):
    """Fingerprint of a pass's int8-quantized output: (n_valid, checksum),
    0-d int32 tensors on outs' device.

    The checksum folds the quantized symbol values (exactly the bytes the
    product emits, pipeline.quantize) and the valid pattern with positional
    weights into one wrapping int32. Two passes with equal fingerprints
    produced identical quantized output streams up to hash collision: the
    "symbols" convergence criterion. The position of step s of block k of
    lane c is (k*C + c)*rows + s, block-major as the blocks were stacked.
    outs may hold a shard of the C = `lanes` lanes, its first lane lane0:
    the shards' counts and checksums then add (mod 2^32) to the whole's."""
    v = outs.valid.to(torch.int64)
    width = v.shape[1]
    lanes = v.shape[0] if lanes is None else lanes
    qre = quantize(outs.sym_re).to(torch.int64)
    qim = quantize(outs.sym_im).to(torch.int64)
    col = torch.arange(width, dtype=torch.int64, device=v.device)[None]
    lane = torch.arange(lane0, lane0 + v.shape[0], dtype=torch.int64,
                        device=v.device)[:, None]
    pos = ((col // rows) * lanes + lane) * rows + col % rows
    cs = (v * (pos % 8191 + 1) * (3 * qre + 5 * qim + 7)).sum()
    return v.sum().to(torch.int32), _wrap_i32(cs)


def last_valid_symbol(outs: BlockOutput):
    """Each lane's last VALID (sym_re, sym_im), zeros where the lane emitted
    nothing: two (C,) float32 tensors on outs' device. The QPSK span exit
    carry needs the last emitted Q (span_submit) without the bulk symbols
    leaving the device."""
    v = outs.valid != 0
    col = torch.arange(v.shape[1], device=v.device)[None]
    pos = torch.where(v, col, -1).amax(1)
    has = pos >= 0
    at = pos.clamp(min=0)[:, None]
    zero = torch.zeros((), dtype=outs.sym_re.dtype, device=v.device)
    return (torch.where(has, outs.sym_re.gather(1, at)[:, 0], zero),
            torch.where(has, outs.sym_im.gather(1, at)[:, 0], zero))


def _gauge_measure(f: dict, w: dict, cfg=None):
    """Per-boundary quadrant between chunk c-1's exit and chunk c's own
    warmup estimate of the same physical state (host numpy, O(chunks)).

    QPSK: the gauge group is the Costas quadrant alone. OQPSK (cfg given
    and cfg.oqpsk): a pi/2 carrier rotation only yields a stable lock
    together with a half-symbol shift of the I/Q labeling (the half-symbol
    FIRE grid is the same for every lane, timing locks to the eye pattern;
    only which instants are called I vs Q shifts), so the group is still Z4
    with timing parity == k mod 2. The parity is measured independently from
    the ticks-to-next-Q-fire of the two estimates and must agree with the
    quadrant measurement; a mismatch poisons delta so the convergence test
    cannot pass on that boundary.

    Returns (k, delta, K): k[c-1] is the signed quadrant count at boundary
    c, delta the leftover radians after removing it (loop noise: small iff
    both estimates track the carrier), and K[c] the cumulative quadrant
    rotating lane c's outputs into chunk 0's gauge."""
    diff = np.asarray(f["p_phase"], np.float64)[:-1] - np.asarray(
        w["p_phase"], np.float64)[1:]
    k = np.round(diff / _HALF_PI).astype(np.int64)
    delta = diff - k * float(_HALF_PI)
    if cfg is not None and cfg.oqpsk:
        # Ticks until the next symbol-completing (Q) fire: t_phase runs
        # 0 -> pi (I fire) -> 2*pi (Q fire, reset) regardless of slot.
        nq = lambda c: ((2 * np.pi - np.asarray(c["t_phase"], np.float64))
                        / np.asarray(c["t_freq"], np.float64))
        h2 = np.pi / float(cfg.timing_freq)          # half-symbol in ticks
        m = np.round((nq(f)[:-1] - nq(w)[1:]) / h2).astype(np.int64)
        # The instant correction (one fire's p_freq, ~1e-2 rad) is far
        # below the pi/8 delta tolerance and cannot move the pi/2
        # quantization; only the parity consistency matters.
        delta = np.where((k - m) % 2 == 0, delta, np.pi)
    K = np.concatenate([[0], np.cumsum(k)])
    return k, delta, K


def _shift_lanes(init_np: dict, f: dict) -> dict:
    """g'[0] = init (leaves with a leading axis of 1), g'[c+1] = f[c]."""
    return {name: np.concatenate([np.asarray(init_np[name]),
                                  np.asarray(f[name])[:-1]], axis=0)
            for name in CARRY_FIELDS}


def _gauge_shift_np(init_np: dict, f: dict, w: dict, k, tails, cfg=None
                    ) -> dict:
    """Pass p+1 entry carries: predecessor exits rotated into each lane's
    OWN gauge (host numpy).

    Lane 0 gets the exact initial state; lane c gets f[c-1] with p_phase
    rotated by -k[c]*pi/2 so the entry matches the gauge lane c locked in
    at pass 1: the entry is then a tiny perturbation of the lane's own
    previous entry and the fixpoint contracts in O(1) passes. t_prev (the
    previous symbol's Q, a gauge-dependent quantity) rotates exactly for
    even quadrants; odd quadrants would need the unstored I component, so
    the lane's own warmup estimate, the same physical symbol in the right
    gauge, stands in. Everything else in the carry is gauge-invariant.
    FIR tails are data-exact; tick and flags reset per pass.

    OQPSK (cfg given and cfg.oqpsk): an odd quadrant also shifts the lane's
    I/Q labeling by half a symbol, so EVERY grid-dependent leaf (slot,
    t_phase, inphase, t_prev, p_phase) comes from the lane's own warmup
    estimate, the same physical state in the lane's labeling, while the
    contractive, gauge-invariant leaves (t_freq, p_freq, p_err, lock
    state, sweep direction, AGC, which acts on the raw pre-mix FIR output
    that no gauge touches) refine from the predecessor's exit. Even
    quadrants keep the grid: k%4==2 negates the pending half-symbol
    `inphase` along with t_prev (the constellation flips sign)."""
    g = _shift_lanes(init_np, f)
    pp = g["p_phase"].copy()
    # float64 mod, then one rounding: a float32 fmod gives another entry and
    # so another lock edge.
    pp[1:] = np.mod(pp[1:].astype(np.float64) - k * float(_HALF_PI),
                    2 * np.pi).astype(np.float32)
    km = k % 4
    flip = km == 2
    odd = (km % 2) == 1
    tp = g["t_prev"].copy()
    tp[1:][flip] = -tp[1:][flip]
    tp[1:][odd] = w["t_prev"][1:][odd]
    g.update(p_phase=pp, t_prev=tp, fir_tail=tails,
             tick=np.zeros_like(g["tick"]), flags=np.zeros_like(g["flags"]))
    if cfg is not None and cfg.oqpsk:
        ip = g["inphase"].copy()
        ip[1:][flip] = -ip[1:][flip]
        sub = lambda a, b: np.concatenate(
            [a[:1], np.where(odd, b[1:], a[1:])], axis=0)
        g.update(inphase=sub(ip, w["inphase"]),
                 slot=sub(g["slot"], w["slot"]),
                 t_phase=sub(g["t_phase"], w["t_phase"]),
                 p_phase=sub(g["p_phase"], w["p_phase"]))
    return g


def rotate_quadrant(re, im, r):
    """Multiply symbols by e^{-j*r*pi/2}: exact sign/swap ops, no rounding.
    r = cumulative gauge K[c] (any sign)."""
    r = int(r) % 4
    if r == 0:
        return re, im
    if r == 1:
        return im, -re
    if r == 2:
        return -re, -im
    return -im, re


# Gauge-0 value of a lane's emitted components, by K % 4 (rows): the sign
# pattern of m = m0 * e^{j K pi/2} evaluated at the component's half-symbol
# instant: column 0 multiplies sym_re (the lane's stored I half), column 1
# multiplies sym_im (the lane's Q half). For even K the lane's labels match
# gauge 0 and this is plain rotation by K*pi/2 restricted to the stored
# components; for odd K the lane's "I" sits on a gauge-0 Q instant and vice
# versa, so the signed values land on the SHIFTED grid and must be re-paired
# (_assemble_oqpsk_gauge).
_OQ_SIGNS = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)


def _assemble_oqpsk_gauge(sym_re, sym_im, valid, lonce, K, exit_slot,
                          exit_inphase, exit_lonce, tail_syms, pending=None):
    """Gauge-mode OQPSK assembly: global half-symbol re-pairing. The output
    arrays are lane-major, (P, kb*(S+1)).

    OQPSK's gauge group couples the Costas quadrant with the I/Q labeling
    of the shared half-symbol fire grid (see _gauge_measure): a lane with
    odd cumulative gauge K[c] calls gauge-0 Q instants "I" and vice versa,
    so rotating its output into chunk 0's gauge does not map symbol ->
    symbol. Instead each emitted pair is split into its two half-symbol
    VALUES, the values are rotated into gauge 0 (the _OQ_SIGNS flips), and
    the global half-value stream is re-paired on chunk 0's grid.

    At each odd-parity boundary exactly one of two stitches applies,
    decided by the predecessor's exit slot:
      - slot==2 (a stored I half pending): that half-value was never
        emitted: lane c-1 holds it unemitted in its carry, and lane c's
        opposite labeling treats the instant as an already-completed Q.
        Insert it from the exit carry's `inphase` (exact), rotated by
        K[c-1].
      - slot==1: the predecessor's final Q instant is ALSO covered by lane
        c's completion pre-fire (whose sym_re came from the lane's warmup
        state). Drop lane c's duplicate first half-value and keep the
        predecessor's in-chunk exact one.
    Even-parity boundaries continue seamlessly through the shifted carry
    (slot/inphase hand-off), exactly like the sequential demodulator.

    The sub-multiple tail (tail_syms, may be None) was demodulated in the
    LAST lane's gauge with its carry untouched; its symbols join the
    half-value stream before pairing. A trailing unpaired half-value is
    dropped: the sequential demodulator likewise never emits a pending I.

    pending: (slot, inphase, locked_once) of the carry the recording ENDS
    with, in the last lane's gauge (None: nothing appended, as the JAX
    package assembles). With slot == 2 that carry holds a fired half-value
    no symbol has emitted. Under an odd last gauge it sits on a gauge-0 Q
    instant, the half that completes the sequential stream's last symbol;
    leaving it out makes the count one short whenever the recording holds
    an even number of half-symbol fires. Under an even gauge it is the
    pending I the sequential stream holds back too, and pairing drops it
    again.

    locked_once per re-paired symbol is taken at the Q half (the update
    instant)."""
    vals, los = [], []
    for c in range(sym_re.shape[0]):
        m = valid[c].astype(bool)
        re, im, lo = sym_re[c][m], sym_im[c][m], lonce[c][m]
        sr, si = _OQ_SIGNS[int(K[c]) % 4]
        v = np.empty(2 * len(re), np.float32)
        v[0::2] = sr * re
        v[1::2] = si * im
        l2 = np.repeat(lo, 2)
        if c > 0 and (int(K[c]) - int(K[c - 1])) % 2:
            if int(exit_slot[c - 1]) == 2:
                sp = _OQ_SIGNS[int(K[c - 1]) % 4][0]
                v = np.concatenate(
                    [[sp * np.float32(exit_inphase[c - 1])], v])
                l2 = np.concatenate(
                    [[np.int32(exit_lonce[c - 1])], l2])
            elif len(v):
                v = v[1:]
                l2 = l2[1:]
        vals.append(v)
        los.append(l2)
    if tail_syms is not None and len(tail_syms):
        sr, si = _OQ_SIGNS[int(K[-1]) % 4]
        v = np.empty(2 * len(tail_syms), np.float32)
        v[0::2] = sr * tail_syms["re"]
        v[1::2] = si * tail_syms["im"]
        vals.append(v)
        los.append(np.repeat(tail_syms["locked_once"], 2))
    if pending is not None and int(pending[0]) == 2:
        sp = _OQ_SIGNS[int(K[-1]) % 4][0]
        vals.append(np.array([sp * np.float32(pending[1])], np.float32))
        los.append(np.array([int(pending[2])]))
    F = np.concatenate(vals) if vals else np.zeros(0, np.float32)
    L2 = np.concatenate(los) if los else np.zeros(0, np.int64)
    n = len(F) // 2
    s = np.zeros(n, dtype=_SYM_DTYPE)
    s["re"] = F[0:2 * n:2]
    s["im"] = F[1:2 * n:2]
    s["locked_once"] = L2[1:2 * n:2]
    return s


def _assemble_qpsk_gauge(sym_re, sym_im, valid, lonce, K, scale=1.0):
    """Vectorized QPSK gauge assembly over lane-major (P, kb*S) arrays:
    rotate each lane into chunk 0's gauge (exact sign/swap,
    rotate_quadrant) and emit the lanes in order. K=None rotates nothing.
    `scale` maps stored values to the soft-symbol float scale (2.0 for the
    device-quantized int8 path: q = trunc(clip(v/2)) means 2q re-quantizes
    to q bit-exactly downstream)."""
    P = sym_re.shape[0]
    r = (np.zeros(P, np.int64) if K is None
         else np.asarray(K[:P]).astype(np.int64) % 4)
    swap = (r % 2 == 1)[:, None]
    sre = np.where(r < 2, 1.0, -1.0).astype(np.float32)[:, None]
    sim = np.where((r == 1) | (r == 2), -1.0, 1.0).astype(np.float32)[:, None]
    re_l = sym_re.astype(np.float32)
    im_l = sym_im.astype(np.float32)
    re_rot = sre * np.where(swap, im_l, re_l)
    im_rot = sim * np.where(swap, re_l, im_l)
    m = valid.astype(bool)
    s = np.zeros(int(m.sum()), dtype=_SYM_DTYPE)
    s["re"] = re_rot[m] * np.float32(scale)
    s["im"] = im_rot[m] * np.float32(scale)
    s["locked_once"] = lonce[m]
    return s


def boundary_tails(xf, chunks: int, chunk_len: int, taps: int) -> np.ndarray:
    """Exact FIR tails at every chunk boundary, straight from the data:
    (C, taps-1, 2) float32, lane 0's zeros."""
    tails = np.zeros((chunks, taps - 1, 2), np.float32)
    for c in range(1, chunks):
        tails[c] = xf[c * chunk_len - (taps - 1):c * chunk_len]
    return tails


def warmup_tails(xf, chunks: int, chunk_len: int, V: int, taps: int
                 ) -> np.ndarray:
    """build_warmup's FIR tails alone: the taps-1 samples before each lane's
    warmup segment of V samples (zeros where the segment starts the
    recording)."""
    wtails = np.zeros((chunks, taps - 1, 2), np.float32)
    for c in range(1, chunks):
        s0 = c * chunk_len - V
        if s0 >= taps - 1:
            wtails[c] = xf[s0 - (taps - 1):s0]
    return wtails


def build_warmup(xf, chunks, chunk_len, kb_w, L, taps):
    """Warmup inputs: lane c demodulates the kb_w blocks of REAL data
    preceding its chunk (the tail of chunk c-1), with the data-exact FIR
    tail before that. Lane 0 re-demodulates its own prefix; its warmup
    result is discarded (the exact initial state is used instead).

    Returns (wseg (C, kb_w*L, 2), wtails (C, taps-1, 2)) numpy, lane-major
    as a pass's input."""
    V = kb_w * L
    wseg = np.zeros((chunks, V, 2), np.float32)
    for c in range(chunks):
        s0 = c * chunk_len - V if c else 0
        wseg[c] = xf[s0:s0 + V]
    return wseg, warmup_tails(xf, chunks, chunk_len, V, taps)


def default_warmup_blocks(L, kb):
    """Warmup length: enough for a cold lane to lock AND for the slow freq
    integrator to mature. Lock alone needs ~2500-3500 fires (p_err EMA from
    its 1000 init to the 85 threshold at pole 1e-3, pll.c:7,36,117), ~11k
    samples at the 230.4k/72k default, but a young integrator leaves a
    systematic phase lag vs the full-chunk exits, costing one extra
    verification pass at larger carrier offsets; 65536 samples (~20k fires)
    converge in 2 passes at a 400 Hz offset. Capped at half the chunk so
    warmup never dominates a pass."""
    return max(1, min(max(kb // 2, 1), -(-65536 // L)))


def _decisions_settled(g_new: dict, g_prev: dict):
    """Can re-running from g_new change any future DECISION vs g_prev?

    Value-level drift (phases, freq integrator, AGC) is guarded by the sign
    fingerprint itself: if it flipped a symbol, the fingerprint would
    differ. What the fingerprint cannot see is a PENDING transition: a lock
    state still propagating down the chunk chain. So the gate is (a) the
    integer lock/slot leaves are identical between consecutive entries, and
    (b) every lane's entry p_err is either safely below the lock threshold
    (no future flip possible) or settled to relative tolerance.

    Returns (settled, resid) with resid the worst p_err relative change
    among unsafe lanes (diagnostic)."""
    for name in _INT_LEAVES:
        if not np.array_equal(np.asarray(g_new[name]),
                              np.asarray(g_prev[name])):
            return False, 1.0
    a = np.asarray(g_new["p_err"], np.float64)
    b = np.asarray(g_prev["p_err"], np.float64)
    safe = np.logical_and(a < GAUGE_PERR_SAFE, b < GAUGE_PERR_SAFE)
    rel = np.abs(a - b) / np.maximum(1.0, a + b)
    unsafe_rel = rel[~safe]
    resid = float(np.max(unsafe_rel)) if len(unsafe_rel) else 0.0
    return resid < GAUGE_ENTRY_TOL, resid


def _lane_ok_np(fp, prev_fp, k, k_prev, delta, g_new: dict, g_prev: dict):
    """Per-lane convergence diagnostics for the bounded strict fallback.

    lane_ok[c] is True when every criterion the GLOBAL convergence test
    applies holds restricted to lane c: its decision fingerprint matched
    the previous pass, its entry is settled (_decisions_settled per lane),
    and its entry boundary's gauge measurement is stable and far from the
    pi/4 decision boundary. all(lane_ok) together with k-stability over
    every boundary is exactly the global test, so a converged run has
    lane_ok all-True; on a non-converged run the longest all-True PREFIX
    is decision-final by the same induction that justifies accepting a
    fully converged run (lane 0's entry is exact; each verified boundary
    hands a verified entry to the next lane)."""
    n = len(g_new["p_err"])
    if prev_fp is None:
        return np.zeros(n, bool)
    fp_eq = np.array([a == b for a, b in zip(fp, prev_fp)], dtype=bool)
    ieq = np.ones(n, bool)
    for name in _INT_LEAVES:
        ieq &= np.asarray(g_new[name]) == np.asarray(g_prev[name])
    a = np.asarray(g_new["p_err"], np.float64)
    b = np.asarray(g_prev["p_err"], np.float64)
    safe = np.logical_and(a < GAUGE_PERR_SAFE, b < GAUGE_PERR_SAFE)
    rel = np.abs(a - b) / np.maximum(1.0, a + b)
    settled = ieq & (safe | (rel < GAUGE_ENTRY_TOL))
    bnd = np.ones(n, bool)
    if n > 1:
        stable = np.abs(delta) < GAUGE_DELTA_TOL
        if k_prev is not None:
            stable &= (k - k_prev) % 4 == 0
        else:
            stable[:] = False
        bnd[1:] = stable
    return fp_eq & settled & bnd


def verified_prefix(lane_ok) -> int:
    """Length of the leading all-True run of lane_ok (0 if none)."""
    if lane_ok is None or not len(lane_ok):
        return 0
    false_at = np.nonzero(~np.asarray(lane_ok, bool))[0]
    return int(false_at[0]) if len(false_at) else len(lane_ok)


def finish_warmup_carry(cfg, wf: dict, tails_np, init_np: dict | None = None
                        ) -> dict:
    """Warmup exit carry -> gauge anchor w (numpy): lane 0 is replaced by
    the exact initial state (lane 0 IS the sequential start; its warmup on
    its own prefix is discarded), fir_tail becomes the data-exact main
    tails, tick and flags reset. init_np: the exact lane-0 entry with (1,)
    leaves: cold start by default; a mid-stream carry for the span path
    (span_submit)."""
    if init_np is None:
        init_np = batch_carry_np(cfg, 1)
    w = {name: np.concatenate([np.asarray(init_np[name]),
                               np.asarray(wf[name])[1:]], axis=0)
         for name in CARRY_FIELDS}
    w.update(fir_tail=tails_np, tick=np.zeros_like(w["tick"]),
             flags=np.zeros_like(w["flags"]))
    return w


def _one_device(blocks: torch.Tensor, shards):
    """(the shards' lane tensors, the Shards): one device's blocks become
    one shard."""
    if shards is not None:
        return blocks, shards
    return [blocks], Shards([blocks.device], blocks.shape[0], "chunks")


def make_pass_runner(cfg: DemodConfig, blocks, last_symbol=False,
                     shards: Shards | None = None):
    """One pass over every lane: run(g_np) -> (f_np, outs, stats).

    blocks is (C, kb*L, 2) float32 on the device the pass runs on; or, with
    `shards` (parallel/mesh.py Shards over the C lanes), the list of each
    shard's (C/n, kb*L, 2) lanes on its device. g_np and f_np are host
    carries (dicts of numpy leaves with a lane axis, all C lanes), outs the
    pass's BlockOutput left on the device (with shards, the list of the
    shards'), and stats the lane_fingerprint vectors as numpy (followed by
    last_valid_symbol's two when last_symbol). A pass is kb launches of the
    recurrence kernel per shard, make_fleet_demod's chain, every shard's
    queued before one small fetch from each."""
    parts, shards = _one_device(blocks, shards)
    chain = parts[0].shape[1] // cfg.block_len
    steps = [make_fleet_demod(cfg, shards.per, part.device, telemetry=False,
                              chain=chain) for part in parts]

    def run(g_np: dict):
        done = []
        for i, (part, step, rows) in enumerate(zip(parts, steps,
                                                   shards.rows)):
            with shards.on(i, [part]):
                f, outs, _ = step(carry_from_numpy(
                    {k: g_np[k][rows] for k in CARRY_FIELDS}, part.device),
                    part)
                stats = lane_fingerprint(outs)
                if last_symbol:
                    stats += last_valid_symbol(outs)
            done.append((f, outs, stats))
        f_np = shards.carry_to_numpy([d[0] for d in done])
        host = shards.to_host([list(d[2]) for d in done])
        stats = tuple(np.concatenate([h[j] for h in host])
                      for j in range(len(host[0])))
        outs = [d[1] for d in done]
        return f_np, (outs if len(outs) > 1 else outs[0]), stats

    return run


def _lanes_to_host(outs, shards: Shards, P: int):
    """The first P lanes of a pass's outputs (one BlockOutput, or the list
    of the shards') as numpy in lane order: sym_re, sym_im, and valid and
    locked_once as int8. One shard's arrays are the pinned buffers
    themselves (utils.to_host copy=False), for a caller that assembles them
    at once."""
    parts = outs if isinstance(outs, list) else [outs]
    want = []
    for i, (o, rows) in enumerate(zip(parts, shards.rows)):
        n = max(0, min(P, rows.stop) - rows.start)
        with shards.on(i):
            want.append([o.sym_re[:n], o.sym_im[:n],
                         o.valid[:n].to(torch.int8),
                         o.locked_once[:n].to(torch.int8)])
    host = shards.to_host(want, copy=len(parts) > 1)
    return [host[0][j] if len(host) == 1 else
            np.concatenate([h[j] for h in host]) for j in range(4)]


def _output_fingerprint(outs, rows: int, shards: Shards) -> tuple:
    """output_fingerprint of a pass's whole output (one BlockOutput, or the
    list of the shards'), as two ints."""
    parts = outs if isinstance(outs, list) else [outs]
    lanes = shards.per * len(shards)
    fps = []
    for i, (o, r) in enumerate(zip(parts, shards.rows)):
        with shards.on(i):
            fps.append(list(output_fingerprint(o, rows, lane0=r.start,
                                               lanes=lanes)))
    host = shards.to_host(fps)
    cs = sum(int(h[1]) for h in host)
    return (sum(int(h[0]) for h in host),
            (cs + 2 ** 31) % 2 ** 32 - 2 ** 31)


def run_warmup(cfg, blocks, xf, kb_w: int, tails_np,
               init_np: dict | None = None,
               shards: Shards | None = None) -> dict:
    """The warmup pass and its gauge anchor w (finish_warmup_carry): every
    lane demodulates from cold the kb_w blocks before its chunk.
    build_warmup's segments are cut on the device from `blocks`, the
    recording already there as (C, kb*L, 2) (or, with `shards`, each
    shard's lanes; a shard's first lane takes the blocks before it from the
    host's copy xf); the FIR tails come from xf."""
    parts, shards = _one_device(blocks, shards)
    chunks, chunk_len = shards.per * len(shards), parts[0].shape[1]
    V = kb_w * cfg.block_len
    wsegs = []
    for part, rows in zip(parts, shards.rows):
        at = rows.start * chunk_len
        head = (part[:1, :V] if at == 0 else
                to_device(xf[at - V:at][None], part.device))
        wsegs.append(torch.cat([head, part[:-1, chunk_len - V:]]))
    w0_np = batch_carry_np(cfg, chunks)
    w0_np["fir_tail"] = warmup_tails(xf, chunks, chunk_len, V, cfg.taps)
    wf_np, _, _ = make_pass_runner(cfg, wsegs, shards=shards)(w0_np)
    return finish_warmup_carry(cfg, wf_np, tails_np, init_np)


def gauge_fixpoint(cfg, run, w_np: dict, tails_np, max_passes,
                   init_np: dict | None = None):
    """The gauge-mode fixpoint loop.

    run: a make_pass_runner runner over all chunk lanes.
    w_np: numpy warmup carry (lane 0 already replaced by the exact initial
    state, fir_tail/tick/flags already reset): the per-lane gauge anchor.
    Per pass the host link carries one carry each way and the fingerprint
    vectors.

    Convergence (all of, see the tolerance constants above): decision
    fingerprints identical to the previous pass, quadrant assignment stable
    mod 4, every gauge residual far from the pi/4 boundary, and no pending
    lock transition that could flip future decisions (_decisions_settled).

    Returns (f_np, outs, K, passes, converged, max_resid, lane_ok, stats):
    outs is the LAST pass's device-side BlockOutput, K the cumulative
    per-lane quadrants rotating it into chunk 0's gauge, max_resid the
    larger of the gauge and settling residuals, lane_ok the per-lane
    convergence diagnostics of the last pass (_lane_ok_np: all-True iff
    converged; its leading all-True prefix backs the bounded strict
    fallback), stats the last pass's runner stats.

    init_np: exact lane-0 entry with (1,) leaves (default cold start; a
    mid-stream carry for span_submit)."""
    if init_np is None:
        init_np = batch_carry_np(cfg, 1)
    g_np = w_np
    prev_fp = None
    converged = False
    passes = 0
    max_resid = float("inf")
    f_np = outs = stats = None
    k = np.zeros(0, np.int64)
    k_prev = None
    lane_ok = None
    # Provably-exact entry lanes: lane 0's entry is exact by construction;
    # exactness propagates one lane per pass through IDENTITY gauge
    # boundaries only (k%4==0: any real rotation perturbs float32 state at
    # ulp level). A lane containing a lock transition is accepted only when
    # its entry was provably exact, because the in-chunk lock-edge instant
    # is sensitive to ulp-level entry drift that the decision fingerprint is
    # stable under.
    lanes = len(np.asarray(w_np["p_err"]))
    exact_used = np.zeros(lanes, bool)
    exact_used[0] = True
    for p in range(max_passes):
        f_np, outs, stats = run(g_np)
        passes += 1
        # Gauge anchor: pass 1 measures against the warmup states (their
        # phase can lag systematically, the warmup's freq integrator being
        # younger than the full-chunk exit's, so that measurement is only
        # a best-effort initializer). Later passes measure against the
        # entries actually used: entry[c] carries the applied rotation, so
        # the diff still yields the FULL per-boundary quadrant, but now
        # between same-maturity states: delta collapses to pass-to-pass
        # drift, and a pass-1 quadrant mistake shows up as k changing.
        k, delta, _ = _gauge_measure(f_np, w_np if p == 0 else g_np, cfg)
        # Boundaries handing over an UNLOCKED exit are forced to the
        # identity gauge (a pre-lock lane has no pinned gauge; the raw
        # predecessor exit is the true trajectory, so exactness extends
        # through the acquisition region one lane per pass), and lanes
        # containing a lock transition this pass demand a provably-exact
        # entry (exact_used above).
        trans = np.logical_or(
            np.asarray(g_np["locked"]) != np.asarray(f_np["locked"]),
            np.asarray(g_np["locked_once"]) != np.asarray(f_np["locked_once"]))
        if lanes > 1:
            k = np.where(np.asarray(f_np["locked"])[:-1] == 0, 0, k)
        ok_trans = np.logical_or(~trans, exact_used)
        max_delta = float(np.max(np.abs(delta))) if len(delta) else 0.0
        fp = tuple(tuple(int(x) for x in t) for t in zip(*stats[:3]))
        g_new = _gauge_shift_np(init_np, f_np, w_np, k, tails_np, cfg)
        settled, resid = _decisions_settled(g_new, g_np)
        lane_ok = np.logical_and(
            _lane_ok_np(fp, prev_fp, k, k_prev, delta, g_new, g_np),
            ok_trans)
        max_resid = max(max_delta, resid)
        k_stable = k_prev is not None and not np.any((k - k_prev) % 4)
        if prev_fp is not None and fp == prev_fp and k_stable \
                and max_delta < GAUGE_DELTA_TOL and settled \
                and bool(np.all(ok_trans)):
            converged = True
            break
        prev_fp = fp
        k_prev = k
        g_np = g_new
        # Propagate entry exactness into the entries just built for the
        # next pass: lane c's new entry is exact iff its predecessor's
        # entry was exact this pass AND the rotation into lane c's gauge
        # is even (exact).
        nxt = np.zeros_like(exact_used)
        nxt[0] = True
        if lanes > 1:
            nxt[1:] = exact_used[:-1] & (np.asarray(k) % 4 == 0)
        exact_used = nxt
    K = np.concatenate([[0], np.cumsum(k)])
    if lane_ok is None:
        lane_ok = np.zeros(lanes, bool)
    if converged:
        lane_ok = np.ones_like(lane_ok)
    return f_np, outs, K, passes, converged, max_resid, lane_ok, stats


def _as_f32_pairs(x) -> np.ndarray:
    if np.iscomplexobj(x):
        return iq_to_f32(np.asarray(x, dtype=np.complex64))
    return np.ascontiguousarray(x, dtype=np.float32)


def _sequential_from(cfg, device, leaves: dict | None, x: np.ndarray):
    """x (complex64) through a fresh StreamDemodulator, from the carry
    `leaves` (numpy, one stream) or from cold: (symbols, the carry it ends
    with as numpy leaves of one stream)."""
    d = StreamDemodulator(cfg, device)
    if leaves is not None:
        d.set_carry(leaves)
    symbols = np.concatenate([d.process(x), d.finish()])
    return symbols, {k: v[0] for k, v in carry_to_numpy(d._carry).items()}


def demod_array_turbo(cfg: DemodConfig, x: np.ndarray, chunks: int = 32,
                      max_passes: int = 4, device=None, mesh=None,
                      converge: str = "auto",
                      warmup_blocks: int | None = None,
                      strict: bool = False) -> TurboResult:
    """Demodulate a full recording with chunk-parallel fixpoint iteration.

    Args:
      cfg: demod configuration.
      x: (N,) complex64 (or (N, 2) float32) samples.
      chunks: time chunks == batch lanes (the parallelism degree).
      max_passes: fixpoint iteration cap; worst-case cost is
        max_passes * (N / chunks) block-demod work.
      device: where the passes run (None: the card, utils.select_device).
      mesh: None for one device; a device list (utils.make_mesh) shards
        the lanes over it, chunks divisible by its length; "auto" shards
        over every visible card when there are several and they divide
        chunks, else runs on one. Giving device and mesh raises. The
        result is bitwise the one-device result.
      converge: stopping criterion. "auto" picks "gauge".
        "gauge" (the default): warmup acquisition per lane, one-shot gauge
        resolution, then iterate until two consecutive passes emit the
        identical sign-level decision stream: O(1) passes independent of
        chunks (typically 2-3; see the module docstring). For OQPSK the
        gauge group couples the quadrant with the half-symbol I/Q
        labeling; assembly re-pairs the half-value stream globally
        (_assemble_oqpsk_gauge). Needs max_passes >= 2 to be able to
        report convergence.
        "bitwise": iterate until the boundary carries reach the exact
        fixpoint: the result provably equals the sequential chaining of the
        same program, but exactness propagates only one chunk per pass, so
        worst case needs chunks+1 passes.
        "symbols": stop when two consecutive passes produce identical
        int8-quantized output (the product's actual emission); O(chunks)
        passes when lanes lock in different gauges. Needs max_passes >= 2.
      warmup_blocks: gauge-mode warmup length in blocks (default: enough
        samples for cold carrier lock, see default_warmup_blocks).
      strict: if True, a non-converged fixpoint falls back to the exact
        sequential demodulation instead of returning the best-effort
        assembly. The resulting contract: DECISION-exact when converged
        (the emitted sign-level decision stream equals the sequential
        path's; int8 soft values can differ by loop-noise LSBs), exact
        sequential otherwise. The fallback is BOUNDED: it accepts the
        verified prefix of chunk lanes (every per-lane convergence
        criterion held, _lane_ok_np) and resumes the sequential path from
        that boundary's carry, so its cost is proportional to the divergent
        suffix (TurboResult.fallback_samples reports it); only a fully
        unverified run redoes the whole file. The CLI -T path sets this;
        library callers who prefer speed can inspect `converged`
        themselves.
    """
    cfg.validate()
    if converge == "auto":
        converge = "gauge"
    if converge not in ("bitwise", "symbols", "gauge"):
        raise ValueError(f"converge {converge!r}")
    if device is not None and mesh is not None:
        raise ValueError("give device= or mesh=, not both")
    if isinstance(mesh, str) and mesh == "auto":
        mesh = make_mesh()
        if len(mesh) < 2 or chunks % len(mesh) != 0:
            mesh = None
    devices = make_mesh(mesh) if mesh is not None else [select_device(device)]
    shards = Shards(devices, chunks, "chunks")
    device = devices[0]
    xf = _as_f32_pairs(x)
    N = len(xf)
    L = cfg.block_len
    taps = cfg.taps

    def _sequential(tag_converged=True):
        syms, _ = _sequential_from(cfg, device, None, f32_to_iq(xf))
        return TurboResult(symbols=syms, converged=tag_converged, passes=0,
                           max_residual=0.0, fell_back=True,
                           fallback_samples=N)

    # Turbo covers whole chunks only; the sub-multiple tail is demodulated
    # sequentially from the (exact) final chunk carry: no zero padding, no
    # spurious pad symbols.
    kb = N // (chunks * L)
    if kb == 0:
        return _sequential()
    chunk_len = kb * L
    turbo_n = chunks * chunk_len
    xt = xf[:turbo_n]
    # Lane c, block k = xt[c*chunk_len + k*L : ... + L]: a view, no copy.
    blocks = [to_device(xt[rows.start * chunk_len:rows.stop * chunk_len],
                        dev).view(shards.per, chunk_len, 2)
              for dev, rows in zip(devices, shards.rows)]
    tails = boundary_tails(xt, chunks, chunk_len, taps)
    rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)

    init_np = batch_carry_np(cfg, 1)
    K = None
    lane_ok = None

    if converge == "gauge":
        kb_w = min(warmup_blocks or default_warmup_blocks(L, kb), kb)
        w_np = run_warmup(cfg, blocks, xt, kb_w, tails, shards=shards)
        (f_np, outs, K, passes, converged, max_residual, lane_ok,
         _) = gauge_fixpoint(cfg, make_pass_runner(cfg, blocks,
                                                   shards=shards),
                             w_np, tails, max_passes)
    else:
        run = make_pass_runner(cfg, blocks, shards=shards)
        g_np = batch_carry_np(cfg, chunks)
        g_np["fir_tail"] = tails
        converged = False
        passes = 0
        max_residual = float("inf")
        outs = f_np = prev_fp = None
        for _ in range(max_passes):
            f_np, outs, _ = run(g_np)
            # g'[0] = exact initial, g'[i+1] = f[i]; tails stay data-exact.
            g_new = _shift_lanes(init_np, f_np)
            g_new.update(fir_tail=tails, tick=np.zeros_like(g_new["tick"]))
            passes += 1
            residual = 0.0
            same = True
            for name in CARRY_FIELDS:
                a, b = g_np[name], g_new[name]
                if not np.array_equal(a, b):
                    same = False
                    if np.issubdtype(a.dtype, np.floating):
                        residual = max(residual,
                                       float(np.max(np.abs(a - b))))
                    else:
                        residual = max(residual, 1.0)
            max_residual = residual
            if same:
                converged = True      # bitwise fixpoint implies both modes
                break
            if converge == "symbols":
                fp = _output_fingerprint(outs, rows, shards)
                if fp == prev_fp:
                    converged = True
                    break
                prev_fp = fp
            g_np = g_new

    # Safety net: any flagged chunk invalidates the fast-path result for the
    # affected stream positions: redo the whole recording sequentially (the
    # sequential path routes flagged blocks to the exact scalar oracle).
    if int(np.asarray(f_np["flags"]).sum()) != 0:
        return _sequential(tag_converged=False)

    # Strict contract: a non-converged fixpoint may carry decision-level
    # errors near chunk boundaries, but only from the FIRST unverified
    # lane onward. Accept the verified prefix (decision-final by the same
    # induction that justifies a converged run, see _lane_ok_np) and
    # resume the exact sequential path from its boundary carry, so the
    # fallback cost is proportional to the divergent suffix, not the
    # whole recording. P == 0 (or a non-gauge converge mode) degenerates
    # to the full sequential redo.
    P = chunks
    if strict and not converged:
        P = verified_prefix(lane_ok)
        if P == 0:
            return _sequential(tag_converged=False)
    fallback_n = N - P * chunk_len if strict and not converged else 0

    # Assemble symbols in stream order from the final pass; in gauge mode
    # rotate each lane's symbols into chunk 0's gauge (exact sign/swap).
    sym_re, sym_im, valid, lonce = _lanes_to_host(outs, shards, P)
    lonce = lonce.astype(np.int32)
    del outs, blocks
    tail_start = P * chunk_len           # == turbo_n when P == chunks
    tail_c = {name: np.asarray(f_np[name])[P - 1] for name in CARRY_FIELDS}
    result = lambda syms: TurboResult(
        symbols=syms, converged=converged, passes=passes,
        max_residual=max_residual, gauges=K, fell_back=fallback_n > 0,
        fallback_samples=fallback_n)

    if K is not None and cfg.oqpsk:
        # OQPSK gauge assembly: the sequential tail/suffix continues in
        # lane P-1's gauge (carry untouched: rotating an odd-gauge carry
        # would need grid-dependent surgery), then the whole half-value
        # stream is re-paired globally (see _assemble_oqpsk_gauge).
        tail_syms, end_c = None, tail_c
        if tail_start < N:
            tail_syms, end_c = _sequential_from(cfg, device, tail_c,
                                                f32_to_iq(xf[tail_start:]))
        return result(_assemble_oqpsk_gauge(
            sym_re, sym_im, valid, lonce, K[:P], f_np["slot"][:P],
            f_np["inphase"][:P], f_np["locked_once"][:P], tail_syms,
            pending=(end_c["slot"], end_c["inphase"], end_c["locked_once"])))

    parts = [_assemble_qpsk_gauge(sym_re, sym_im, valid, lonce, K)]
    # Sequential tail/suffix from lane P-1's exit carry (exact when the
    # fixpoint converged / the prefix verified; within loop noise
    # otherwise).
    if tail_start < N:
        if K is not None and int(K[P - 1]) % 4 != 0:
            # Rotate the carry into chunk 0's gauge so the tail continues
            # the emitted stream: symbols transform by e^{-j K pi/2}, so
            # the NCO phase shifts by +K pi/2 (the mix is by e^{-j
            # p_phase}). t_prev (previous symbol Q, gauge 0) is the last
            # assembled symbol's Q, whichever chunk emitted it.
            pp = np.mod(float(tail_c["p_phase"])
                        + (int(K[P - 1]) % 4) * float(_HALF_PI), 2 * np.pi)
            prev_q = float(parts[0]["im"][-1]) if len(parts[0]) else 0.0
            tail_c.update(p_phase=np.float32(pp), t_prev=np.float32(prev_q))
        parts.append(_sequential_from(cfg, device, tail_c,
                                      f32_to_iq(xf[tail_start:]))[0])
    return result(np.concatenate(parts))



# ---------------------------------------------------------------------------
# Span turbo: the chunk-parallel fixpoint applied to a BOUNDED mid-stream
# span, the streaming answer to the single-stream serialization
# (StreamDemodulator's per-block chain runs one lane of each launch; a
# buffered span of a file-backed or bursty input can instead ride the
# C-lane batch program: warmup + O(1) gauge passes for C*kb blocks of
# output, at the same exactness contract as strict turbo).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpanResult:
    """demod_span_turbo outcome.

    symbols covers the ACCEPTED prefix only (consumed samples); the caller
    demodulates the rest of the span through its normal sequential path
    (exact oracle semantics) and keeps feeding from there.
    """
    symbols: np.ndarray              # structured (re, im, locked_once)
    exit_carry: dict | None          # numpy scalar leaves; None if P == 0
    consumed: int                    # samples covered by the accepted prefix
    passes: int
    converged: bool
    verified_lanes: int              # P, the accepted chunk-lane prefix length


@dataclasses.dataclass
class SpanPending:
    """In-flight span (span_submit -> span_finish).

    Acceptance is decided from small data alone (the exit carries, the
    per-lane valid counts and each lane's last valid symbol): exit_carry and
    consumed are final at submit time, so a pipelined caller
    (StreamDemodulator span mode) can dispatch the NEXT span from exit_carry
    while this span's bulk symbol payload (`outs`, still on the device,
    quantized to int8) waits for span_finish."""
    outs: PackedOutput | None   # device int8 rows of the accepted lanes
    f_np: dict                  # last pass's exit carries, numpy leaves
    K: np.ndarray               # cumulative gauges (C,)
    passes: int
    converged: bool
    P: int                      # accepted lane prefix
    consumed: int               # samples covered by the accepted prefix
    exit_carry: dict | None     # final; feeds the next span


def demod_span_turbo(cfg: DemodConfig, carry0: dict, xf: np.ndarray,
                     chunks: int = 32, max_passes: int = 4, device=None,
                     warmup_blocks: int | None = None) -> SpanResult:
    """Demodulate a mid-stream span chunk-parallel from an EXACT carry.

    The span continues an ongoing stream: lane 0's entry is `carry0`
    (numpy scalar leaves: the stream's authoritative state, including its
    FIR tail), lanes 1..C-1 warm up on the real data preceding their
    chunk and the one-shot gauge resolution + fingerprint fixpoint of
    demod_array_turbo's gauge mode (O(1) passes) aligns their quadrants to
    the stream's. Acceptance is the strict-turbo contract: the verified
    chunk-lane prefix is decision-final by induction from the exact lane-0
    entry (_lane_ok_np); its symbols are emitted rotated into the stream's
    gauge (exact sign/swap) and the exit carry at the prefix boundary,
    rotated likewise, continues the stream. A non-verified suffix is NOT
    consumed; the caller re-demodulates it sequentially (so worst case
    costs one redundant pass over the span, never wrong output). A flagged
    lane ends the accepted prefix the same way.

    OQPSK: accepted lane prefixes are additionally shrunk to the longest
    one ending at an EVEN cumulative gauge (K[P-1] % 2 == 0). An
    odd-gauge exit swaps the half-symbol I/Q labeling, and finalizing it
    mid-stream would need the global re-pairing surgery documented in
    _assemble_oqpsk_gauge, while an even-gauge exit carry rotates by
    pure sign flips (p_phase += K*pi/2; t_prev/inphase *= _OQ_SIGNS),
    exactly like QPSK. Lane gauges are near-uniform, so the shrink
    discards ~1 lane in expectation (geometric, p=1/2); the unconsumed
    lanes stay buffered and join the caller's next span, never
    re-demodulated sequentially.

    xf: (N, 2) float32 span with N == chunks * kb * cfg.block_len for an
    integer kb >= 2 (the caller sizes spans; no tail handling here).
    The symbols come back through the int8 quantizer (span_finish): each
    component is twice its .s byte.
    """
    return span_finish(cfg, span_submit(
        cfg, carry0, xf, chunks=chunks, max_passes=max_passes,
        device=device, warmup_blocks=warmup_blocks))


def span_submit(cfg: DemodConfig, carry0: dict, xf: np.ndarray,
                chunks: int = 32, max_passes: int = 4, device=None,
                warmup_blocks: int | None = None) -> SpanPending:
    """Run one span's gauge fixpoint and decide acceptance.

    Returns once the small data (exit carries, gauges, per-lane
    convergence, last emitted symbol values) is back; the bulk symbol
    payload stays ON THE DEVICE in .outs (quantized to int8,
    pipeline.quantize) until span_finish. See demod_span_turbo for the
    contract."""
    cfg.validate()
    device = select_device(device)
    N = len(xf)
    L = cfg.block_len
    taps = cfg.taps
    kb = N // (chunks * L)
    if kb * chunks * L != N or kb < 2:
        raise ValueError(f"span length {N} != chunks*kb*L with kb >= 2")
    chunk_len = kb * L
    carry0 = {name: np.asarray(carry0[name]) for name in CARRY_FIELDS}
    xf = np.ascontiguousarray(xf, dtype=np.float32)

    tails = boundary_tails(xf, chunks, chunk_len, taps)
    tails[0] = carry0["fir_tail"]
    kb_w = min(warmup_blocks or default_warmup_blocks(L, kb), kb)
    blocks = to_device(xf, device).view(chunks, chunk_len, 2)
    init_np = {name: v[None] for name, v in carry0.items()}
    w_np = run_warmup(cfg, blocks, xf, kb_w, tails, init_np)
    f_np, outs, K, passes, converged, _, lane_ok, stats = gauge_fixpoint(
        cfg, make_pass_runner(cfg, blocks, last_symbol=True), w_np, tails,
        max_passes, init_np=init_np)

    # Per-lane safety flags mask into the acceptance diagnostics instead
    # of rejecting the whole span: the verified-prefix induction only
    # needs every ACCEPTED lane flag-free (a flagged lane's own exit is
    # suspect, so it and everything after it stay unconsumed; the prefix
    # before it is untainted, the same reasoning as lane_ok itself).
    flags_np = np.asarray(f_np["flags"])
    lane_ok = np.asarray(lane_ok, bool) & (flags_np == 0)
    converged = bool(converged) and bool(np.all(flags_np == 0))
    P = verified_prefix(lane_ok)
    if cfg.oqpsk:
        # Odd-gauge exits swap the half-symbol labeling (see
        # demod_span_turbo's docstring): shrink to the longest even-gauge
        # boundary.
        while P > 0 and int(K[P - 1]) % 2 != 0:
            P -= 1
    if P == 0:
        return SpanPending(None, f_np, K, passes, converged, 0, 0, None)

    exit_c = {name: np.asarray(f_np[name])[P - 1] for name in CARRY_FIELDS}
    kexit = int(K[P - 1]) % 4
    if kexit:
        # Rotate the exit carry into the stream's gauge (see
        # demod_array_turbo's tail continuation for the derivation):
        # symbols transform by e^{-j K pi/2} -> NCO phase shifts by
        # +K pi/2.
        exit_c["p_phase"] = np.float32(np.mod(
            float(exit_c["p_phase"]) + kexit * float(_HALF_PI), 2 * np.pi))
        if cfg.oqpsk:                        # even by construction: signs
            s = _OQ_SIGNS[kexit][0]
            exit_c["t_prev"] = np.float32(s * float(exit_c["t_prev"]))
            exit_c["inphase"] = np.float32(s * float(exit_c["inphase"]))
        else:                   # t_prev becomes the last EMITTED symbol's Q
            exit_c["t_prev"] = np.float32(
                _span_last_q(carry0, K, P, stats))
    exit_c.update(tick=np.int32(0), flags=np.int32(0))
    packed = PackedOutput(
        sym_i=quantize(outs.sym_re[:P]).to(torch.int8),
        sym_q=quantize(outs.sym_im[:P]).to(torch.int8),
        valid=outs.valid[:P].to(torch.int8),
        locked_once=outs.locked_once[:P].to(torch.int8))
    return SpanPending(packed, f_np, K, passes, converged, P,
                       P * chunk_len, exit_c)


def _span_last_q(carry0: dict, K, P: int, stats) -> float:
    """Q component of the last symbol the accepted prefix emits, in the
    stream's gauge: the exit carry's t_prev (timing.c:65-66 keeps the
    previous symbol's Q). From the pass's small stats (per-lane valid count
    and last valid symbol); no bulk fetch."""
    n_valid, _, _, last_re, last_im = stats
    nz = np.nonzero(n_valid[:P] > 0)[0]
    if len(nz) == 0:
        return float(carry0["t_prev"])
    c = int(nz[-1])
    return float(rotate_quadrant(last_re[c], last_im[c], K[c])[1])


def span_finish(cfg: DemodConfig, pending: SpanPending) -> SpanResult:
    """Fetch the accepted prefix's symbol payload and assemble it: each
    component is 2x its int8 byte, which the writer's quantizer maps back
    to the byte exactly."""
    if pending.P == 0:
        return SpanResult(np.zeros(0, dtype=_SYM_DTYPE), None, 0,
                          pending.passes, pending.converged, 0)
    P, K, f_np = pending.P, pending.K, pending.f_np
    sym_re, sym_im, valid, lonce = to_host(
        dataclasses.astuple(pending.outs), copy=False)       # assembled now
    lonce = lonce.astype(np.int32)
    if cfg.oqpsk:
        symbols = _assemble_oqpsk_gauge(
            sym_re.astype(np.float32) * np.float32(2.0),
            sym_im.astype(np.float32) * np.float32(2.0), valid, lonce,
            K[:P], f_np["slot"][:P], f_np["inphase"][:P],
            f_np["locked_once"][:P], None)
    else:
        symbols = _assemble_qpsk_gauge(sym_re, sym_im, valid, lonce, K,
                                       scale=2.0)
    return SpanResult(symbols, pending.exit_carry, pending.consumed,
                      pending.passes, pending.converged, P)
