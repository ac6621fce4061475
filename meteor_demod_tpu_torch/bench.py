"""Benchmark of the port on one NVIDIA card: the JAX package's root bench.py,
section by section, on the port's entry points.

    python -m meteor_demod_tpu_torch.bench

Log lines go to stderr; the last line of stdout is ONE compact JSON object
with the root bench.py's field names (its l.887-950), "device": "cuda", the
card's name ("card"), its power limit in W ("power_limit_w", from
nvidia-smi) and each section's launch counts of the two recurrence kernels
("kernel_launches": both counts are set to 0 just before a section and read
just after). The fields of features the port does not have are left out,
each named with its reason in ABSENT_ON_PORT; no field is null.

Sections, in the root bench's order, all of them every run:
  fleet         128 streams x 16 chained blocks of one 400 Hz, 18 dB QPSK
                signal broadcast on the card (the headline)
  single        one stream (B = 1) through the same chained program
  turbo         demod_array_turbo on one 134-Msample recording (a
                seam-periodic chunk tiled over 128 lanes x 128 blocks)
  oqpsk         the fleet at 80 ksym/s OQPSK
  hifi          the fleet at rrc_order 64, interp 10
  turbo_oqpsk   turbo in OQPSK (seed 5, kb snapped to whole symbols)
  turbo_mesh1   turbo with mesh=[the card]
  span          span_submit / span_finish pipelined from a locked carry
  fir           dsp/fir.py's FIR against parallel/timeshard.py's on one card
  acq_diverse   cold acquisition of 16 carrier/SNR groups and a noise lane,
                then a sweep-rescue kick of the lanes that never locked
  acq_ramp      cold acquisition of carriers ramping at -500 Hz/s
  acq_edge, acq_neg_edge  cold acquisition at +-0.85 fmax
  hifi_pllbw    the hi-fi fleet at pll_bw 0.5 and 2.0

Every section checks what it measured: flags 0 and every stream locked
before a fleet is timed, symbol counts within 1 % of nominal, the plain FIR
bitwise the time-sharded one, turbo converged with no flagged chunk, every
span's lanes all verified, lock statistics for every stream that locked. A
section that raises or fails a check ends the run with a non-zero exit and
no JSON line: a run that fails a correctness check reports no speed. The
bench measures on a CUDA card only; without one it raises before any
section runs.

Timing: a fleet call is CHAIN blocks queued on the card, a window ends in
torch.cuda.synchronize() and a readback of the carry's flags; rates are
samples over the host clock. Signal synthesis is set-up, outside every rate.
The section functions take device= (and smaller sizes) so that the tests
can run them on the CPU; main() never does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import torch

from .config import DemodConfig
from .demod.backend import make_batch_demod
from .demod.state import batch_carry, carry_to_numpy
from .demod.turbo import (default_warmup_blocks, demod_array_turbo,
                          span_finish, span_submit)
from .dsp.fir import iq_to_f32, make_fir_banks, polyphase_fir_block
from .kernels import block_demod as kernels
from .parallel.timeshard import make_sharded_fir
from .sim import synth_psk
from .utils import select_device, to_device

BASELINE_MSPS = 0.66
SAMPLERATE = 230400
REALTIME_SPS = 230400.0
BLOCK_LEN = 8192
CHAIN = 16            # blocks per chained call
FLEET_BATCH = 128
WINDOWS = 3           # timed windows a rate is the best of
# A fleet section chains calls until every stream is locked, up to this many
# seconds of signal (the 400 Hz signal locks within one 0.57 s call).
LOCK_SECONDS = 5.0
RAMP_CARRIERS = (80.0, 300.0, 700.0, 1400.0)
SECTIONS = ("single", "turbo", "oqpsk", "hifi", "turbo_oqpsk", "turbo_mesh1",
            "span", "fir", "acq_diverse", "acq_ramp", "acq_edge",
            "acq_neg_edge", "hifi_pllbw")

_BANDED = ("tau0-banded serving groups (config.tau0_band) narrow the TPU "
           "kernel's candidate windows; the port's kernels read Ft[tau] "
           "directly and have no windows to band (ROADMAP list D)")
_PARKED = ("straggler parking exists for the TPU's wide<->locked program "
           "switch; the port runs one program for locked and unlocked "
           "streams, so there is no parked or pinned rate (ROADMAP list D)")
_SWITCH = ("the wide->locked program switch has no counterpart: the port "
           "has one program (ROADMAP list D)")
# Fields of the root bench.py's line (and of its acquisition dicts, dotted)
# that the port leaves out, with the reason.
ABSENT_ON_PORT = {
    "hifi_banded_tau0_msamples_per_s": _BANDED,
    "hifi_banded_spread_msps": _BANDED,
    "hifi_banded4_tau0_msamples_per_s": _BANDED,
    "qpsk_banded_tau0_msamples_per_s": _BANDED,
    "fleet_acquisition_diverse.mixed_parked_msamples_per_s": _PARKED,
    "fleet_acquisition_diverse.pinned_wide_msamples_per_s": _PARKED,
    "fleet_acquisition_diverse.parked_vs_pinned_x": _PARKED,
    "fleet_acquisition_diverse.parked_vs_all_locked_ratio": _PARKED,
    "fleet_acquisition_fmax_edge.locked_first_dispatch_s": _SWITCH,
    "fleet_acquisition_fmax_edge.locked_steady_dispatch_s": _SWITCH,
    "fleet_acquisition_neg_fmax_edge.locked_first_dispatch_s": _SWITCH,
    "fleet_acquisition_neg_fmax_edge.locked_steady_dispatch_s": _SWITCH,
}
# Fields of the port's line that the root bench.py has not.
PORT_ONLY = ("card", "power_limit_w", "kernel_launches")


class GateError(RuntimeError):
    """A section's correctness check failed: the run reports no speed."""


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise GateError(what)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _make_signal(cfg, n_samples, seed=0, carrier_hz=400.0):
    nsym = int(n_samples * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier_hz,
                     amplitude=6000.0, snr_db=18.0, seed=seed)
    return x[:n_samples]


def _spread(rates):
    """Sorted per-window rates -> [min, median, max] in Msamples/s."""
    r = sorted(rates)
    med = r[len(r) // 2] if len(r) % 2 else 0.5 * (r[len(r) // 2 - 1]
                                                   + r[len(r) // 2])
    return [round(r[0] / 1e6, 2), round(med / 1e6, 2),
            round(r[-1] / 1e6, 2)]


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sync(carry, nsym=None, nominal=None) -> None:
    """Wait for the card, then read the carry's flags back: they must be 0.
    With nsym (a chained call's symbol count, a tensor) it must lie within
    1 % of `nominal`."""
    _wait(carry.flags.device)
    flags = carry.flags.cpu().numpy()
    gate(not flags.any(), f"flags set on streams {np.nonzero(flags)[0]}")
    if nsym is not None:
        n = int(nsym)
        gate(abs(n - nominal) <= 0.01 * nominal,
             f"{n} symbols where {nominal:.0f} are nominal")


def _seam_carrier(carrier_hz, span, samplerate):
    """The carrier nearest carrier_hz that is periodic over `span` samples."""
    return round(carrier_hz * span / samplerate) * samplerate / span


def _blocks(cfg, x, chain, batch, device) -> torch.Tensor:
    """(chain, batch, L, 2) contiguous: the chain*L samples x uploaded once
    and broadcast across the streams on the device."""
    bl = iq_to_f32(x.reshape(chain, cfg.block_len))[:, None]
    return to_device(bl, device).expand(
        chain, batch, cfg.block_len, 2).contiguous()


def _chained_fn(cfg, batch, device):
    """chained(carry, blocks (K, batch, L, 2)) -> (carry', symbols): K
    blocks through make_batch_demod, queued without a wait; the symbol
    count stays on the device."""
    demod = make_batch_demod(cfg, batch, device=device)

    def chained(carry, blocks):
        nsym = torch.zeros((), dtype=torch.int64, device=blocks.device)
        for k in range(blocks.shape[0]):
            carry, outs = demod(carry, blocks[k])
            nsym = nsym + outs.valid.sum()
        return carry, nsym

    return chained


def _bench(cfg, batch, seconds, *, device, chain=CHAIN, windows=WINDOWS,
           carrier_hz=400.0):
    """Samples/s through the chained block demod in carrier-locked steady
    state: chained calls from cold until every stream is locked (checked),
    then a calibration call and `windows` windows of n_calls calls from the
    locked carry. batch None is one stream (B = 1). Returns (best
    samples/s, [min, med, max] Msamples/s)."""
    device = torch.device(device)
    B = batch or 1
    L = cfg.block_len
    blocks = _blocks(cfg, _make_signal(cfg, chain * L, carrier_hz=carrier_hz),
                     chain, B, device)
    carry = batch_carry(cfg, B, device)
    fn = _chained_fn(cfg, B, device)
    per_call = chain * L * B
    nominal = per_call * cfg.symrate / cfg.samplerate

    t0 = time.time()
    max_calls = max(1, math.ceil(LOCK_SECONDS * cfg.samplerate / (chain * L)))
    for calls in range(1, max_calls + 1):
        carry, nsym = fn(carry, blocks)
        _sync(carry, nsym, nominal)
        locked_n = int(carry.locked.sum())
        if locked_n == B:
            break
    gate(locked_n == B, f"{locked_n}/{B} streams locked after {calls} "
         f"chained calls")
    log(f"first call+lock (batch={batch}): {time.time() - t0:.1f}s, "
        f"{calls} calls, {locked_n}/{B} locked")

    # Calibrate, then run a fixed call count (an open-ended timed loop
    # would queue calls far faster than the card drains them).
    t0 = time.perf_counter()
    carry, nsym = fn(carry, blocks)
    _sync(carry, nsym, nominal)
    dt1 = time.perf_counter() - t0
    n_calls = max(3, min(100, int(seconds / dt1)))
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_calls):
            carry, nsym = fn(carry, blocks)
        _sync(carry, nsym, nominal)
        dt = time.perf_counter() - t0
        rates.append(n_calls * per_call / dt)
    rates.sort()
    sps = rates[-1]
    log(f"batch={batch}: {windows}x{n_calls} calls, best {sps/1e6:.2f} "
        f"Msamples/s (spread {'/'.join(f'{r/1e6:.1f}' for r in rates)})")
    return sps, _spread(rates)


def turbo_geometry(cfg, chunks, kb, carrier_hz=400.0) -> dict:
    """The root bench's turbo recording: kb snapped down to a chunk of whole
    symbols (QPSK 72k: every kb; OQPSK 80k: a multiple of 9), the carrier
    snapped to whole cycles a chunk, so that the chunk tiles seamlessly."""
    L = cfg.block_len
    fr = Fraction(float(cfg.symrate) / float(cfg.samplerate))
    step = (L * fr.limit_denominator(4096)).denominator
    kb = max(step, kb // step * step)
    chunk_len = kb * L
    return dict(kb=kb, kb_w=min(default_warmup_blocks(L, kb), kb),
                chunk_len=chunk_len, n_samples=chunks * chunk_len,
                carrier_hz=_seam_carrier(carrier_hz, chunk_len,
                                         cfg.samplerate))


def _bench_turbo(cfg, chunks=FLEET_BATCH, kb=128, max_passes=4, seed=3,
                 mesh=None, *, device, windows=WINDOWS, carrier_hz=400.0):
    """ONE recording of chunks*kb*block_len samples (134 Msamples by
    default) through demod_array_turbo from host memory, so each run pays
    its upload as `-T 0` does: one warm-up run, then the best of `windows`
    timed runs. With `mesh` the lanes go over that device list. Each run
    must converge with no flagged chunk and give the nominal symbol count
    within 1 %. Returns (samples/s, passes, converged, spread)."""
    device = torch.device(device)
    g = turbo_geometry(cfg, chunks, kb, carrier_hz)
    n_samples = g["n_samples"]
    t0 = time.perf_counter()
    nsym = int(g["chunk_len"] * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=g["carrier_hz"],
                     amplitude=6000.0, snr_db=18.0, seed=seed)
    rec = np.tile(iq_to_f32(x[:g["chunk_len"]]), (chunks, 1))
    log(f"turbo recording: {chunks} lanes x {g['kb']} blocks (warm-up "
        f"{g['kb_w']}), {n_samples / 1e6:.1f} Msamples, carrier "
        f"{g['carrier_hz']:.3f} Hz; synthesis {time.perf_counter() - t0:.1f}s"
        f" (not timed)")
    nominal = n_samples * cfg.symrate / cfg.samplerate
    where = dict(mesh=mesh) if mesh is not None else dict(device=device)

    def one_recording():
        r = demod_array_turbo(cfg, rec, chunks=chunks, max_passes=max_passes,
                              **where)
        gate(not r.fell_back, "a flagged chunk sent the recording to the "
             "sequential path")
        gate(r.converged, f"turbo did not converge in {r.passes} passes")
        gate(abs(len(r.symbols) - nominal) <= 0.01 * nominal,
             f"turbo gave {len(r.symbols)} symbols where {nominal:.0f} are "
             f"nominal")
        return r

    t0 = time.time()
    r = one_recording()
    log(f"turbo warm-up: {time.time() - t0:.1f}s, passes={r.passes}")
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        r = one_recording()
        times.append(time.perf_counter() - t0)
    rates = [n_samples / t for t in times]
    sps = max(rates)
    # The upload's share: the same utils.to_device of the recording that
    # each run makes, alone, waited for.
    t0 = time.perf_counter()
    up = to_device(rec, device)
    _wait(up.device)
    upload_s = time.perf_counter() - t0
    del up
    log(f"turbo{' (mesh)' if mesh is not None else ''}: "
        f"{n_samples/1e6:.0f} Msamples, best {sps/1e6:.1f} Msamples/s "
        f"(passes={r.passes}, conv={r.converged}); upload alone "
        f"{upload_s:.3f}s = {upload_s / min(times):.3f} of the best run")
    return sps, r.passes, r.converged, _spread(rates)


def _bench_stream_span(cfg, chunks=128, kb=16, nspans=6, *, device, nwarm=24,
                       windows=WINDOWS, carrier_hz=400.0):
    """One live stream's span-turbo throughput: span k+1 submitted from span
    k's exit carry before span k's symbols are fetched (span_submit /
    span_finish), from a carry locked by nwarm blocks of the chained
    program at B = 1. The span is seam-periodic, so one span chains into
    itself; each span is uploaded from the host (span_submit takes host
    samples). Every span must verify all its lanes and give symbols.
    Returns (samples/s, passes, verified_all, spread, warm-up s of two
    spans, first-span s)."""
    device = torch.device(device)
    L = cfg.block_len
    span_n = chunks * kb * L
    if (span_n * int(cfg.symrate)) % int(cfg.samplerate):
        raise ValueError(f"a span of {span_n} samples holds no whole number "
                         f"of symbols")
    t0 = time.perf_counter()
    carrier = _seam_carrier(carrier_hz, span_n, cfg.samplerate)
    nsym = int((nwarm * L + span_n) * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=9)
    xf_all = iq_to_f32(x[:nwarm * L + span_n])
    log(f"stream-span: {chunks} lanes x {kb} blocks a span; synthesis "
        f"{time.perf_counter() - t0:.1f}s (not timed)")

    # Lock the stream with the chained program, as the stream driver does.
    wide = _chained_fn(cfg, 1, device)
    carry = batch_carry(cfg, 1, device)
    warm = to_device(np.ascontiguousarray(
        xf_all[:nwarm * L]).reshape(nwarm, 1, L, 2), device)
    carry, _ = wide(carry, warm)
    _sync(carry)
    carry_np = {k: v[0] for k, v in carry_to_numpy(carry).items()}
    gate(int(carry_np["locked"]) == 1,
         f"the stream is not locked after {nwarm} blocks")
    xf_span = np.ascontiguousarray(xf_all[nwarm * L:])

    def run_spans(n):
        """n consecutive spans, pipelined; returns (consumed, passes)."""
        c = carry_np
        consumed, nsym_out = 0, 0
        pend = None
        for _ in range(n):
            p = span_submit(cfg, c, xf_span, chunks=chunks, device=device)
            gate(p.P == chunks, f"a span verified {p.P} of {chunks} lanes")
            consumed += p.consumed
            c = p.exit_carry
            if pend is not None:
                nsym_out += len(span_finish(cfg, pend).symbols)
            pend = p
        nsym_out += len(span_finish(cfg, pend).symbols)
        gate(nsym_out > 0, "the spans gave no symbols")
        return consumed, p.passes

    # Two spans warm the pipeline (and the caches of a first use).
    t0 = time.time()
    consumed, passes = run_spans(2)
    warm_s = time.time() - t0
    log(f"stream-span warm-up: {warm_s:.1f}s, passes={passes}")
    t0 = time.perf_counter()
    consumed1, _ = run_spans(1)
    first_span_s = time.perf_counter() - t0
    log(f"stream-span first-span latency: {first_span_s:.2f}s "
        f"({consumed1/1e6:.1f} Msamples)")
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        consumed, passes = run_spans(nspans)
        rates.append(consumed / (time.perf_counter() - t0))
    sps = max(rates)
    log(f"stream-span: best {sps/1e6:.1f} Msamples/s (passes={passes}, "
        f"every span verified)")
    return (sps, passes, True, _spread(rates), round(warm_s, 1),
            round(first_span_s, 2))


def _acq_chained(cfg, batch, device):
    """chained(carry, blocks (K, batch, L, 2)) -> (carry', locked_once rows
    (K, batch, R)) on the device."""
    demod = make_batch_demod(cfg, batch, device=device)

    def chained_lo(carry, blocks):
        rows = []
        for k in range(blocks.shape[0]):
            carry, outs = demod(carry, blocks[k])
            rows.append(outs.locked_once)
        return carry, torch.stack(rows)

    return chained_lo


def update_lock_steps(lock_step: np.ndarray, base: int, lo: np.ndarray,
                      oqpsk: bool) -> int:
    """Fold one call's locked_once rows (K, B, R) into lock_step (B,): the
    first step at which each stream's locked_once is set, counted from the
    first call, -1 while it is not. A step is one gate evaluation (about a
    symbol); OQPSK's row 0 of a block is its pre-fire, not a step, and is
    dropped. Returns the step count after this call."""
    if oqpsk:
        lo = lo[:, :, 1:]
    lo = lo.transpose(1, 0, 2).reshape(lo.shape[1], -1)
    first = np.argmax(lo > 0, axis=1)
    hit = (lo > 0).any(axis=1) & (lock_step < 0)
    lock_step[hit] = base + first[hit]
    return base + lo.shape[1]


def _replay_lock_steps(cfg, fn, calls, batch, device) -> np.ndarray:
    """Per-stream lock steps of a cold fleet over the calls' blocks, each
    call's rows read back (so not timed)."""
    lock_step = np.full(batch, -1, np.int64)
    carry = batch_carry(cfg, batch, device)
    base = 0
    for blocks in calls:
        carry, lo = fn(carry, blocks)
        base = update_lock_steps(lock_step, base, lo.cpu().numpy(),
                                 cfg.oqpsk)
    _sync(carry)
    return lock_step


def _lock_stats(cfg, lock_step, p90=False) -> dict:
    """Lock times in seconds of signal over the streams that locked; at
    least one must have."""
    locked = lock_step >= 0
    gate(bool(locked.any()), "no stream locked: no lock statistics")
    lock_s = (lock_step[locked] * cfg.ticks_per_step / cfg.interp
              / cfg.samplerate)
    out = {"lock_signal_s_p50": round(float(np.median(lock_s)), 3)}
    if p90:
        out["lock_signal_s_p90"] = round(float(np.percentile(lock_s, 90)), 3)
    out["lock_signal_s_max"] = round(float(lock_s.max()), 3)
    return out


def _dwell(fn, carry, blocks, max_disp, want):
    """Chained calls until `want` streams are locked (read back after each
    call) or max_disp calls: (carry, calls, locked, seconds)."""
    t0 = time.perf_counter()
    disp, locked_n = 0, 0
    while disp < max_disp:
        carry, _ = fn(carry, blocks)
        disp += 1
        locked_n = int(carry.locked.sum())
        if locked_n >= want:
            break
    return carry, disp, locked_n, time.perf_counter() - t0


def diverse_groups(cfg, span, batch, seed=33, groups=16, frac=0.85
                   ) -> tuple[list[dict], np.ndarray]:
    """The root bench's diverse acquisition workload: the groups (carriers
    uniform in +-frac * fmax, each snapped to whole cycles a span; SNR
    cycling 12/15/18/25 dB; seed seed + g) and the lane map (lane 0 takes
    row 0, the noise; lane i >= 1 takes group row 1 + (i - 1) % groups)."""
    fmax_hz = float(cfg.pll_fmax) * cfg.symrate / (2 * np.pi)
    fracs = np.linspace(-frac, frac, groups)
    snrs = [12.0, 15.0, 18.0, 25.0]
    meta = [dict(carrier_hz=_seam_carrier(fracs[g] * fmax_hz, span,
                                          cfg.samplerate),
                 snr_db=snrs[g % len(snrs)], seed=seed + g)
            for g in range(groups)]
    lane_map = np.zeros(batch, np.int64)
    lane_map[1:] = 1 + (np.arange(batch - 1) % groups)
    return meta, lane_map


def ramp_groups(batch, seed=44, carriers=RAMP_CARRIERS
                ) -> tuple[list[dict], np.ndarray]:
    """The root bench's ramp workload: one group a carrier (seed seed + g)
    and the lane map (lane i takes group i % groups)."""
    meta = [dict(carrier_hz=c, seed=seed + g) for g, c in enumerate(carriers)]
    return meta, np.arange(batch) % len(carriers)


def _bench_acquisition_diverse(cfg, batch=FLEET_BATCH, max_disp=120, seed=33,
                               *, device, chain=CHAIN, groups=16, frac=0.85):
    """Per-stream diverse cold acquisition: 16 signal groups over both sweep
    directions and mixed SNRs, lane 0 pure noise (a dead antenna). Chained
    calls until every signal lane is locked (timed), a replay for the exact
    lock steps, then the sweep-rescue leg: every lane that never locked is
    kicked onto the downward escape sweep (p_freq = +fmax, updown = -1, as
    FleetDemodulator's sweep rescue does) and run until the signal lanes
    are locked or 30 more calls. The leg runs whenever a lane never locked
    (the root bench's, only when more than one did), so that its counts are
    always reported."""
    device = torch.device(device)
    L = cfg.block_len
    span = chain * L
    t0 = time.perf_counter()
    meta, lane_map = diverse_groups(cfg, span, batch, seed, groups, frac)
    sigs = []
    for m in meta:
        x, _ = synth_psk(int(span * cfg.symrate / cfg.samplerate) + 64,
                         cfg.samplerate, symrate=cfg.symrate,
                         oqpsk=cfg.oqpsk, carrier_hz=m["carrier_hz"],
                         amplitude=6000.0, snr_db=m["snr_db"], seed=m["seed"])
        sigs.append(iq_to_f32(x[:span]).reshape(chain, L, 2))
    rng = np.random.default_rng(seed)
    noise = (500.0 * (rng.standard_normal(span)
                      + 1j * rng.standard_normal(span))).astype(np.complex64)
    sigs.insert(0, iq_to_f32(noise).reshape(chain, L, 2))
    blocks = to_device(np.stack(sigs, axis=1), device).index_select(
        1, torch.as_tensor(lane_map, device=device)).contiguous()
    log(f"acquisition[diverse]: synthesis {time.perf_counter() - t0:.1f}s "
        f"(not timed)")

    fn = _acq_chained(cfg, batch, device)
    c0, _ = fn(batch_carry(cfg, batch, device), blocks)      # warm (untimed)
    _sync(c0)
    carry, disp, locked_n, dwell_s = _dwell(
        fn, batch_carry(cfg, batch, device), blocks, max_disp, batch - 1)
    _sync(carry)
    lock_step = _replay_lock_steps(cfg, fn, [blocks] * disp, batch, device)
    locked_mask = lock_step >= 0
    out = {
        "groups": [{"carrier_hz": round(m["carrier_hz"], 1),
                    "snr_db": m["snr_db"]} for m in meta],
        "noise_streams": 1,
        "streams_locked": int(locked_mask.sum()),
        "all_signal_locked": locked_n >= batch - 1,
        "noise_lane_locked": bool(locked_mask[0]),
        "per_group_locked": {g: int(locked_mask[lane_map == 1 + g].sum())
                             for g in range(groups)},
        "wide_dwell_s": round(dwell_s, 2),
        "signal_dwelled_s": round(disp * span / cfg.samplerate, 2),
        **_lock_stats(cfg, lock_step, p90=True),
    }
    after = carry.locked.cpu().numpy()
    unlocked = np.nonzero(after == 0)[0]
    out["never_locked_streams"] = int(len(unlocked))

    # Sweep-rescue leg.
    extra = 0
    if len(unlocked):
        idx = torch.as_tensor(unlocked, device=carry.p_freq.device)
        p_freq, updown = carry.p_freq.clone(), carry.updown.clone()
        p_freq[idx] = float(cfg.pll_fmax)
        updown[idx] = -1.0
        c3 = dataclasses.replace(carry, p_freq=p_freq, updown=updown)
        c3, extra, _, _ = _dwell(fn, c3, blocks, 30, batch - 1)
        _sync(c3)
        after = c3.locked.cpu().numpy()
    out["rescue_kick"] = {
        "kicked_streams": int(len(unlocked)),
        "rescued_streams": int((after[unlocked] != 0).sum()),
        "extra_signal_s": round(extra * span / cfg.samplerate, 2),
        "never_locked_after_rescue": int((after == 0).sum()),
    }
    log(f"acquisition[diverse]: "
        f"{ {k: v for k, v in out.items() if k != 'groups'} }")
    return out


def _bench_acquisition_ramp(cfg, batch=FLEET_BATCH, ramp_hz_s=-500.0,
                            n_disp=4, seed=44, *, device, chain=CHAIN,
                            carriers=RAMP_CARRIERS):
    """Moving-target acquisition: carriers ramping at ramp_hz_s (16x the
    LEO peak rate), n_disp chained calls of fresh signal per lane, 4
    carrier groups across the batch (lane i takes group i % 4), seeds
    seed + g."""
    device = torch.device(device)
    L = cfg.block_len
    span = chain * L
    total = n_disp * span
    meta, lane_map = ramp_groups(batch, seed, carriers)
    t0 = time.perf_counter()
    sigs = []
    for m in meta:
        x, _ = synth_psk(int(total * cfg.symrate / cfg.samplerate) + 64,
                         cfg.samplerate, symrate=cfg.symrate,
                         oqpsk=cfg.oqpsk, carrier_hz=m["carrier_hz"],
                         carrier_ramp_hz_s=ramp_hz_s, amplitude=6000.0,
                         snr_db=18.0, seed=m["seed"])
        sigs.append(iq_to_f32(x[:total]).reshape(n_disp, chain, L, 2))
    blocks = to_device(np.stack(sigs, axis=2), device).index_select(
        2, torch.as_tensor(lane_map, device=device)).contiguous()
    log(f"acquisition[ramp]: synthesis {time.perf_counter() - t0:.1f}s "
        f"(not timed)")

    lock_step = _replay_lock_steps(cfg, _acq_chained(cfg, batch, device),
                                   blocks, batch, device)
    locked_mask = lock_step >= 0
    out = {
        "ramp_hz_s": ramp_hz_s,
        "carriers_hz": list(carriers),
        "signal_s": round(total / cfg.samplerate, 2),
        "streams_locked": int(locked_mask.sum()),
        "streams_total": batch,
        "per_group_locked": [int(locked_mask[lane_map == g].sum())
                             for g in range(len(meta))],
        **_lock_stats(cfg, lock_step),
    }
    log(f"acquisition[ramp]: {out}")
    return out


def _bench_acquisition(cfg, batch=FLEET_BATCH, max_disp=40,
                       carrier_hz=400.0, tag="nominal", *, device,
                       chain=CHAIN):
    """Cold start -> all locked (pll.c:109-130 sweep, pll.c:117-123
    hysteresis): a cold fleet runs the chained program on a seam-periodic
    span broadcast on the card, reading the locked count after each call,
    until every stream is locked or max_disp calls (timed); an untimed
    replay reads the locked_once rows for each stream's lock step."""
    device = torch.device(device)
    L = cfg.block_len
    span = chain * L
    carrier = _seam_carrier(carrier_hz, span, cfg.samplerate)
    nsym = int(span * cfg.symrate / cfg.samplerate) + 64
    x, _ = synth_psk(nsym, cfg.samplerate, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=carrier,
                     amplitude=6000.0, snr_db=18.0, seed=21)
    blocks = _blocks(cfg, x[:span], chain, batch, device)

    fn = _acq_chained(cfg, batch, device)
    c, _ = fn(batch_carry(cfg, batch, device), blocks)      # warm (untimed)
    _sync(c)
    carry, disp, locked_n, dwell_s = _dwell(
        fn, batch_carry(cfg, batch, device), blocks, max_disp, batch)
    _sync(carry)
    samples = disp * span
    lock_step = _replay_lock_steps(cfg, fn, [blocks] * disp, batch, device)
    out = {
        "carrier_hz": round(carrier, 1),
        "all_locked": locked_n == batch,
        "streams_locked": int((lock_step >= 0).sum()),
        "dispatches": disp,
        "samples_dwelled": samples,
        "wide_dwell_s": round(dwell_s, 2),
        "acq_realtime_x": round(samples / cfg.samplerate / dwell_s, 1),
        **_lock_stats(cfg, lock_step),
    }
    log(f"acquisition[{tag}]: {out}")
    return out


def _bench_fir(cfg, seconds=2.0, *, device, n=1 << 21, windows=WINDOWS):
    """The time-sharded FIR (parallel/timeshard.py) on a one-device list
    against the plain FIR (dsp/fir.py) on n samples of one stream, both in
    full float32 (TF32 off, checked), their outputs held bitwise equal
    first. The plain FIR reads samples already on the device; the sharded
    one takes host samples and uploads them each call, as its callers give
    them. Returns {"sharded": (best, spread), "plain": (best, spread)} in
    input samples/s."""
    device = torch.device(device)
    gate(not torch.backends.cudnn.allow_tf32
         and not torch.backends.cuda.matmul.allow_tf32,
         "TF32 is on: the FIR must run in full float32")
    fir_sh = make_sharded_fir(cfg, [device])
    banks = torch.as_tensor(make_fir_banks(cfg), device=device)
    xf = iq_to_f32(_make_signal(cfg, n))
    x_dev = to_device(xf, device)[None]
    tail0 = torch.zeros((1, cfg.taps - 1, 2), device=device)
    fns = {
        "sharded": lambda: fir_sh(xf)[0],
        "plain": lambda: polyphase_fir_block(x_dev, tail0, banks)[0],
    }
    a, b = fns["sharded"](), fns["plain"]()
    if not torch.equal(a, b):
        bad = torch.nonzero((a != b).any(dim=2).any(dim=1))[0].item()
        raise GateError(f"the time-sharded FIR differs from the plain one, "
                        f"first at tick {bad}")
    out = {}
    for name, fn in fns.items():
        fn()
        _wait(device)                                      # warm
        t0 = time.perf_counter()
        fn()
        _wait(device)
        dt1 = time.perf_counter() - t0
        n_calls = max(30, min(300, int(seconds / max(dt1, 1e-4))))
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(n_calls):
                fn()
            _wait(device)
            rates.append(n_calls * n / (time.perf_counter() - t0))
        out[name] = (max(rates), _spread(rates))
        log(f"fir {name}: {windows}x{n_calls} calls, best "
            f"{max(rates)/1e6:.0f} Msamples/s")
    return out


def card_device() -> torch.device:
    """The card the bench measures on; raises without one (a CPU device,
    under METEOR_DEMOD_PLATFORM=cpu, too)."""
    device = select_device()
    if device.type != "cuda":
        raise RuntimeError("the bench measures on a CUDA card only; unset "
                           "METEOR_DEMOD_PLATFORM")
    return device


def power_limit() -> tuple[str, float]:
    """nvidia-smi's "name, power limit" line of the first card, and the
    limit in W."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    return smi, float(smi.rsplit(",", 1)[1].split()[0])


def run_sections(sections, device) -> tuple[dict, dict]:
    """The headline and then each section of `sections`, in the root bench's
    order: each section's result by name, and its launch counts of the two
    kernels by name (both set to 0 just before the section and read just
    after). Nothing is caught."""
    cfg = DemodConfig(samplerate=SAMPLERATE, block_len=BLOCK_LEN)
    oq = DemodConfig(samplerate=SAMPLERATE, symrate=80000.0, oqpsk=True,
                     block_len=BLOCK_LEN)

    def hifi(**kw):
        return DemodConfig(samplerate=SAMPLERATE, rrc_order=64, interp=10,
                           block_len=BLOCK_LEN, **kw)

    fmax_hz = float(cfg.pll_fmax) * cfg.symrate / (2 * np.pi)
    d = dict(device=device)
    plan = {
        "fleet": lambda: _bench(cfg, FLEET_BATCH, 3.0, **d),
        "single": lambda: _bench(cfg, None, 2.0, **d),
        "turbo": lambda: _bench_turbo(cfg, **d),
        "oqpsk": lambda: _bench(oq, FLEET_BATCH, 2.0, **d),
        "hifi": lambda: _bench(hifi(), FLEET_BATCH, 2.0, **d),
        "turbo_oqpsk": lambda: _bench_turbo(oq, seed=5, **d),
        "turbo_mesh1": lambda: _bench_turbo(cfg, mesh=[device], **d),
        "span": lambda: _bench_stream_span(cfg, **d),
        "fir": lambda: _bench_fir(cfg, **d),
        "acq_diverse": lambda: _bench_acquisition_diverse(cfg, **d),
        "acq_ramp": lambda: _bench_acquisition_ramp(cfg, **d),
        "acq_edge": lambda: _bench_acquisition(
            cfg, carrier_hz=0.85 * fmax_hz, tag="fmax-edge", max_disp=60, **d),
        "acq_neg_edge": lambda: _bench_acquisition(
            cfg, carrier_hz=-0.85 * fmax_hz, tag="neg-fmax-edge",
            max_disp=160, **d),
        "hifi_pllbw": lambda: {str(bw): _bench(hifi(pll_bw=bw), FLEET_BATCH,
                                               1.5, **d)
                               for bw in (0.5, 2.0)},
    }
    res, launches = {}, {}
    for name, thunk in plan.items():
        if name == "fleet" or name in sections:
            kernels.block_demod.launches = 0
            kernels.block_demod_oqpsk.launches = 0
            t0 = time.perf_counter()
            res[name] = thunk()
            launches[name] = {
                "block_demod": kernels.block_demod.launches,
                "block_demod_oqpsk": kernels.block_demod_oqpsk.launches}
            log(f"section {name}: {time.perf_counter() - t0:.1f}s, kernel "
                f"launches {launches[name]}")
    return res, launches


def compose_line(res: dict, card: str, power_limit_w: float,
                 launches: dict) -> dict:
    """The JSON line: the root bench's fields of the sections in `res` and
    `launches` (run_sections' results; "fleet" always), its rounding, and
    PORT_ONLY. Raises if any value is None."""
    fleet_sps, fleet_spread = res["fleet"]
    value = fleet_sps / 1e6
    line = {
        "metric": "iq_demod_Msamples_per_s_per_chip_230ksps_qpsk_128stream_fleet",
        "value": round(value, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(value / BASELINE_MSPS, 1),
        "fleet_batch": FLEET_BATCH,
        "fleet_realtime_x_per_chip": round(fleet_sps / REALTIME_SPS, 1),
        "fleet_spread_msps": fleet_spread,
    }
    if "single" in res:
        sps, spread = res["single"]
        line.update(single_stream_msamples_per_s=round(sps / 1e6, 3),
                    single_stream_realtime_x=round(sps / REALTIME_SPS, 1),
                    single_stream_spread_msps=spread)
    if "span" in res:
        sps, passes, _, spread, warm_s, first_s = res["span"]
        line.update(stream_span_msamples_per_s=round(sps / 1e6, 1),
                    stream_span_realtime_x=round(sps / REALTIME_SPS, 1),
                    stream_span_passes=passes,
                    stream_span_spread_msps=spread,
                    stream_span_compile_warm_s=warm_s,
                    stream_span_first_span_s=first_s)
    if "turbo" in res:
        sps, passes, conv, spread = res["turbo"]
        line.update(turbo_single_recording_msamples_per_s=round(sps / 1e6, 1),
                    turbo_single_recording_realtime_x=round(
                        sps / REALTIME_SPS, 1),
                    turbo_passes=passes, turbo_converged=conv,
                    turbo_spread_msps=spread)
    if "turbo_oqpsk" in res:
        sps, passes, _, spread = res["turbo_oqpsk"]
        line.update(
            turbo_oqpsk_single_recording_msamples_per_s=round(sps / 1e6, 1),
            turbo_oqpsk_passes=passes, turbo_oqpsk_spread_msps=spread)
    if "turbo_mesh1" in res:
        sps, _, _, spread = res["turbo_mesh1"]
        line.update(turbo_mesh1_msamples_per_s=round(sps / 1e6, 1),
                    turbo_mesh1_spread_msps=spread)
    if "oqpsk" in res:
        sps, spread = res["oqpsk"]
        line.update(oqpsk_fleet_msamples_per_s=round(sps / 1e6, 2),
                    oqpsk_fleet_spread_msps=spread)
    if "hifi" in res:
        sps, spread = res["hifi"]
        line.update(hifi_o64_x10_fleet_msamples_per_s=round(sps / 1e6, 2),
                    hifi_fleet_spread_msps=spread)
    if "fir" in res:
        line.update(
            timeshard_fir_msamples_per_s=round(res["fir"]["sharded"][0] / 1e6,
                                               1),
            plain_fir_msamples_per_s=round(res["fir"]["plain"][0] / 1e6, 1))
    for name, field in (("acq_diverse", "fleet_acquisition_diverse"),
                        ("acq_ramp", "fleet_acquisition_ramp"),
                        ("acq_edge", "fleet_acquisition_fmax_edge"),
                        ("acq_neg_edge", "fleet_acquisition_neg_fmax_edge")):
        if name in res:
            line[field] = res[name]
    if "hifi_pllbw" in res:
        pllbw = {bw: round(r[0] / 1e6, 2)
                 for bw, r in res["hifi_pllbw"].items()}
        if "hifi" in res:
            pllbw["1.0"] = round(res["hifi"][0] / 1e6, 2)
        line["hifi_pllbw_fleet_msamples_per_s"] = pllbw
    line.update(device="cuda", block_len=BLOCK_LEN,
                chained_blocks_per_dispatch=CHAIN, card=card,
                power_limit_w=power_limit_w, kernel_launches=launches)
    gate(not _has_none(line), f"a field of the line is null: {line}")
    return line


def _has_none(v) -> bool:
    if isinstance(v, dict):
        return any(_has_none(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_has_none(x) for x in v)
    return v is None


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m meteor_demod_tpu_torch.bench",
        description="The port's bench on one CUDA card: every section of "
                    "the root bench.py (see the module docstring)."
    ).parse_args(argv)
    device = card_device()
    smi, watts = power_limit()
    card = torch.cuda.get_device_name(device)
    log(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    res, launches = run_sections(SECTIONS, device)
    line = compose_line(res, card, watts, launches)
    print(json.dumps(line, separators=(",", ":")), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
