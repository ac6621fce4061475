#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (meteor_demod_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repo root, on a machine with one
                                   # NVIDIA Hopper card and the CUDA toolkit

Phases, one line each; any failed check raises and the script exits non-zero:
  (a) build the CUDA recurrence kernels (QPSK and OQPSK, one source) from
      csrc/ with nvcc; print the card's name and power limit;
  (b) QPSK kernel vs plain torch recurrence on the same card-computed FIR
      output: the default config (230.4 ksps QPSK, block_len 8192), 128
      simulated streams (carriers +50..+600 Hz, SNR 12-25 dB, DC offsets, one
      noise-only stream), 2 chained blocks, every output and carry leaf
      bitwise; then streams 0-1 against the numpy oracle; kernel and plain
      times per block at B = 128, the kernel's at B = 1, and its bound at
      B = 128 (bytes over the memory rate or operations over the fp32 rate,
      from this run's count of fires);
  (b-oq) the same for the OQPSK kernel at the OQPSK config (80 ksym/s
      interleaved, block_len 8192), with (S+1)-row outputs: the pre-fire must
      run on some stream (a symbol split across the block boundary), and
      the first such stream is checked against the oracle too;
  (b-lanes), (b-lanes-oq) each kernel vs its plain version, bitwise in every
      output and carry leaf, at the other lane counts the main paths launch
      it with: 1 ((d), every sequential tail), 32 (the spans of (i)) and 105
      ((h): no multiple of 4), on a block entered mid-stream;
  (b-hifi) the QPSK kernel at the bench's hi-fi config (rrc_order 64,
      interp 10, block_len 8192): (b)'s comparison at it, 128 streams x 2
      blocks, every output and carry leaf bitwise, streams 0-1 against the
      oracle; then at pll_bw 0.5 and 2.0 (the bench's hifi_pllbw) a block
      entered mid-stream at 128 streams, bitwise;
  (c) the QPSK fleet width: 128 streams x 16 chained blocks through
      make_batch_demod on the card: no flags, symbol counts within 1 % of
      nominal, Msamples/s;
  (d) the QPSK CLI: a 30 s, 16-bit, 230.4 ksps QPSK WAV (300 Hz carrier,
      20 dB) through `cli.main([... "-B", "-q", "-o", out, wav])` on the card:
      exit 0, at least one kernel launch per block, 72000*30 symbols within
      1 %, carrier locked, mean |soft byte| in 55-75; the C++ I/O library of
      io/native.py built (the smoke fails without it), and the same run on
      the numpy decode and quantizer byte-identical;
  (c-oq), (d-oq) the same for OQPSK (`-m oqpsk -r 80k`; 80000*30 symbols,
      mean |soft byte| in 60-79: the JAX CLI on the CPU reads 69.55 on the
      first 6 s of the same WAV);
  (e), (e-oq) the fleet driver at full width: FleetDemodulator(cfg, 128,
      chain_blocks=16, ingest="i16", packed_output=True) on the card (its
      default device) over (c)'s kind of fixture rounded to int16, 3 chains:
      int8 outputs bitwise equal to make_batch_demod block by block on the
      decoded float input plus the host quantizer, no flags, no recovered
      stream, telemetry `symbols` equal to the sum of `valid`, 48 kernel
      launches (one per block); Msamples/s, and the host's share of a chain
      (wall time less the torch.profiler sum of device time);
  (f), (f-oq) the fleet checkpoint: saved after chain 2 of (e), loaded, and
      chain 3 runs on the loaded fleet: outputs and every carry leaf
      bitwise equal to the uninterrupted run's;
  (g) the serving host: `python -m meteor_demod_tpu_torch.serve_fleet --synth
      256 --dead 2 --group-size 128 --chain 16` on 6 s of signal as a
      subprocess on the card, once straight through and once stopped with
      --max-blocks and resumed with --resume: exit 0, 256 .s files,
      byte-identical between the two, every live stream's symbol count
      between the nominal count after the latest lock its carrier allows
      and the nominal count of the whole run (1 % either way), no stream
      span recovered by the host oracle; Msamples/s.
  (h), (h-oq) turbo on a file: 120 s of signal (16-bit WAV, (d)'s piece
      tiled: 27,648,000 samples, 3375 blocks) through `cli.main([... "-B",
      "-q", "-T", "0", ...])` on the card (105 lanes x 32 blocks and a
      15-block sequential tail) and beside it through `-B` alone: exit 0, the
      mode's kernel launched at least kb_w + 2*kb times by the -T run, the
      two .s files equal in length with mean |byte difference| < 2, the
      symbol count within 1 % of nominal, mean |soft byte| in the mode's
      band; and demod_array_turbo(..., strict=True) on the same samples:
      converged in at most 4 passes, no fallback (so no flagged lane), its
      symbols equal to demod_array's in count, locked_once and the sign of
      every component; the recording's 16-bit decode and the quantizer on
      demod_array's symbols through the native library and through numpy,
      3 times each in turns: bitwise equal, median times;
  (i), (i-oq) turbo on stdin: the same 120 s as raw 16-bit through a pipe
      into `python -m meteor_demod_tpu_torch -T 32 --stdout -s 230400 --bps
      16 -` (a subprocess): exit 0, output equal in length to (h)'s -B file
      with mean |byte difference| < 2; and in-process a
      StreamDemodulator(cfg, span_turbo=True, span_chunks=32) fed
      8192-sample pieces: at least 5 spans (a span is 32 x 16 x 8192
      samples, 18.2 s), soft-byte signs and locked_once equal to the
      sequential stream's.
  (j) several devices: the shards are every card when there are several
      (and they divide 128 and 104), else two shards over the cards there
      are, both on cuda:0 with one card, each then on a CUDA stream of its
      own (parallel/mesh.py Shards). On them: (e)'s QPSK fleet driver,
      FleetDemodulator(..., mesh=shards) on (e)'s int16 input, 3 chains:
      int8 outputs bitwise equal to (e)'s, carry and integer telemetry after
      chain 2 equal to (e)'s, mean_agc_gain within rtol 1e-6, Msamples/s
      beside (e)'s; demod_array_turbo(mesh=shards) on (h)'s 120 s recording
      at 104 lanes bitwise equal to one device's at 104 lanes (symbols,
      gauges, passes); the time-sharded FIR (parallel/timeshard.py) over 64
      blocks of it against one call, bitwise or else within the FIR budget
      (rtol 1e-5, atol 1e-5 max|F|) with the first differing tick printed; a
      2-process MultiHostFleet (this script run twice with --mh-worker,
      gloo over localhost, cuda:0 each, 64 streams a process x 2 blocks)
      whose rows are bitwise the single-process fleet's and whose telemetry
      is the same in both processes; and dryrun_multichip(4).
  (j-streams) the stream contract: the fleet step (make_fleet_demod, (e)'s
      shape, 2 chains of (e)'s input) and a StreamDemodulator (24 blocks
      and a tail of (h)'s recording, fed 8192 samples at a time) queued
      under a side stream while the default stream spins, each bitwise
      (outputs, carry, telemetry; soft bytes) to the same run on the
      default stream;
  (k) the soak (meteor_demod_tpu_torch/soak.py) at a quarter of its size:
      2**28 samples of span turbo (16 spans of 128 lanes x 16 blocks, each
      chained from the last one's exit carry: converged, every lane
      accepted, locked, a sane carry; the exit carry saved at the half-way
      span, restored, and the next span re-run bitwise), and 2**26 samples
      of sequential chained dispatch at B = 1 (0 flags, locked):
      Msamples/s of both legs, RSS at the start and the end;
  (l) `scaling --mode overhead` at 128 streams: FleetDemodulator's step
      against make_batch_demod on the same rows, ms a block;
  (m) the port's bench, `python -m meteor_demod_tpu_torch.bench` (every
      section of the root bench.py at its shapes, each gated on
      correctness), as a subprocess on the card: exit 0, its JSON line
      (printed on a line of its own) on "device" cuda and this card, no
      field null, turbo converged; each section's launch counts (from the
      line: the bench is a process of its own and sets both counts to 0
      just before each section) show its own kernel launched and the other
      not (OQPSK for oqpsk and turbo_oqpsk, QPSK for the rest, none for
      the FIR section), and their sums go into the kernels' record.
Each main path, QPSK ((c), (d), (e), (f), (h), (i), (j), (j-streams), (k),
(l)) and OQPSK (the same with -oq, no (j), (j-streams), (k), (l)), is
driven with both kernels' launch counts and the counts of blocks replayed by
the numpy oracle on the host set to 0 just before it and read just after:
the path's own kernel must have launched, the other kernel not at all, and
the replay counts must be 0, so that every block came from the card. (The
serving host of (g) is a process of its own: its launches are not in these
counts; the bench of (m) is one too, and reports its own section by
section, each from 0.) Each
phase's line is followed by its time. The line before the
last is the kernels' JSON record, the last line is {"ok": true, ...}.

Imports nothing of JAX or of the JAX package. Exits 1 without a CUDA card.
Needs one card; with more, (j) spans them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FS = 230400
SEED = 2024
N_FLEET = 128
CHAIN = 16
CLI_SECONDS = 30
PIECE_S = 3          # the CLI fixture is a PIECE_S-second sim piece, tiled
FLEET_CHAINS = 3     # (e): chains of CHAIN blocks through the fleet driver
TURBO_SECONDS = 120  # (h), (i): the turbo recording, (d)'s piece tiled
SPAN_LANES = 32      # (i): -T 32 on stdin
MESH_LANES = 104     # (j): turbo's lanes over the shards (a multiple of 8)
FIR_BLOCKS = 64      # (j): the time-sharded FIR's length in blocks
MH_BLOCKS = 2        # (j): blocks through the 2-process MultiHostFleet
# (g): the serving host's fleet. 6 s of signal, not the 10 s of a short pass:
# synthesizing 254 passes on the host costs ~10 s per second of signal, three
# times over, and is set-up, not serving.
SERVE_ARGS = ["--synth", "256", "--dead", "2", "--seconds", "6",
              "--group-size", "128", "--chain", "16", "--status-every", "4"]
SERVE_KILL_AT = 5    # chains served before the stopped run ends
SWEEP_HZ_PER_S = 825.0   # the acquisition sweep's rate at 72 ksym/s
# (k): the soak's span leg (16 spans of 128 lanes x 16 blocks) and its
# sequential leg (512 dispatches of 16 blocks), a quarter of the full soak's.
SOAK_SPAN_SAMPLES = 1 << 28
SOAK_SEQ_SAMPLES = 1 << 26
OVERHEAD_STREAMS = 128   # (l): the fleet width of `scaling --mode overhead`
OVERHEAD_STEPS = 16
IO_ROUNDS = 3            # (h): decode and quantize timings, each path
# (m): the bench's limit; it took 126 s whole on an NVIDIA H100 80GB HBM3
# at 700 W.
BENCH_TIMEOUT_S = 600
# (b-hifi): the loop bandwidths of the bench's hifi_pllbw section.
HIFI_PLL_BW = (0.5, 2.0)
# (m): which kernel each bench section launches; the FIR section runs none.
OQPSK_SECTIONS = ("oqpsk", "turbo_oqpsk")
NO_KERNEL_SECTIONS = ("fir",)
# The card's published peaks (H100 SXM data sheet) for the kernels' bound.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations of one fire (AGC, mix, M&M, Costas and gate, counted from
# csrc/block_demod.cu; an OQPSK fire carries half a symbol's loop update).
OPS_PER_FIRE = 80
KERNEL_SOURCE = "meteor_demod_tpu_torch/csrc/block_demod.cu"
# Per mode: the kernel's name, the TPU kernel it replaces, the symbol rate,
# the CLI's mode flags and the band of mean |soft byte| the CLI must give.
MODES = {
    "qpsk": dict(name="block_demod", symrate=72000.0, cli=[],
                 replaces="meteor_demod_tpu/kernels/block_demod.py:1382",
                 soft=(55.0, 75.0)),
    "oqpsk": dict(name="block_demod_oqpsk", symrate=80000.0,
                  cli=["-m", "oqpsk", "-r", "80k"],
                  replaces="meteor_demod_tpu/kernels/block_demod.py:427",
                  soft=(60.0, 79.0)),
}


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(tag: str, phase, *args):
    """phase(*args), followed by a line with its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    say(f"({tag}) took {time.perf_counter() - t0:.1f} s")
    return out


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def numpy_io():
    """Within it, decode_iq and quantize_symbols take their numpy paths (the
    C++ library of io/native.py is left unused)."""
    from meteor_demod_tpu_torch.io import native
    saved = native.decode_iq_f32, native.quantize_soft
    native.decode_iq_f32 = lambda raw, bps: None
    native.quantize_soft = lambda re, im: None
    try:
        yield
    finally:
        native.decode_iq_f32, native.quantize_soft = saved


def fleet_iq(cfg, n_streams: int, n_samples: int, seed: int,
             device) -> torch.Tensor:
    """(n_streams, n_samples, 2) float32 IQ on `device`: sim (O)QPSK baseband
    at cfg's symbol rate (4 seeded symbol sequences) given per-stream
    carriers +50..+600 Hz, phases, amplitudes, SNR 12-25 dB and DC offsets
    on the card; the last stream is noise only."""
    from meteor_demod_tpu_torch.sim import synth_psk
    bases = [synth_psk(int(n_samples * cfg.symrate / FS) + 64, FS,
                       symrate=cfg.symrate, oqpsk=cfg.oqpsk, carrier_hz=0.0,
                       amplitude=1.0, snr_db=300.0, seed=seed + k)[0][:n_samples]
             for k in range(4)]
    base = torch.tensor(np.stack(bases), device=device,
                        dtype=torch.complex128)
    rng = np.random.default_rng(seed)
    carrier = np.linspace(50.0, 600.0, n_streams)
    phase0 = rng.uniform(0, 2 * np.pi, n_streams)
    amp = rng.uniform(2000.0, 8000.0, n_streams)
    amp[-1] = 0.0
    snr_db = rng.uniform(12.0, 25.0, n_streams)
    dc = rng.uniform(-40, 40, n_streams) + 1j * rng.uniform(-40, 40, n_streams)
    p_base = float(torch.mean(torch.abs(base) ** 2))
    sigma = np.sqrt(8000.0 ** 2 * p_base / 10 ** (snr_db / 10) / 2)
    n = torch.arange(n_samples, device=device, dtype=torch.float64)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((n_streams, n_samples, 2), device=device)
    for b in range(n_streams):
        rot = torch.exp(1j * (2 * np.pi * carrier[b] / FS * n + phase0[b]))
        z = base[b % 4] * rot * amp[b] + dc[b]
        noise = torch.randn((n_samples, 2), generator=gen, device=device,
                            dtype=torch.float64) * sigma[b]
        out[b] = (torch.stack([z.real, z.imag], dim=-1) + noise).float()
    return out


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def leaves(carry) -> dict:
    from meteor_demod_tpu_torch.demod.state import carry_to_numpy
    return carry_to_numpy(carry)


def outputs(out) -> dict:
    return {k: getattr(out, k).cpu().numpy()
            for k in ("sym_re", "sym_im", "valid", "locked_once")}


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
               for k in a)


def same_bitwise(what: str, kc, ko, pc, po) -> tuple[dict, dict, float]:
    """Hold the kernel's outputs and carry (ko, kc) bitwise against the plain
    version's (po, pc): the kernel's outputs and carry leaves as numpy, and
    the largest difference (0.0 when this returns)."""
    torch.cuda.synchronize()
    a, b = outputs(ko), outputs(po)
    ka, pa = leaves(kc), leaves(pc)
    for k in a:
        check(np.array_equal(a[k], b[k]), f"{what}: kernel {k} differs from "
              f"plain, max {np.abs(a[k] - b[k]).max()}")
    for k in ka:
        check(np.array_equal(ka[k], pa[k]),
              f"{what}: kernel carry {k} differs from plain")
    return a, ka, max_abs_diff(a, b)


def phase_b(cfg, dev, tag: str) -> dict:
    from meteor_demod_tpu_torch.demod import scalar
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import (f32_to_iq, make_fir_banks,
                                                polyphase_fir_block)
    from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                            block_demod_torch)
    L = cfg.block_len
    x = fleet_iq(cfg, N_FLEET, 2 * L, SEED, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    kc = pc = batch_carry(cfg, N_FLEET, dev)
    tail = kc.fir_tail
    err = 0.0
    fts, outs, split = [], [], None
    for i in range(2):
        Ft, tail = polyphase_fir_block(x[:, i * L:(i + 1) * L], tail, banks)
        fts.append(Ft)
        slot_in = kc.slot.cpu().numpy()
        kc, ko = block_demod(cfg, kc, Ft)
        plain = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        plain[0].record()
        pc, po = block_demod_torch(cfg, pc, Ft)
        plain[1].record()
        a, ka, block_err = same_bitwise(f"({tag}) block {i}", kc, ko, pc, po)
        err = max(err, block_err)
        nominal = L * cfg.symrate / FS
        check(int(a["valid"].sum()) > N_FLEET * 0.95 * nominal,
              f"({tag}) too few symbols")
        if cfg.oqpsk and i == 1:
            # The pre-fire: row 0 holds a symbol exactly where a symbol was
            # split across the block boundary (entry slot 2).
            check((slot_in == 2).any(), f"({tag}) no stream entered block 1 "
                  f"with a split symbol: the pre-fire never ran")
            check(np.array_equal(a["valid"][:, 0], (slot_in == 2)),
                  f"({tag}) pre-fire rows differ from the split streams")
            split = int(np.argmax(slot_in == 2))
        outs.append(a)
        if i == 0:
            plain_ms = plain[0].elapsed_time(plain[1])
            # Fires of block 0, the block the times below are taken on: one
            # per QPSK symbol; two per OQPSK symbol plus the I half-fire of
            # a symbol split at the block's end (no pre-fire: block 0 is
            # entered with no split symbol).
            fires = int(a["valid"].sum()) * (2 if cfg.oqpsk else 1) + (
                int((ka["slot"] == 2).sum()) if cfg.oqpsk else 0)
    # Streams 0-1 (and OQPSK's first split stream), both blocks, against the
    # numpy oracle on the same Ft.
    xn = x.cpu().numpy()
    oracle_err = 0.0
    for b in sorted({0, 1} | ({split} if split is not None else set())):
        st = scalar.initial_state(cfg)
        for i in range(2):
            a = outs[i]
            F = f32_to_iq(np.ascontiguousarray(
                fts[i][:, :, b].cpu().numpy())).reshape(L, cfg.interp)
            syms, st = scalar.demod_stream_np(
                cfg, f32_to_iq(np.ascontiguousarray(xn[b, i * L:(i + 1) * L])),
                st, F=F)
            m = a["valid"][b].astype(bool)
            check(len(syms) == m.sum(), f"({tag}) oracle count {len(syms)} "
                  f"!= kernel {m.sum()} (stream {b}, block {i})")
            check(np.array_equal(syms["locked_once"], a["locked_once"][b][m]),
                  f"({tag}) oracle locked_once differs (stream {b})")
            for k, ok in (("re", "sym_re"), ("im", "sym_im")):
                np.testing.assert_allclose(a[ok][b][m], syms[k], rtol=5e-4,
                                           atol=1e-3)
                oracle_err = max(oracle_err, float(np.max(np.abs(
                    a[ok][b][m].astype(np.float64) - syms[k]))))
    # The kernel's times per block, from block 0's entry carry and FIR
    # output: what the plain version's time above was taken on.
    c0 = batch_carry(cfg, N_FLEET, dev)
    c1 = batch_carry(cfg, 1, dev)
    ft1 = fts[0][:, :, :1].contiguous()
    t = dict(
        ms=cuda_ms(lambda: block_demod(cfg, c0, fts[0]), 20),
        plain_ms=plain_ms,
        ms_b1=cuda_ms(lambda: block_demod(cfg, c1, ft1), 20))
    # The least time the card could take for block 0 at B = 128: the bytes
    # the function must move (each fired tick's two floats, the four output
    # arrays and the carry in and out, once each) over the memory rate, or
    # its float operations over the fp32 rate, whichever is larger.
    rows = outs[0]["valid"].shape[1]
    n_bytes = 8 * fires + 4 * 4 * rows * N_FLEET + 2 * 4 * 16 * N_FLEET
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_FIRE * fires / FP32_OPS_PER_S * 1e3
    t.update(bound_ms=max(by_bytes, by_ops),
             bound_by="bytes" if by_bytes >= by_ops else "operations")
    streams = "0-1" if split is None or split < 2 else f"0-1 and {split}"
    say(f"({tag}) kernel == plain bitwise over {N_FLEET} streams x 2 blocks "
        f"(max_abs_err {err}); oracle streams {streams}: decisions bitwise, "
        f"max |value diff| {oracle_err}; per block: kernel "
        f"{t['ms']:.3f} ms vs plain {t['plain_ms']:.1f} ms at B=128, kernel "
        f"{t['ms_b1']:.3f} ms at B=1; "
        f"bound at B=128 {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
        f"({fires} fires, {n_bytes} bytes)")
    return dict(max_abs_err=err, **t)


def mid_stream_case(cfg, x, banks, dev, what: str):
    """Block 0 of x (B, 2 L, 2) through the kernel alone gives a mid-stream
    entry carry (a filled FIR tail; for OQPSK, streams with a split
    symbol), block 1 through the kernel and its plain version, every output
    and carry leaf bitwise, and at least 95 % of the nominal symbols.
    Returns (the entry carry, the symbols, the largest difference, the
    plain version's seconds)."""
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import polyphase_fir_block
    from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                            block_demod_torch)
    L, B = cfg.block_len, x.shape[0]
    entry = batch_carry(cfg, B, dev)
    Ft, tail = polyphase_fir_block(x[:, :L], entry.fir_tail, banks)
    entry, _ = block_demod(cfg, entry, Ft)
    Ft, _ = polyphase_fir_block(x[:, L:], tail, banks)
    kc, ko = block_demod(cfg, entry, Ft)
    t0 = time.perf_counter()
    pc, po = block_demod_torch(cfg, entry, Ft)
    a, _, err = same_bitwise(what, kc, ko, pc, po)
    plain_s = time.perf_counter() - t0
    nominal = L * cfg.symrate / FS
    symbols = int(a["valid"].sum())
    check(symbols > B * 0.95 * nominal, f"{what}: too few symbols")
    return entry, symbols, err, plain_s


def phase_b_lanes(cfg, dev, tag: str) -> float:
    """The kernel against its plain version at the other lane counts the main
    paths launch it with: 1 (the CLI's -B, every sequential tail), SPAN_LANES
    (the spans of (i)) and the -T 0 lane count of (h), which is no multiple
    of 4 and so takes the 4-byte cp.async path with a ragged last warp. Per
    count, a block entered mid-stream (mid_stream_case). Returns the largest
    difference."""
    from meteor_demod_tpu_torch import cli
    from meteor_demod_tpu_torch.dsp.fir import make_fir_banks
    L = cfg.block_len
    counts = (1, SPAN_LANES, cli.turbo_lanes(TURBO_SECONDS * FS, L))
    check(counts[2] % 4 != 0 and counts[2] < N_FLEET,
          f"({tag}) -T 0 gives {counts[2]} lanes")
    x = fleet_iq(cfg, N_FLEET, 2 * L, SEED + 2, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    err, notes = 0.0, []
    for B in counts:
        entry, symbols, block_err, plain_s = mid_stream_case(
            cfg, x[:B].contiguous(), banks, dev, f"({tag}) B={B}")
        err = max(err, block_err)
        split = int((entry.slot == 2).sum()) if cfg.oqpsk else 0
        check(not cfg.oqpsk or B == 1 or split > 0,
              f"({tag}) B={B}: no stream entered with a split symbol")
        notes.append(f"B={B} ({symbols} symbols"
                     + (f", {split} pre-fires" if cfg.oqpsk else "")
                     + f", plain {plain_s:.1f} s)")
    say(f"({tag}) kernel == plain bitwise, outputs and carry, on a block "
        f"entered mid-stream at the other lane counts of the main paths: "
        f"{'; '.join(notes)} (max_abs_err {err})")
    return err


def phase_b_hifi(cfg, dev, tag: str) -> float:
    """The QPSK kernel at the config of the bench's hifi and hifi_pllbw
    sections (rrc_order 64, interp 10: 129 taps, 10 ticks a sample): (b)
    at it (128 streams x 2 blocks, every output and carry leaf bitwise, the
    oracle on streams 0-1), then at each of HIFI_PLL_BW's loop bandwidths a
    block entered mid-stream at 128 streams (mid_stream_case). Returns the
    largest difference."""
    from meteor_demod_tpu_torch.dsp.fir import make_fir_banks
    err = phase_b(cfg, dev, tag)["max_abs_err"]
    notes = []
    for bw in HIFI_PLL_BW:
        c = dataclasses.replace(cfg, pll_bw=bw)
        x = fleet_iq(c, N_FLEET, 2 * c.block_len, SEED + 3, dev)
        banks = torch.as_tensor(make_fir_banks(c), device=dev)
        _, symbols, block_err, plain_s = mid_stream_case(
            c, x, banks, dev, f"({tag}) pll_bw={bw}")
        err = max(err, block_err)
        notes.append(f"pll_bw {bw} ({symbols} symbols, plain {plain_s:.1f} s)")
    say(f"({tag}) kernel == plain bitwise, outputs and carry, on a block "
        f"entered mid-stream at {N_FLEET} streams: {'; '.join(notes)} "
        f"(max_abs_err {err})")
    return err


def phase_c(cfg, dev, card: str, tag: str) -> None:
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.state import batch_carry
    L = cfg.block_len
    x = fleet_iq(cfg, N_FLEET, CHAIN * L, SEED + 1, dev)
    fn = make_batch_demod(cfg, N_FLEET, device=dev)
    fn(batch_carry(cfg, N_FLEET, dev), x[:, :L])          # warm-up
    torch.cuda.synchronize()
    carry = batch_carry(cfg, N_FLEET, dev)
    counts = torch.zeros(N_FLEET, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(CHAIN):
        carry, out = fn(carry, x[:, i * L:(i + 1) * L])
        counts += out.valid.sum(dim=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    flags = carry.flags.cpu().numpy()
    counts = counts.cpu().numpy()
    nominal = CHAIN * L * cfg.symrate / FS
    check(not flags.any(),
          f"({tag}) flags set on streams {np.nonzero(flags)[0]}")
    check(np.all(np.abs(counts - nominal) <= 0.01 * nominal),
          f"({tag}) symbol counts {counts.min()}..{counts.max()} not within 1 % "
          f"of {nominal:.0f}")
    locked = int(carry.locked.sum())
    msps = N_FLEET * CHAIN * L / secs / 1e6
    say(f"({tag}) fleet {N_FLEET} x {CHAIN} blocks ({N_FLEET * CHAIN * L / 1e6:.1f}"
        f" Msamples): flags 0, symbols/stream {counts.min()}..{counts.max()} "
        f"(nominal {nominal:.0f}), {locked}/{N_FLEET} locked, {secs:.3f} s, "
        f"{msps:.1f} Msamples/s on {card}")


def tiled_signal(cfg, seconds: int) -> np.ndarray:
    """`seconds` of simulated signal (300 Hz carrier, 20 dB): a PIECE_S-second
    piece tiled. 3 s holds whole symbols, whole samples and 900 whole
    carrier cycles, so the carrier and the symbol clock run on across the
    joins (a pass is ~10 minutes; the smoke stays short)."""
    from meteor_demod_tpu_torch.sim import synth_psk
    x, _ = synth_psk(int(cfg.symrate) * PIECE_S, FS, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=300.0, amplitude=6000.0,
                     snr_db=20.0, seed=SEED)
    return np.tile(x, seconds // PIECE_S)


def phase_d(cfg, dev, card: str, tag: str) -> None:
    from meteor_demod_tpu_torch import cli
    from meteor_demod_tpu_torch.constants import RING_SYMBOLS
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.sim import write_wav
    from meteor_demod_tpu_torch.io import native
    mode = MODES["oqpsk" if cfg.oqpsk else "qpsk"]
    x = tiled_signal(cfg, CLI_SECONDS)
    check(native.available(), f"({tag}) the C++ I/O library of io/native.py "
          f"is not built (no C++ compiler?)")
    with tempfile.TemporaryDirectory() as tmp:
        wav, out = os.path.join(tmp, "pass.wav"), os.path.join(tmp, "pass.s")
        write_wav(wav, x, FS, 16)
        blocks = len(x) // cfg.block_len
        before = kernel(mode).launches
        os.environ.pop("METEOR_DEMOD_PLATFORM", None)        # the card
        t0 = time.perf_counter()
        rc = cli.main(["meteor_demod_tpu_torch", "-B", "-q", *mode["cli"],
                       "-o", out, wav])
        secs = time.perf_counter() - t0
        soft = np.fromfile(out, dtype=np.int8)
        launched = kernel(mode).launches - before
        # The same run on the numpy decode and quantizer: the same bytes.
        np_out = os.path.join(tmp, "numpy.s")
        with numpy_io():
            t0 = time.perf_counter()
            np_rc = cli.main(["meteor_demod_tpu_torch", "-B", "-q",
                              *mode["cli"], "-o", np_out, wav])
            np_secs = time.perf_counter() - t0
        check(np_rc == 0 and filecmp.cmp(out, np_out, shallow=False),
              f"({tag}) the CLI's .s on the numpy I/O path (exit {np_rc}) "
              f"differs from the native path's")
    check(rc == 0, f"({tag}) CLI exit {rc}")
    check(launched >= blocks, f"({tag}) {launched} kernel launches for "
          f"{blocks} blocks")
    replayed = StreamDemodulator.replayed_blocks
    check(replayed == 0, f"({tag}) {replayed} flagged blocks were recomputed "
          f"by the numpy oracle on the host")
    n_sym = len(soft) // 2
    nominal = int(cfg.symrate) * CLI_SECONDS
    check(abs(n_sym - nominal) <= 0.01 * nominal,
          f"({tag}) {n_sym} symbols, expected {nominal} within 1 %")
    check(len(soft) >= 4 * RING_SYMBOLS, f"({tag}) carrier never locked")
    mean_soft = float(np.mean(np.abs(soft.astype(np.float32))))
    lo, hi = mode["soft"]
    check(lo <= mean_soft <= hi, f"({tag}) mean |soft byte| {mean_soft}")
    say(f"({tag}) CLI -B {' '.join(mode['cli'])} on {CLI_SECONDS} s of 16-bit "
        f"230.4 ksps {'OQPSK' if cfg.oqpsk else 'QPSK'}: exit 0, {n_sym} "
        f"symbols (nominal {nominal}), locked, mean |soft| {mean_soft:.1f}, "
        f"{launched} kernel launches for {blocks} blocks, {replayed} blocks "
        f"replayed on the host, {secs:.2f} s wall with the native I/O "
        f"library ({native.library_path().name}), {np_secs:.2f} s on the "
        f"numpy path, the two .s files byte-identical, on {card}")


def device_busy_ms(fn) -> tuple[float, float]:
    """Run fn once under torch.profiler: (wall ms, summed device ms of its
    CUDA kernels and copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    check(busy > 0, "torch.profiler saw no device time")
    return wall_ms, busy


def phase_ef(cfg, dev, card: str, tag: str) -> None:
    """(e) the fleet driver at full width against make_batch_demod plus the
    host quantizer; (f) its checkpoint, saved after chain 2 and resumed."""
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.pipeline import quantize
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.io.checkpoint import (load_fleet_checkpoint,
                                                      save_fleet_checkpoint)
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    mode = MODES["oqpsk" if cfg.oqpsk else "qpsk"]
    L, span = cfg.block_len, CHAIN * cfg.block_len
    n_blocks = FLEET_CHAINS * CHAIN
    raw = fleet_iq(cfg, N_FLEET, n_blocks * L, SEED + 1, dev).round().clamp(
        -32768, 32767).to(torch.int16)
    # The reference: the batch demodulator block by block on the decoded
    # floats, quantized on the host (not counted among the path's launches).
    fn = make_batch_demod(cfg, N_FLEET, dev)
    carry = batch_carry(cfg, N_FLEET, dev)
    ref = []
    for i in range(n_blocks):
        carry, o = fn(carry, raw[:, i * L:(i + 1) * L].float())
        ref.append(dict(
            sym_i=quantize(o.sym_re.cpu().numpy()).astype(np.int8),
            sym_q=quantize(o.sym_im.cpu().numpy()).astype(np.int8),
            valid=o.valid.cpu().numpy().astype(np.int8),
            locked_once=o.locked_once.cpu().numpy().astype(np.int8)))
    ref_carry = leaves(carry)
    raw = raw.cpu().numpy()
    kernel(mode).launches = 0

    kw = dict(chain_blocks=CHAIN, ingest="i16", packed_output=True)
    fleet = FleetDemodulator(cfg, N_FLEET, **kw)       # device: the default
    check(fleet.device.type == "cuda", f"({tag}) the fleet is on {fleet.device}")
    outs, walls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "fleet.ckpt")
        for c in range(FLEET_CHAINS):
            t0 = time.perf_counter()
            got = fleet.process_blocks(raw[:, c * span:(c + 1) * span])
            walls.append(time.perf_counter() - t0)
            outs.append(got)
            for k in ("sym_i", "sym_q", "valid", "locked_once"):
                want = np.concatenate(
                    [r[k] for r in ref[c * CHAIN:(c + 1) * CHAIN]], axis=1)
                a = getattr(got, k)
                check(a.dtype == np.int8 and np.array_equal(a, want),
                      f"({tag}) chain {c}: fleet {k} differs from "
                      f"make_batch_demod + host quantizer")
            check(not fleet.stream_flags.any(), f"({tag}) chain {c}: flags "
                  f"on streams {fleet.flagged_streams()}")
            check(int(fleet.telemetry["symbols"]) == int(got.valid.sum()),
                  f"({tag}) chain {c}: telemetry symbols "
                  f"{fleet.telemetry['symbols']} != {got.valid.sum()}")
            if c == 1:
                save_fleet_checkpoint(ckpt, fleet)
                after_two = (leaves(fleet.carry), dict(fleet.telemetry))
        launched = kernel(mode).launches
        check(launched == n_blocks, f"({tag}) {launched} kernel launches for "
              f"{n_blocks} blocks")
        check(fleet.recovered_streams == 0,
              f"({tag}) {fleet.recovered_streams} streams recovered on the host")
        final = leaves(fleet.carry)
        for k in final:
            check(np.array_equal(final[k], ref_carry[k]),
                  f"({tag}) fleet carry {k} differs from make_batch_demod's")
        # The first chain carries the card's warm-up; rate over the rest.
        wall = float(np.mean(walls[1:]))
        msps = N_FLEET * span / wall / 1e6
        locked = int(fleet.telemetry["locked_streams"])
        if not cfg.oqpsk:
            MESHED.update(raw=raw, outs=outs, after_two=after_two, msps=msps)

        # ---- (f): resume from the checkpoint taken after chain 2 ----------
        ftag = tag.replace("e", "f", 1)
        resumed = load_fleet_checkpoint(ckpt)
        check(resumed.device.type == "cuda" and resumed._block_idx == 2,
              f"({ftag}) resumed on {resumed.device} at chain "
              f"{resumed._block_idx}")
    for c in range(2, FLEET_CHAINS):
        got = resumed.process_blocks(raw[:, c * span:(c + 1) * span])
        for k in ("sym_i", "sym_q", "valid", "locked_once"):
            check(np.array_equal(getattr(got, k), getattr(outs[c], k)),
                  f"({ftag}) chain {c}: resumed {k} differs")
    after = leaves(resumed.carry)
    for k in final:
        check(np.array_equal(after[k], final[k]),
              f"({ftag}) resumed carry {k} differs from the uninterrupted")
    check(resumed.telemetry == fleet.telemetry and
          resumed.recovered_streams == 0, f"({ftag}) resumed telemetry differs")
    # The host's share of a chain: one more chain (the last one's input
    # again, on the resumed fleet, its output unused) under the profiler.
    prof_wall, busy = device_busy_ms(lambda: resumed.process_blocks(
        raw[:, (FLEET_CHAINS - 1) * span:]))
    say(f"({tag}) fleet driver {N_FLEET} x {CHAIN} blocks x {FLEET_CHAINS} "
        f"chains (i16 in, int8 out): == make_batch_demod + host quantizer "
        f"bitwise, flags 0, 0 streams recovered, {locked}/{N_FLEET} locked, "
        f"{launched} launches for {n_blocks} blocks; {wall * 1e3:.2f} ms per "
        f"chain (first {walls[0] * 1e3:.1f}), {msps:.1f} Msamples/s; device "
        f"busy {busy:.2f} ms of a chain, host {wall * 1e3 - busy:.2f} ms "
        f"(profiled chain: {prof_wall:.2f} ms wall) on {card}")
    say(f"({ftag}) fleet checkpoint after chain 2, loaded, chain 3: "
        f"outputs and all {len(final)} carry leaves bitwise equal to the "
        f"uninterrupted run on {card}")


# What (h) leaves for (i), per mode: the recording's files and (h)'s results.
TURBO = {}
# What (e) and (h) leave for (j), QPSK only: (e)'s int16 input, its outputs,
# carry and telemetry after chain 2 and its rate; (h)'s recording.
MESHED = {}


def byte_diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(np.int16) - b.astype(np.int16))))


def same_decisions(got, ref, tag: str, view=lambda v: v) -> None:
    check(len(got) == len(ref), f"({tag}) {len(got)} symbols, the sequential "
          f"stream {len(ref)}")
    check(np.array_equal(got["locked_once"], ref["locked_once"]),
          f"({tag}) locked_once differs from the sequential stream's")
    for k in ("re", "im"):
        bad = np.nonzero(np.sign(view(got[k])) != np.sign(view(ref[k])))[0]
        check(len(bad) == 0, f"({tag}) {len(bad)} signs of {k} differ from the "
              f"sequential stream's, first at symbol {bad[:1]}")


def io_paths(payload: bytes, symbols: np.ndarray, tag: str) -> str:
    """The 16-bit decode of `payload` and the int8 quantizer on `symbols`,
    through io/native.py's C++ library and through numpy, IO_ROUNDS times
    each in turns: every output bitwise equal. Returns the median times."""
    from meteor_demod_tpu_torch.demod.pipeline import quantize_symbols
    from meteor_demod_tpu_torch.io.wav import decode_iq
    times = {"native": ([], []), "numpy": ([], [])}
    ref = None
    for r in range(IO_ROUNDS):
        for path in ("native", "numpy")[::1 if r % 2 == 0 else -1]:
            with numpy_io() if path == "numpy" else contextlib.nullcontext():
                t0 = time.perf_counter()
                x = decode_iq(payload, 16)
                t1 = time.perf_counter()
                q = quantize_symbols(symbols)
                t2 = time.perf_counter()
            times[path][0].append(t1 - t0)
            times[path][1].append(t2 - t1)
            if ref is None:
                ref = (x.view(np.int32), q)
            check(np.array_equal(x.view(np.int32), ref[0])
                  and np.array_equal(q, ref[1]),
                  f"({tag}) the {path} decode or quantizer differs")
    med = {p: [float(np.median(t)) * 1e3 for t in v] for p, v in times.items()}
    return (f"decode of {len(payload) >> 20} MiB native {med['native'][0]:.1f} "
            f"/ numpy {med['numpy'][0]:.1f} ms, quantize of {len(symbols)} "
            f"symbols native {med['native'][1]:.1f} / numpy "
            f"{med['numpy'][1]:.1f} ms (medians of {IO_ROUNDS}, outputs "
            f"bitwise equal)")


def phase_h(cfg, dev, card: str, tag: str) -> None:
    """Turbo on a file: CLI -T 0 beside CLI -B, and demod_array_turbo beside
    demod_array; see the module docstring."""
    from meteor_demod_tpu_torch import cli
    from meteor_demod_tpu_torch.demod.pipeline import demod_array
    from meteor_demod_tpu_torch.demod.turbo import (default_warmup_blocks,
                                                    demod_array_turbo)
    from meteor_demod_tpu_torch.io.wav import decode_iq
    from meteor_demod_tpu_torch.sim import encode_iq, write_wav
    mode = MODES["oqpsk" if cfg.oqpsk else "qpsk"]
    L = cfg.block_len
    tmp = tempfile.TemporaryDirectory()
    wav, raw = (os.path.join(tmp.name, n) for n in ("pass.wav", "pass.raw"))
    x = tiled_signal(cfg, TURBO_SECONDS)
    write_wav(wav, x, FS, 16)
    payload = encode_iq(x, 16)
    with open(raw, "wb") as f:
        f.write(payload)
    x = decode_iq(payload, 16)            # the samples both CLI runs decode
    blocks = len(x) // L
    # The CLI's -T 0 spreads its lanes over every card (mesh="auto"): one
    # card gives 105 lanes, several a multiple of their count, one shard each.
    n_dev = torch.cuda.device_count()
    lanes = cli.turbo_lanes(len(x), L, n_dev)
    shards = n_dev if n_dev > 1 and lanes % n_dev == 0 else 1
    kb = len(x) // (lanes * L)
    kb_w = default_warmup_blocks(L, kb)
    tail = blocks - lanes * kb
    check((len(x), blocks) == (27648000, 3375) and (
        n_dev > 1 or (lanes, kb, tail) == (105, 32, 15)),
          f"({tag}) geometry {(len(x), blocks, lanes, kb, tail)}")
    os.environ.pop("METEOR_DEMOD_PLATFORM", None)        # the card
    soft, secs = {}, {}
    for name, extra in (("turbo", ["-T", "0"]), ("batch", [])):
        out = os.path.join(tmp.name, name + ".s")
        before = kernel(mode).launches
        t0 = time.perf_counter()
        rc = cli.main(["meteor_demod_tpu_torch", "-B", "-q", *mode["cli"],
                       *extra, "-o", out, wav])
        secs[name] = time.perf_counter() - t0
        check(rc == 0, f"({tag}) CLI {' '.join(extra)} exit {rc}")
        soft[name] = np.fromfile(out, dtype=np.int8)
        if name == "turbo":
            launched = kernel(mode).launches - before
            check(shards * (kb_w + 2 * kb) <= launched
                  <= shards * (kb_w + 4 * kb) + tail,
                  f"({tag}) -T 0 launched the kernel {launched} times; "
                  f"{shards} x ({kb_w} + 2..4 x {kb}) + {tail} expected")
    check(len(soft["turbo"]) == len(soft["batch"]), f"({tag}) -T 0 wrote "
          f"{len(soft['turbo'])} bytes, -B {len(soft['batch'])}")
    diff = byte_diff(soft["turbo"], soft["batch"])
    check(diff < 2.0, f"({tag}) mean |byte difference| {diff} between -T 0 "
          f"and -B")
    n_sym = len(soft["turbo"]) // 2
    nominal = int(cfg.symrate) * TURBO_SECONDS
    check(abs(n_sym - nominal) <= 0.01 * nominal,
          f"({tag}) {n_sym} symbols, expected {nominal} within 1 %")
    mean_soft = float(np.mean(np.abs(soft["turbo"].astype(np.float32))))
    lo, hi = mode["soft"]
    check(lo <= mean_soft <= hi, f"({tag}) mean |soft byte| {mean_soft}")

    t0 = time.perf_counter()
    res = demod_array_turbo(cfg, x, chunks=lanes, strict=True)
    t_turbo = time.perf_counter() - t0
    check(res.converged and res.passes <= 4, f"({tag}) converged "
          f"{res.converged} after {res.passes} passes, residual "
          f"{res.max_residual}")
    # A flagged lane redoes the recording sequentially and sets fell_back.
    check(not res.fell_back and res.fallback_samples == 0,
          f"({tag}) fell back over {res.fallback_samples} samples")
    t0 = time.perf_counter()
    seq = demod_array(cfg, x)
    t_seq = time.perf_counter() - t0
    same_decisions(res.symbols, seq, tag)
    io_line = io_paths(payload, seq, tag)
    hist = np.bincount(res.gauges % 4, minlength=4).tolist()
    TURBO[tag.replace("h", "i", 1)] = dict(tmp=tmp, raw=raw, seq=seq, x=x,
                                           batch=soft["batch"])
    if not cfg.oqpsk:
        MESHED.update(x=x, turbo_s=t_turbo)
    say(f"({tag}) CLI -B -T 0 {' '.join(mode['cli'])} on {TURBO_SECONDS} s of "
        f"16-bit 230.4 ksps {'OQPSK' if cfg.oqpsk else 'QPSK'}: {lanes} lanes "
        f"x {kb} blocks (warm-up {kb_w}) + {tail}-block tail, {launched} "
        f"kernel launches, exit 0, {n_sym} symbols (nominal {nominal}), mean "
        f"|soft| {mean_soft:.1f}; .s equal in length to -B's, mean |byte "
        f"difference| {diff:.3f}; wall {secs['turbo']:.2f} s against "
        f"{secs['batch']:.2f} s for -B; demod_array_turbo strict: converged "
        f"in {res.passes} passes, no fallback, 0 flagged lanes, gauges mod 4 "
        f"{hist}, decisions == demod_array's on all {len(seq)} symbols, "
        f"{t_turbo:.2f} s against {t_seq:.2f} s; {io_line} on {card}")


def phase_i(cfg, dev, card: str, tag: str) -> None:
    """Turbo on stdin: the CLI's -T 32 as a subprocess fed through a pipe,
    and the span-mode stream in-process; see the module docstring."""
    from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                       quantize)
    mode = MODES["oqpsk" if cfg.oqpsk else "qpsk"]
    fix = TURBO.pop(tag)
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("METEOR_DEMOD_PLATFORM", None)                   # the card
    with open(fix["raw"], "rb") as f:
        payload = f.read()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu_torch", "-T",
         str(SPAN_LANES), "--stdout", "-s", str(FS), "--bps", "16",
         *mode["cli"], "-"], input=payload, env=env, cwd=root,
        capture_output=True, timeout=600)
    secs = time.perf_counter() - t0
    fix["tmp"].cleanup()
    check(proc.returncode == 0, f"({tag}) CLI -T {SPAN_LANES} on stdin exit "
          f"{proc.returncode}:\n{proc.stderr.decode()[-3000:]}")
    soft = np.frombuffer(proc.stdout, dtype=np.int8)
    check(len(soft) == len(fix["batch"]), f"({tag}) stdin -T wrote "
          f"{len(soft)} bytes, -B on the file {len(fix['batch'])}")
    diff = byte_diff(soft, fix["batch"])
    check(diff < 2.0, f"({tag}) mean |byte difference| {diff} between stdin "
          f"-T {SPAN_LANES} and -B")

    x = fix["x"]
    d = StreamDemodulator(cfg, span_turbo=True, span_chunks=SPAN_LANES)
    check(d.device.type == "cuda", f"({tag}) the stream is on {d.device}")
    verified, submit = [], d._submit_span

    def counting(span):
        pend = submit(span)
        verified.append(0 if pend is None else pend.P)
        return pend

    d._submit_span = counting
    before = kernel(mode).launches
    t0 = time.perf_counter()
    out = [d.process(x[at:at + 8192]) for at in range(0, len(x), 8192)]
    out.append(d.finish())
    t_span = time.perf_counter() - t0
    launched = kernel(mode).launches - before
    check(d.spans_run >= 5, f"({tag}) {d.spans_run} spans ran")
    same_decisions(np.concatenate(out), fix["seq"], tag, view=quantize)
    say(f"({tag}) CLI -T {SPAN_LANES} --stdout {' '.join(mode['cli'])} on "
        f"{TURBO_SECONDS} s of raw 16-bit through a pipe: exit 0, .s equal "
        f"in length to -B's, mean |byte difference| {diff:.3f}, {secs:.2f} s "
        f"wall (start-up included); StreamDemodulator span mode fed "
        f"8192-sample pieces: {d.spans_run} spans of {SPAN_LANES} lanes x 16 "
        f"blocks, verified lanes {verified}, {d.span_fallbacks} fallbacks, "
        f"{launched} kernel launches, soft-byte signs and locked_once == "
        f"the sequential stream's on all {len(fix['seq'])} symbols, "
        f"{t_span:.2f} s on {card}")


def phase_g(card: str) -> None:
    """The serving host as a subprocess on the card: straight through, and
    stopped and resumed; see the module docstring."""
    from meteor_demod_tpu_torch.constants import RING_SYMBOLS
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("METEOR_DEMOD_PLATFORM", None)                   # the card

    def host(out_dir, extra):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "meteor_demod_tpu_torch.serve_fleet",
             *SERVE_ARGS, "--out-dir", out_dir, *extra], env=env, cwd=root,
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"(g) serve_fleet {' '.join(extra)} exit "
              f"{proc.returncode}:\n{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
        check("on cuda" in proc.stdout, "(g) the host did not serve on the card")
        return proc.stdout, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        a_dir, b_dir = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        ck_a, ck_b = os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz")
        out_a, secs_a = host(a_dir, ["--checkpoint", ck_a])
        out_k, secs_k = host(b_dir, ["--checkpoint", ck_b,
                                     "--checkpoint-every", "3",
                                     "--max-blocks", str(SERVE_KILL_AT)])
        check(f"{SERVE_KILL_AT} chains served" in out_k,
              f"(g) the stopped run: {out_k[-300:]}")
        out_r, secs_r = host(b_dir, ["--checkpoint", ck_b, "--resume"])
        check(f"resumed at chain {SERVE_KILL_AT}" in out_r,
              f"(g) the resumed run: {out_r[-300:]}")
        m = re.search(r"(\d+) chains served, (\d+) soft bytes across 256 "
                      r"streams, (\d+) stream spans recovered by the host "
                      r"oracle, ([0-9.]+) Msamp/s over ([0-9.]+) s", out_a)
        check(m is not None, f"(g) no summary line: {out_a[-300:]}")
        chains, recovered = int(m.group(1)), int(m.group(3))
        check(recovered == 0 and "0 stream spans recovered" in out_r
              and "0 stream spans recovered" in out_k,
              f"(g) {recovered} stream spans recovered by the host oracle")
        names = sorted(os.listdir(a_dir))
        check(len(names) == 256 and names == sorted(os.listdir(b_dir)),
              f"(g) {len(names)} .s files")
        for name in names:
            check(filecmp.cmp(os.path.join(a_dir, name),
                              os.path.join(b_dir, name), shallow=False),
                  f"(g) {name} differs between the straight and the resumed run")
        sizes = [os.path.getsize(os.path.join(a_dir, n)) for n in names]
    # Symbol counts. The writer drops everything before a stream's first
    # lock. The sweep climbs from 0 Hz at SWEEP_HZ_PER_S, so a live stream
    # with carrier c >= 0 locks by c / SWEEP_HZ_PER_S + 1 s; streams whose
    # carrier the sweep reaches later than 2 s before the end, or only on
    # its way down, are not held to a lower bound.
    feed_s = 16 * 8192 / FS
    total_s = chains * feed_s
    checked, locked = 0, 0
    for i, size in enumerate(sizes[2:], start=2):
        n_sym = size // 2
        check(n_sym <= 1.01 * 72000 * total_s, f"(g) stream {i}: {n_sym} "
              f"symbols from {total_s:.2f} s")
        locked += n_sym >= RING_SYMBOLS
        carrier = -2400.0 + (317.0 * i) % 4800.0
        latest = carrier / SWEEP_HZ_PER_S + 1.0
        if 0 <= carrier and latest <= total_s - 2.0:
            checked += 1
            check(n_sym >= 0.99 * 72000 * (total_s - latest),
                  f"(g) stream {i} (carrier {carrier:+.0f} Hz): {n_sym} "
                  f"symbols, a lock by {latest:.2f} s gives "
                  f"{72000 * (total_s - latest):.0f}")
    check(checked >= 100, f"(g) only {checked} streams held to a lower bound")
    say(f"(g) serve_fleet {' '.join(SERVE_ARGS)}: exit 0 straight "
        f"({secs_a:.1f} s in all) and stopped at chain {SERVE_KILL_AT} "
        f"({secs_k:.1f} s) then resumed ({secs_r:.1f} s); 256 .s files "
        f"byte-identical between the two; {chains} chains of "
        f"{feed_s * 1e3:.0f} ms, {locked}/254 live streams locked, "
        f"{checked} early lockers within 1 % of their nominal count, dead "
        f"antennas wrote {sizes[0]} and {sizes[1]} bytes; 0 spans recovered; "
        f"serving rate {m.group(4)} Msamples/s over {m.group(5)} s "
        f"(synthesis and start-up excluded) on {card}")


def phase_m(card: str) -> dict:
    """The port's bench as a subprocess on the card (its log goes to this
    script's stderr); returns its kernels' launch counts summed over its
    sections, each section having launched its own kernel only."""
    from meteor_demod_tpu_torch.bench import SECTIONS
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("METEOR_DEMOD_PLATFORM", None)                   # the card
    proc = subprocess.run([sys.executable, "-m",
                           "meteor_demod_tpu_torch.bench"], env=env, cwd=root,
                          stdout=subprocess.PIPE, text=True,
                          timeout=BENCH_TIMEOUT_S)
    out = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and out, f"(m) the bench exit "
          f"{proc.returncode}, stdout {proc.stdout[-500:]!r}")
    line = json.loads(out[-1])
    say(out[-1])
    check("null" not in out[-1], "(m) a field of the line is null")
    check(line["device"] == "cuda" and line["card"] == card,
          f"(m) the bench ran on {line['device']} {line['card']}")
    check(line["turbo_converged"], "(m) turbo did not converge")
    per_section = line["kernel_launches"]
    check(set(per_section) == {"fleet", *SECTIONS},
          f"(m) launch counts of sections {sorted(per_section)}")
    launches = {MODES[m]["name"]: 0 for m in MODES}
    for section, counts in per_section.items():
        own = (None if section in NO_KERNEL_SECTIONS else
               MODES["oqpsk" if section in OQPSK_SECTIONS else "qpsk"]["name"])
        for name, n in counts.items():
            check(n > 0 if name == own else n == 0,
                  f"(m) section {section} launched {name} {n} times")
            launches[name] += n
    say(f"(m) bench: exit 0, headline {line['value']} Msamples/s at "
        f"{line['fleet_batch']} streams, {len(line)} fields, none null, "
        f"every section's own kernel only (none for "
        f"{', '.join(NO_KERNEL_SECTIONS)}), launches {launches} on {card}, "
        f"{line['power_limit_w']} W")
    return launches


def smoke_mesh() -> list:
    """(j)'s shards: every card when there are several and they divide the
    fleet's streams and MESH_LANES, else two shards over the cards there
    are (both on cuda:0 on a machine with one card)."""
    n = torch.cuda.device_count()
    if n > 1 and N_FLEET % n == 0 and MESH_LANES % n == 0:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", i % n) for i in range(2)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mh_worker(rank: int, port: int, tmp: str, device: str) -> int:
    """One process of (j)'s 2-process MultiHostFleet: joins the gloo job,
    runs its half of tmp/data.npy ((streams, blocks, block_len, 2) float32)
    block by block on `device` and writes its rows, the job's telemetry and
    its kernel launches to tmp/w<rank>.npz."""
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod
    from meteor_demod_tpu_torch.parallel.multihost import (MultiHostFleet,
                                                           init_distributed)
    init_distributed(f"tcp://localhost:{port}", world_size=2, rank=rank,
                     timeout_s=120)
    data = np.load(os.path.join(tmp, "data.npy"))
    n_streams, n_blocks, L = data.shape[:3]
    cfg = DemodConfig(samplerate=FS, block_len=L)
    fleet = MultiHostFleet(cfg, n_streams // 2, mesh=[device])
    check(fleet.n_streams == n_streams, f"worker {rank}: {fleet.n_streams} "
          f"streams in the job, {n_streams} in the data")
    sl = fleet.local_stream_slice()
    block_demod.launches = 0
    outs = [fleet.process_local_blocks(data[sl, b]) for b in range(n_blocks)]
    np.savez(os.path.join(tmp, f"w{rank}.npz"), start=sl.start, stop=sl.stop,
             launches=block_demod.launches,
             **{k: np.concatenate([getattr(o, k) for o in outs], axis=1)
                for k in ("sym_re", "sym_im", "valid", "locked_once")},
             **{f"tel_{k}": v for k, v in fleet.telemetry.items()})
    return 0


def phase_j(cfg, dev, card: str) -> None:
    """Several devices: the fleet driver, turbo and the time-sharded FIR
    over (j)'s shards, a 2-process MultiHostFleet and dryrun_multichip(4);
    see the module docstring."""
    from meteor_demod_tpu_torch.demod.turbo import demod_array_turbo
    from meteor_demod_tpu_torch.dryrun import dryrun_multichip
    from meteor_demod_tpu_torch.dsp.fir import (iq_to_f32, make_fir_banks,
                                                polyphase_fir_block)
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    from meteor_demod_tpu_torch.parallel.timeshard import make_sharded_fir
    from meteor_demod_tpu_torch.utils import (STAGE_BYTES, make_mesh,
                                              to_device, to_host)
    mesh = smoke_mesh()
    names = ", ".join(map(str, mesh))
    e, x = dict(MESHED), MESHED["x"]
    L, span = cfg.block_len, CHAIN * cfg.block_len

    # ---- the copies: more than two staging pieces to and from each card,
    # with another card (or none) current --------------------------------
    cards = make_mesh()
    a = np.random.default_rng(SEED).standard_normal(
        ((5 * STAGE_BYTES) // (4 * 2 * 1024) + 3, 1024, 2)).astype(np.float32)
    ups = []
    for i, card_dev in enumerate(cards):
        with torch.cuda.device(cards[(i + 1) % len(cards)]):
            ups.append(to_device(a, card_dev) * 1)
    for up, back in zip(ups, to_host(ups)):
        check(np.array_equal(back, a), f"(j) round trip through {up.device} "
              f"differs")
    del ups

    # ---- the fleet driver over the shards against (e) -----------------
    fleet = FleetDemodulator(cfg, N_FLEET, chain_blocks=CHAIN, ingest="i16",
                             packed_output=True, mesh=mesh)
    shared = fleet._shards.own_stream
    check(shared == [len(set(mesh)) < len(mesh)] * len(mesh),
          f"(j) shards with a stream of their own: {shared}")
    walls = []
    for c in range(3):
        t0 = time.perf_counter()
        got = fleet.process_blocks(e["raw"][:, c * span:(c + 1) * span])
        walls.append(time.perf_counter() - t0)
        for k in ("sym_i", "sym_q", "valid", "locked_once"):
            check(np.array_equal(getattr(got, k), getattr(e["outs"][c], k)),
                  f"(j) chain {c}: sharded fleet {k} differs from (e)'s")
        check(not fleet.stream_flags.any(), f"(j) chain {c}: flags on "
              f"streams {fleet.flagged_streams()}")
        if c == 1:
            carry, tel = leaves(fleet.carry), dict(fleet.telemetry)
            want_carry, want_tel = e["after_two"]
            for k in carry:
                check(np.array_equal(carry[k], want_carry[k]),
                      f"(j) carry {k} after chain 2 differs from (e)'s")
            for k in tel:
                check(tel[k] == want_tel[k] if k != "mean_agc_gain" else
                      np.isclose(tel[k], want_tel[k], rtol=1e-6, atol=0),
                      f"(j) telemetry {k} {tel[k]} != (e)'s {want_tel[k]}")
    check(fleet.recovered_streams == 0, "(j) streams recovered on the host")
    msps = N_FLEET * span / float(np.mean(walls[1:])) / 1e6

    # ---- turbo's lanes over the shards against one device -------------
    t0 = time.perf_counter()
    one = demod_array_turbo(cfg, x, chunks=MESH_LANES, strict=True,
                            device=mesh[0])
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = demod_array_turbo(cfg, x, chunks=MESH_LANES, strict=True, mesh=mesh)
    t_two = time.perf_counter() - t0
    check(one.converged and two.converged and not two.fell_back,
          f"(j) turbo converged {one.converged} / {two.converged}")
    check(two.passes == one.passes and np.array_equal(two.gauges, one.gauges),
          f"(j) turbo passes {two.passes} / {one.passes} or gauges differ")
    for k in ("re", "im", "locked_once"):
        check(np.array_equal(two.symbols[k], one.symbols[k]),
              f"(j) sharded turbo {k} differs from one device's")

    # ---- one stream's FIR split along time against one call ------------
    xt = iq_to_f32(np.ascontiguousarray(x[:FIR_BLOCKS * L]))
    parts = make_sharded_fir(cfg, mesh)(xt)
    got = torch.cat([p.to(dev) for p in parts])
    ref, _ = polyphase_fir_block(
        torch.as_tensor(xt[None], device=dev),
        torch.zeros((1, cfg.taps - 1, 2), device=dev),
        torch.as_tensor(make_fir_banks(cfg), device=dev))
    bad = torch.nonzero((got != ref).flatten()).flatten()
    if len(bad):
        # cuDNN may pick another algorithm for another length: hold the FIR
        # budget (tests/test_torch_fir.py) and report the first tick.
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        check(bool(torch.all((got - ref).abs()
                             <= 1e-5 * scale + 1e-5 * ref.abs())),
              f"(j) time-sharded FIR outside the FIR budget: max |err| {err}")
        fir_note = (f"NOT bitwise: first differing tick "
                    f"{int(bad[0]) // (2 * ref.shape[2])} of {ref.shape[0]}, "
                    f"max |err| {err:.3g} of max |F| {scale:.3g}, within "
                    f"the FIR budget")
    else:
        fir_note = "bitwise"

    # ---- one fleet over two processes (gloo), each on cuda:0 ------------
    data = fleet_iq(cfg, N_FLEET, MH_BLOCKS * L, SEED + 3, dev).cpu().numpy()
    ref_fleet = FleetDemodulator(cfg, N_FLEET, device=dev)
    want = [ref_fleet.process_blocks(data[:, b * L:(b + 1) * L])
            for b in range(MH_BLOCKS)]
    want = {k: np.concatenate([getattr(o, k) for o in want], axis=1)
            for k in ("sym_re", "sym_im", "valid", "locked_once")}
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "data.npy"),
                data.reshape(N_FLEET, MH_BLOCKS, L, 2))
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mh-worker",
             str(rank), str(port), tmp, str(mesh[0])], env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in (0, 1)]
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
        t_mh = time.perf_counter() - t0
        for rank, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"(j) multihost worker {rank} exit "
                  f"{p.returncode}:\n{log[-3000:]}")
        ws = [dict(np.load(os.path.join(tmp, f"w{r}.npz"))) for r in (0, 1)]
    for r, w in enumerate(ws):
        sl = slice(int(w["start"]), int(w["stop"]))
        check(int(w["launches"]) == MH_BLOCKS, f"(j) worker {r} launched the "
              f"kernel {int(w['launches'])} times")
        for k, v in want.items():
            check(np.array_equal(w[k], v[sl]), f"(j) worker {r} rows {sl} "
                  f"{k} differ from the single-process fleet's")
        for k, v in ref_fleet.telemetry.items():
            t = w[f"tel_{k}"]
            check(t == ws[0][f"tel_{k}"], f"(j) telemetry {k} differs "
                  f"between the processes")
            check(int(t) == int(v) if k != "mean_agc_gain" else
                  np.isclose(t, v, rtol=1e-6, atol=0),
                  f"(j) job telemetry {k} {t} != one process's {v}")

    # ---- the dry run ---------------------------------------------------
    t0 = time.perf_counter()
    dryrun_multichip(4)
    t_dry = time.perf_counter() - t0
    say(f"(j) several devices, shards on {names} "
        f"({torch.cuda.device_count()} card(s)"
        f"{', each on a CUDA stream of its own' if shared[0] else ''}): "
        f"{a.nbytes >> 20} MiB to and "
        f"from each card and back bitwise; fleet driver {N_FLEET} x "
        f"{CHAIN} blocks x 3 chains (i16 in, int8 out) == (e) bitwise, carry "
        f"and integer telemetry after chain 2 equal, mean_agc_gain within "
        f"1e-6; {float(np.mean(walls[1:])) * 1e3:.2f} ms per chain, "
        f"{msps:.1f} Msamples/s beside (e)'s {e['msps']:.1f} on one shard; "
        f"demod_array_turbo at {MESH_LANES} lanes on {TURBO_SECONDS} s == one "
        f"device bitwise ({two.passes} passes, {len(two.symbols)} symbols), "
        f"{t_two:.2f} s against {t_one:.2f} s on one device ((h)'s "
        f"{e['turbo_s']:.2f} s at 105 lanes); time-sharded FIR over "
        f"{FIR_BLOCKS} blocks: {fir_note}; 2-process MultiHostFleet (gloo, "
        f"{mesh[0]} each, {N_FLEET // 2} streams a process x {MH_BLOCKS} "
        f"blocks) "
        f"rows == the single-process fleet's bitwise, telemetry the same in "
        f"both, {t_mh:.1f} s with start-up; dryrun_multichip(4) ok in "
        f"{t_dry:.1f} s on {card}")


# Cycles of torch.cuda._sleep, a spin kernel: ~50 ms at an H100's clock.
SPIN = 100_000_000


def phase_j_streams(cfg, dev, card: str) -> None:
    """The stream contract: the fleet step and the stream demodulator under
    a side stream while the default stream spins, bitwise to the default
    stream; see the module docstring."""
    from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                       quantize_symbols)
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.parallel.mesh import TELEMETRY, make_fleet_demod
    from meteor_demod_tpu_torch.utils import to_device, to_host
    raw, x = MESHED["raw"], MESHED["x"]
    MESHED.clear()
    span = CHAIN * cfg.block_len
    n = 24 * cfg.block_len + 3000

    def fleet_step():
        step = make_fleet_demod(cfg, N_FLEET, dev, chain=CHAIN, ingest="i16",
                                packed=True)
        carry, out = batch_carry(cfg, N_FLEET, dev), {}
        for c in range(2):
            carry, o, tel = step(carry, to_device(np.ascontiguousarray(
                raw[:, c * span:(c + 1) * span]), dev))
            got = to_host([getattr(o, k) for k in
                           ("sym_i", "sym_q", "valid", "locked_once")]
                          + [tel[k] for k in TELEMETRY])
            out.update({f"{c}.{i}": v for i, v in enumerate(got)})
        out.update(leaves(carry))
        return out

    def stream():
        d = StreamDemodulator(cfg, dev)
        parts = [d.process(x[at:at + 8192]) for at in range(0, n, 8192)]
        sym = np.concatenate(parts + [d.finish()])
        return {"s": quantize_symbols(sym), "locked_once": sym["locked_once"],
                **leaves(d._carry)}

    side = torch.cuda.Stream(dev)
    lines = []
    for name, fn in (("fleet step", fleet_step), ("stream", stream)):
        want = fn()
        torch.cuda._sleep(SPIN)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            got = fn()
        secs = time.perf_counter() - t0
        torch.cuda.synchronize()
        for k in want:
            check(np.array_equal(got[k], want[k]), f"(j-streams) {name}: "
                  f"{k} under a side stream differs from the default stream")
        lines.append(f"{name} {secs:.2f} s")
    say(f"(j-streams) under a side stream while the default stream spins: "
        f"the fleet step ({N_FLEET} x {CHAIN} blocks x 2 chains, i16 in, "
        f"int8 out) and a StreamDemodulator ({n} samples in 8192-sample "
        f"pieces) bitwise equal to the default stream in every output, "
        f"carry leaf and telemetry value and in the .s bytes; "
        f"{', '.join(lines)} on {card}")


def phase_k(cfg, dev, card: str) -> None:
    """The soak at a quarter of its size: the span leg over SOAK_SPAN_SAMPLES
    and the sequential leg over SOAK_SEQ_SAMPLES with every check of
    meteor_demod_tpu_torch/soak.py (each span converged with every lane
    accepted, sane and locked; the checkpoint's span replayed bitwise; the
    sequential leg flag-free and locked)."""
    from meteor_demod_tpu_torch import soak
    size = soak.FULL
    with tempfile.TemporaryDirectory() as tmp:
        span = soak.span_soak(cfg, SOAK_SPAN_SAMPLES, size["chunks"],
                              size["kb"], os.path.join(tmp, "carry.npz"), dev,
                              nwarm=size["nwarm"],
                              carrier_hz=size["carrier_hz"])
    seq = soak.sequential_soak(cfg, SOAK_SEQ_SAMPLES, dev,
                               carrier_hz=size["carrier_hz"],
                               chain=size["chain"])
    check(span["samples"] >= SOAK_SPAN_SAMPLES and span["replay_bitwise"],
          f"(k) span leg {span}")
    check(seq["samples"] >= SOAK_SEQ_SAMPLES, f"(k) sequential leg {seq}")
    say(f"(k) soak: span leg {span['spans']} spans of {size['chunks']} lanes x "
        f"{size['kb']} blocks, {span['samples']} samples "
        f"({span['signal_minutes']:.1f} min of signal), every span converged "
        f"in <= {span['passes_max']} passes with all lanes accepted, locked "
        f"and sane, the span after the checkpoint (span "
        f"{span['checkpoint_span']}) replayed bitwise, "
        f"{span['msamples_per_s']:.1f} Msamples/s ({span['note']}), RSS "
        f"{span['rss_start_mb']} -> {span['rss_end_mb']} MiB; sequential leg "
        f"{seq['dispatches']} dispatches of {seq['chain']} blocks, "
        f"{seq['samples']} samples, 0 flags, locked, "
        f"{seq['msamples_per_s']:.1f} Msamples/s on {card}")


def phase_l(cfg, dev, card: str) -> None:
    """`python -m meteor_demod_tpu_torch.scaling --mode overhead` at
    OVERHEAD_STREAMS streams: FleetDemodulator's step against the bare
    make_batch_demod call on the same rows, per block."""
    from meteor_demod_tpu_torch.scaling import run_overhead
    r = run_overhead(cfg, OVERHEAD_STREAMS, OVERHEAD_STEPS, dev)
    check(r["same_work_bitwise"], f"(l) the bare step's outputs or carry "
          f"differ from the fleet's: {r}")
    check(r["fleet_step_ms"] > 0 and r["plain_step_ms"] > 0, f"(l) {r}")
    say(f"(l) scaling --mode overhead at {OVERHEAD_STREAMS} streams x "
        f"{cfg.block_len} samples, the bare step's outputs and carry bitwise "
        f"the fleet's: FleetDemodulator step "
        f"{r['fleet_step_ms']:.3f} ms a block against make_batch_demod "
        f"{r['plain_step_ms']:.3f} ms with its outputs read back (overhead "
        f"{r['overhead_ms']:.3f} ms, efficiency bound "
        f"{r['efficiency_lower_bound']:.3f}), {r['steps']} steps after "
        f"{r['warm_steps']} to lock, on {card}")


def kernel(mode: dict):
    """The wrapper of mode's kernel; its .launches is the kernel's count."""
    from meteor_demod_tpu_torch.kernels import block_demod as kb
    return getattr(kb, mode["name"])


def main_path(cfg, dev, smi: str, mode: dict, other: dict) -> int:
    """Drive one mode's main paths (fleet loop, CLI, fleet driver and its
    checkpoint, turbo on a file, turbo on stdin), each with the launch and replay counts set to 0 just before
    it and read just after; return the sum of its kernel's launches."""
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    suffix = "-oq" if cfg.oqpsk else ""
    total = 0
    for phase, tag in ((phase_c, "c"), (phase_d, "d"), (phase_ef, "e"),
                       (phase_h, "h"), (phase_i, "i")):
        kernel(mode).launches = kernel(other).launches = 0
        StreamDemodulator.replayed_blocks = 0
        timed(tag + suffix, phase, cfg, dev, smi, tag + suffix)
        launches = kernel(mode).launches
        check(launches > 0, f"({tag + suffix}) the {mode['name']} path never "
              f"launched its kernel")
        check(kernel(other).launches == 0,
              f"({tag + suffix}) the {mode['name']} path launched "
              f"{other['name']}")
        check(StreamDemodulator.replayed_blocks == 0,
              f"({tag + suffix}) blocks were replayed on the host")
        total += launches
    return total


def main() -> int:
    if sys.argv[1:2] == ["--mh-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return mh_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:6])
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA card "
                         "(torch.cuda.is_available() is false)\n")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    fresh = not _build.library_path("block_demod").exists()
    t0 = time.perf_counter()
    _build.load("block_demod")
    say(f"(a) built {KERNEL_SOURCE} with nvcc in "
        f"{time.perf_counter() - t0:.2f} s ({'fresh' if fresh else 'cached'}"
        f"); torch {torch.__version__}, CUDA {torch.version.cuda}; {card}; "
        f"torch.cuda.device_count() {torch.cuda.device_count()}")

    cfgs = dict(qpsk=DemodConfig(samplerate=FS),
                oqpsk=DemodConfig(samplerate=FS, symrate=80000.0, oqpsk=True))
    rec = dict(qpsk=timed("b", phase_b, cfgs["qpsk"], dev, "b"),
               oqpsk=timed("b-oq", phase_b, cfgs["oqpsk"], dev, "b-oq"))
    for m, tag in (("qpsk", "b-lanes"), ("oqpsk", "b-lanes-oq")):
        rec[m]["max_abs_err"] = max(rec[m]["max_abs_err"], timed(
            tag, phase_b_lanes, cfgs[m], dev, tag))
    rec["qpsk"]["max_abs_err"] = max(rec["qpsk"]["max_abs_err"], timed(
        "b-hifi", phase_b_hifi, DemodConfig(samplerate=FS, rrc_order=64,
                                            interp=10), dev, "b-hifi"))
    for m, other in (("qpsk", "oqpsk"), ("oqpsk", "qpsk")):
        rec[m]["launches"] = main_path(cfgs[m], dev, smi, MODES[m],
                                       MODES[other])
    # (j), (k) and (l) are QPSK paths of their own, read like the others;
    # (j)'s 2-process fleet's launches are the workers' and are checked
    # from their files.
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    for phase, tag in ((phase_j, "j"), (phase_j_streams, "j-streams"),
                       (phase_k, "k"), (phase_l, "l")):
        kernel(MODES["qpsk"]).launches = kernel(MODES["oqpsk"]).launches = 0
        StreamDemodulator.replayed_blocks = 0
        timed(tag, phase, cfgs["qpsk"], dev, smi)
        check(StreamDemodulator.replayed_blocks == 0,
              f"({tag}) blocks were replayed on the host")
        check(kernel(MODES["oqpsk"]).launches == 0,
              f"({tag}) launched the OQPSK kernel")
        check(kernel(MODES["qpsk"]).launches > 0,
              f"({tag}) never launched its kernel")
        rec["qpsk"]["launches"] += kernel(MODES["qpsk"]).launches
    timed("g", phase_g, smi)
    bench = timed("m", phase_m, card)
    for m in ("qpsk", "oqpsk"):
        rec[m]["launches"] += bench[MODES[m]["name"]]

    say(json.dumps({"kernels": [{
        "name": MODES[m]["name"], "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": MODES[m]["replaces"], "launches": rec[m]["launches"],
        "max_abs_err": rec[m]["max_abs_err"], "ms": rec[m]["ms"],
        "plain_ms": rec[m]["plain_ms"], "bound_ms": rec[m]["bound_ms"],
        "bound_by": rec[m]["bound_by"],
        # No PyTorch call computes a per-symbol feedback recurrence.
        "library_ms": None} for m in ("qpsk", "oqpsk")]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
