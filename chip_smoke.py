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
      times per block at B = 128 and B = 1, and the kernel's bound at
      B = 128 (bytes over the memory rate or operations over the fp32 rate,
      from this run's count of fires);
  (b-oq) the same for the OQPSK kernel at the OQPSK config (80 ksym/s
      interleaved, block_len 8192), with (S+1)-row outputs: the pre-fire must
      run on some stream (a symbol split across the block boundary), and
      the first such stream is checked against the oracle too;
  (c) the QPSK fleet width: 128 streams x 16 chained blocks through
      make_batch_demod on the card: no flags, symbol counts within 1 % of
      nominal, Msamples/s;
  (d) the QPSK CLI: a 30 s, 16-bit, 230.4 ksps QPSK WAV (300 Hz carrier,
      20 dB) through `cli.main([... "-B", "-q", "-o", out, wav])` on the card:
      exit 0, at least one kernel launch per block, 72000*30 symbols within
      1 %, carrier locked, mean |soft byte| in 55-75;
  (c-oq), (d-oq) the same for OQPSK (`-m oqpsk -r 80k`; 80000*30 symbols,
      mean |soft byte| in 60-79: the JAX CLI on the CPU reads 69.55 on the
      first 6 s of the same WAV);
  (e), (e-oq) the fleet driver at full width: FleetDemodulator(cfg, 128,
      chain_blocks=16, ingest="i16", packed_output=True) on the card (its
      default device) over (c)'s kind of fixture rounded to int16, 4 chains:
      int8 outputs bitwise equal to make_batch_demod block by block on the
      decoded float input plus the host quantizer, no flags, no recovered
      stream, telemetry `symbols` equal to the sum of `valid`, 64 kernel
      launches (one per block); Msamples/s, and the host's share of a chain
      (wall time less the torch.profiler sum of device time);
  (f), (f-oq) the fleet checkpoint: saved after chain 2 of (e), loaded, and
      chains 3-4 run on the loaded fleet: outputs and every carry leaf
      bitwise equal to the uninterrupted run's;
  (g) the serving host: `python -m meteor_demod_tpu_torch.serve_fleet --synth
      256 --dead 2 --group-size 128 --chain 16` on 6 s of signal as a
      subprocess on the card, once straight through and once stopped with
      --max-blocks and resumed with --resume: exit 0, 256 .s files,
      byte-identical between the two, every live stream's symbol count
      between the nominal count after the latest lock its carrier allows
      and the nominal count of the whole run (1 % either way), no stream
      span recovered by the host oracle; Msamples/s.
Each main path, QPSK ((c), (d), (e), (f)) and OQPSK (the same with -oq), is
driven with both kernels' launch counts and the counts of blocks replayed by
the numpy oracle on the host set to 0 just before it and read just after:
the path's own kernel must have launched, the other kernel not at all, and
the replay counts must be 0, so that every block came from the card. (The
serving host of (g) is a process of its own: its launches are not in these
counts.) The line before the last is the kernels' JSON record, the last line
is {"ok": true, ...}.

Imports nothing of JAX or of the JAX package. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import filecmp
import json
import os
import re
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
FLEET_CHAINS = 4     # (e): chains of CHAIN blocks through the fleet driver
# (g): the serving host's fleet. 6 s of signal, not the 10 s of a short pass:
# synthesizing 254 passes on the host costs ~10 s per second of signal, three
# times over, and is set-up, not serving.
SERVE_ARGS = ["--synth", "256", "--dead", "2", "--seconds", "6",
              "--group-size", "128", "--chain", "16", "--status-every", "4"]
SERVE_KILL_AT = 5    # chains served before the stopped run ends
SWEEP_HZ_PER_S = 825.0   # the acquisition sweep's rate at 72 ksym/s
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


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
        pc, po = block_demod_torch(cfg, pc, Ft)
        torch.cuda.synchronize()
        a, b = outputs(ko), outputs(po)
        ka, pa = leaves(kc), leaves(pc)
        for k in a:
            check(np.array_equal(a[k], b[k]), f"({tag}) block {i}: kernel {k} "
                  f"differs from plain, max {np.abs(a[k] - b[k]).max()}")
        for k in ka:
            check(np.array_equal(ka[k], pa[k]),
                  f"({tag}) block {i}: kernel carry {k} differs from plain")
        err = max(err, max_abs_diff(a, b))
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
    # Times per block, from the same entry carry and FIR output.
    c0 = batch_carry(cfg, N_FLEET, dev)
    c1 = batch_carry(cfg, 1, dev)
    ft1 = fts[0][:, :, :1].contiguous()
    t = dict(
        ms=cuda_ms(lambda: block_demod(cfg, c0, fts[0]), 20),
        plain_ms=cuda_ms(lambda: block_demod_torch(cfg, c0, fts[0]), 1),
        ms_b1=cuda_ms(lambda: block_demod(cfg, c1, ft1), 20),
        plain_ms_b1=cuda_ms(lambda: block_demod_torch(cfg, c1, ft1), 1))
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
        f"{t['ms_b1']:.3f} ms vs plain {t['plain_ms_b1']:.1f} ms at B=1; "
        f"bound at B=128 {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} "
        f"({fires} fires, {n_bytes} bytes)")
    return dict(max_abs_err=err, **t)


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


def phase_d(cfg, dev, card: str, tag: str) -> None:
    from meteor_demod_tpu_torch import cli
    from meteor_demod_tpu_torch.constants import RING_SYMBOLS
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.sim import synth_psk, write_wav
    mode = MODES["oqpsk" if cfg.oqpsk else "qpsk"]
    # A 3 s piece tiled to 60 s: 3 s holds whole symbols, whole samples and
    # 900 whole carrier cycles, so the carrier and the symbol clock run on
    # across the joins (a pass is ~10 minutes; 60 s keeps the smoke short).
    x, _ = synth_psk(int(cfg.symrate) * PIECE_S, FS, symrate=cfg.symrate,
                     oqpsk=cfg.oqpsk, carrier_hz=300.0, amplitude=6000.0,
                     snr_db=20.0, seed=SEED)
    x = np.tile(x, CLI_SECONDS // PIECE_S)
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
        f"replayed on the host, {secs:.2f} s wall on {card}")


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
    say(f"({ftag}) fleet checkpoint after chain 2, loaded, chains 3-4: "
        f"outputs and all {len(final)} carry leaves bitwise equal to the "
        f"uninterrupted run on {card}")


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


def kernel(mode: dict):
    """The wrapper of mode's kernel; its .launches is the kernel's count."""
    from meteor_demod_tpu_torch.kernels import block_demod as kb
    return getattr(kb, mode["name"])


def main_path(cfg, dev, smi: str, mode: dict, other: dict) -> int:
    """Drive one mode's main paths (fleet loop, CLI, fleet driver and its
    checkpoint), each with the launch and replay counts set to 0 just before
    it and read just after; return the sum of its kernel's launches."""
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    suffix = "-oq" if cfg.oqpsk else ""
    total = 0
    for phase, tag in ((phase_c, "c"), (phase_d, "d"), (phase_ef, "e")):
        kernel(mode).launches = kernel(other).launches = 0
        StreamDemodulator.replayed_blocks = 0
        phase(cfg, dev, smi, tag + suffix)
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
        f"); torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")

    cfgs = dict(qpsk=DemodConfig(samplerate=FS),
                oqpsk=DemodConfig(samplerate=FS, symrate=80000.0, oqpsk=True))
    rec = dict(qpsk=phase_b(cfgs["qpsk"], dev, "b"),
               oqpsk=phase_b(cfgs["oqpsk"], dev, "b-oq"))
    for m, other in (("qpsk", "oqpsk"), ("oqpsk", "qpsk")):
        rec[m]["launches"] = main_path(cfgs[m], dev, smi, MODES[m],
                                       MODES[other])
    phase_g(smi)

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
