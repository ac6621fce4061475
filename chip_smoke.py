#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (meteor_demod_tpu_torch) on one card.

    python3 chip_smoke.py          # from the repo root, on a machine with one
                                   # NVIDIA Hopper card and the CUDA toolkit

Phases, one line each; any failed check raises and the script exits non-zero:
  (a) build the CUDA recurrence kernel from csrc/ with nvcc; print the card's
      name and power limit;
  (b) kernel vs plain torch recurrence on the same card-computed FIR output:
      the default config (230.4 ksps QPSK, block_len 8192), 128 simulated
      streams (carriers +50..+600 Hz, SNR 12-25 dB, DC offsets, one noise-only
      stream), 2 chained blocks, every output and carry leaf bitwise; then
      streams 0-1 of block 0 against the numpy oracle; kernel and plain times
      per block at B = 128 and B = 1;
  (c) the fleet width: 128 streams x 16 chained blocks through
      make_batch_demod on the card: no flags, symbol counts within 1 % of
      nominal, Msamples/s;
  (d) the CLI main path: a 60 s, 16-bit, 230.4 ksps QPSK WAV (300 Hz carrier,
      20 dB) through `cli.main([... "-B", "-q", "-o", out, wav])` on the card:
      exit 0, at least one kernel launch per block, 72000*60 symbols within
      1 %, carrier locked, mean |soft byte| in 55-75.
The kernel's launch count and the stream driver's count of blocks replayed
by the numpy oracle on the host are reset just before (c) and read after
(d): the launches are the main path's, and the replay count must be 0, so
that every block of (c) and (d) came from the card. The line before the
last is the kernels' JSON record, the last line is {"ok": true, ...}.

Imports nothing of JAX or of the JAX package. Exits 1 without a CUDA card.
"""

from __future__ import annotations

import json
import os
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
CLI_SECONDS = 60
PIECE_S = 3          # the CLI fixture is a PIECE_S-second sim piece, tiled
KERNEL_SOURCE = "meteor_demod_tpu_torch/csrc/block_demod.cu"
KERNEL_REPLACES = "meteor_demod_tpu/kernels/block_demod.py:1382"


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def fleet_iq(n_streams: int, n_samples: int, seed: int,
             device) -> torch.Tensor:
    """(n_streams, n_samples, 2) float32 IQ on `device`: sim QPSK baseband
    (4 seeded symbol sequences) given per-stream carriers +50..+600 Hz,
    phases, amplitudes, SNR 12-25 dB and DC offsets on the card; the last
    stream is noise only."""
    from meteor_demod_tpu_torch.sim import synth_psk
    bases = [synth_psk(n_samples // 3 + 64, FS, carrier_hz=0.0, amplitude=1.0,
                       snr_db=300.0, seed=seed + k)[0][:n_samples]
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


def phase_b(cfg, dev) -> dict:
    from meteor_demod_tpu_torch.demod import scalar
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import (f32_to_iq, make_fir_banks,
                                                polyphase_fir_block)
    from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                            block_demod_torch)
    L = cfg.block_len
    x = fleet_iq(N_FLEET, 2 * L, SEED, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    kc = pc = batch_carry(cfg, N_FLEET, dev)
    tail = kc.fir_tail
    err = 0.0
    fts = []
    for i in range(2):
        Ft, tail = polyphase_fir_block(x[:, i * L:(i + 1) * L], tail, banks)
        fts.append(Ft)
        kc, ko = block_demod(cfg, kc, Ft)
        pc, po = block_demod_torch(cfg, pc, Ft)
        torch.cuda.synchronize()
        a, b = outputs(ko), outputs(po)
        ka, pa = leaves(kc), leaves(pc)
        for k in a:
            check(np.array_equal(a[k], b[k]), f"(b) block {i}: kernel {k} "
                  f"differs from plain, max {np.abs(a[k] - b[k]).max()}")
        for k in ka:
            check(np.array_equal(ka[k], pa[k]),
                  f"(b) block {i}: kernel carry {k} differs from plain")
        err = max(err, max_abs_diff(a, b))
        check(int(a["valid"].sum()) > N_FLEET * 2500, "(b) too few symbols")
        if i == 0:
            first = (a, x[:, :L].cpu().numpy(), Ft.cpu().numpy())
    # Streams 0-1, block 0, against the numpy oracle on the same Ft.
    a, xb, Ftn = first
    oracle_err = 0.0
    for b in range(2):
        F = f32_to_iq(np.ascontiguousarray(Ftn[:, :, b])).reshape(
            L, cfg.interp)
        syms, _ = scalar.demod_stream_np(
            cfg, f32_to_iq(np.ascontiguousarray(xb[b])),
            scalar.initial_state(cfg), F=F)
        m = a["valid"][b].astype(bool)
        check(len(syms) == m.sum(), f"(b) oracle count {len(syms)} != "
              f"kernel {m.sum()} (stream {b})")
        check(np.array_equal(syms["locked_once"], a["locked_once"][b][m]),
              f"(b) oracle locked_once differs (stream {b})")
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
    say(f"(b) kernel == plain bitwise over {N_FLEET} streams x 2 blocks "
        f"(max_abs_err {err}); oracle streams 0-1 block 0: decisions "
        f"bitwise, max |value diff| {oracle_err}; per block: kernel "
        f"{t['ms']:.3f} ms vs plain {t['plain_ms']:.1f} ms at B=128, kernel "
        f"{t['ms_b1']:.3f} ms vs plain {t['plain_ms_b1']:.1f} ms at B=1")
    return dict(max_abs_err=err, **t)


def phase_c(cfg, dev, card: str) -> None:
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.state import batch_carry
    L = cfg.block_len
    x = fleet_iq(N_FLEET, CHAIN * L, SEED + 1, dev)
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
    check(not flags.any(), f"(c) flags set on streams {np.nonzero(flags)[0]}")
    check(np.all(np.abs(counts - nominal) <= 0.01 * nominal),
          f"(c) symbol counts {counts.min()}..{counts.max()} not within 1 % "
          f"of {nominal:.0f}")
    locked = int(carry.locked.sum())
    msps = N_FLEET * CHAIN * L / secs / 1e6
    say(f"(c) fleet {N_FLEET} x {CHAIN} blocks ({N_FLEET * CHAIN * L / 1e6:.1f}"
        f" Msamples): flags 0, symbols/stream {counts.min()}..{counts.max()} "
        f"(nominal {nominal:.0f}), {locked}/{N_FLEET} locked, {secs:.3f} s, "
        f"{msps:.1f} Msamples/s on {card}")


def phase_d(cfg, dev, card: str) -> int:
    from meteor_demod_tpu_torch import cli
    from meteor_demod_tpu_torch.constants import RING_SYMBOLS
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod
    from meteor_demod_tpu_torch.sim import synth_psk, write_wav
    # A 3 s piece tiled to 60 s: 3 s holds whole symbols, whole samples and
    # 900 whole carrier cycles, so the carrier and the symbol clock run on
    # across the joins (a pass is ~10 minutes; 60 s keeps the smoke short).
    x, _ = synth_psk(72000 * PIECE_S, FS, carrier_hz=300.0, amplitude=6000.0,
                     snr_db=20.0, seed=SEED)
    x = np.tile(x, CLI_SECONDS // PIECE_S)
    with tempfile.TemporaryDirectory() as tmp:
        wav, out = os.path.join(tmp, "pass.wav"), os.path.join(tmp, "pass.s")
        write_wav(wav, x, FS, 16)
        blocks = len(x) // cfg.block_len
        before = block_demod.launches
        os.environ.pop("METEOR_DEMOD_PLATFORM", None)        # the card
        t0 = time.perf_counter()
        rc = cli.main(["meteor_demod_tpu_torch", "-B", "-q", "-o", out, wav])
        secs = time.perf_counter() - t0
        soft = np.fromfile(out, dtype=np.int8)
    launched = block_demod.launches - before
    check(rc == 0, f"(d) CLI exit {rc}")
    check(launched >= blocks, f"(d) {launched} kernel launches for {blocks} "
          f"blocks")
    replayed = StreamDemodulator.replayed_blocks
    check(replayed == 0, f"(d) {replayed} flagged blocks were recomputed by "
          f"the numpy oracle on the host")
    n_sym = len(soft) // 2
    nominal = 72000 * CLI_SECONDS
    check(abs(n_sym - nominal) <= 0.01 * nominal,
          f"(d) {n_sym} symbols, expected {nominal} within 1 %")
    check(len(soft) >= 4 * RING_SYMBOLS, "(d) carrier never locked")
    mean_soft = float(np.mean(np.abs(soft.astype(np.float32))))
    check(55.0 <= mean_soft <= 75.0, f"(d) mean |soft byte| {mean_soft}")
    say(f"(d) CLI -B on {CLI_SECONDS} s of 16-bit 230.4 ksps QPSK: exit 0, "
        f"{n_sym} symbols (nominal {nominal}), locked, mean |soft| "
        f"{mean_soft:.1f}, {launched} kernel launches for {blocks} blocks, "
        f"{replayed} blocks replayed on the host, {secs:.2f} s wall on {card}")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA card "
                         "(torch.cuda.is_available() is false)\n")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.kernels import _build
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod

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

    cfg = DemodConfig(samplerate=FS)
    rec = phase_b(cfg, dev)

    block_demod.launches = 0                   # the main path starts here
    StreamDemodulator.replayed_blocks = 0
    phase_c(cfg, dev, smi)
    phase_d(cfg, dev, smi)
    launches = block_demod.launches
    check(launches > 0, "the main path never launched block_demod")

    say(json.dumps({"kernels": [{
        "name": "block_demod", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "plain_ms": rec["plain_ms"]}]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
