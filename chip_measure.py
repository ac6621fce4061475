#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one card, for PERF.md.

    python3 chip_measure.py [--json OUT.json]     # from the repo root

Default config (230.4 ksps QPSK, block_len 8192). Prints one line per
figure, each taken in this run:
  1. the recurrence kernel's ms per block against the stream count B
     (CUDA events, 10 launches each; Ft tiled from 128 simulated streams);
  2. the FIR per block at B = 1, 128 and 1024: the CUDA-event time of the
     whole polyphase_fir_block call (the tail concat, the input transpose,
     the cuDNN conv1d, the tick-major permute copy and the tail copy, plus
     any gap the card spends waiting on the host to launch them), and the
     torch.profiler device time of each of its kernels per call;
  3. torch.profiler breakdowns of the fleet loop (make_batch_demod, 8
     blocks at B = 128 and 1024) and unprofiled fleet Msamples/s (16
     blocks);
  4. a torch.profiler breakdown of the stream driver (StreamDemodulator,
     B = 1, ~10 s of signal), with its count of blocks replayed on the host.
The card's name, power limit and max SM clock come first. Exits 1 without a
CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def device_profile(fn, label: str) -> dict:
    """Run fn once under torch.profiler; print and return the wall time and
    the device time of each CUDA kernel / copy, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"{label}: wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f} %)", flush=True)
    for key, ms, n in rows[:8]:
        print(f"    {ms:9.3f} ms  x{n:5d}  {key[:90]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy,
                kernels=[(k[:90], ms, n) for k, ms, n in rows])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_measure: no CUDA card\n")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import (make_fir_banks,
                                                polyphase_fir_block)
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod
    from meteor_demod_tpu_torch.sim import synth_psk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    cfg = DemodConfig(samplerate=cs.FS)
    L = cfg.block_len
    res: dict = {"card": smi}

    # 1. Kernel ms per block against B.
    x = cs.fleet_iq(128, L, 7, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    Ft128, _ = polyphase_fir_block(x, batch_carry(cfg, 128, dev).fir_tail,
                                   banks)
    sweep = {}
    for B in (1, 32, 128, 512, 1024, 4096, 16896, 33792):
        Ft = Ft128.repeat(1, 1, -(-B // 128))[:, :, :B].contiguous()
        c = batch_carry(cfg, B, dev)
        block_demod(cfg, c, Ft)
        sweep[B] = cs.cuda_ms(lambda: block_demod(cfg, c, Ft), 10)
        print(f"kernel B={B:6d}: {sweep[B]:.3f} ms/block, "
              f"{B * L / sweep[B] / 1e3:.1f} Msamples/s (kernel only)",
              flush=True)
        del Ft, c
        torch.cuda.empty_cache()
    res["kernel_ms_vs_B"] = sweep

    # 2. FIR per block: the whole call by events, its kernels by profiler.
    for B in (1, 128, 1024):
        xb = x[torch.arange(B, device=dev) % 128].contiguous()
        tail = batch_carry(cfg, B, dev).fir_tail
        polyphase_fir_block(xb, tail, banks)
        ms = cs.cuda_ms(lambda: polyphase_fir_block(xb, tail, banks), 20)
        print(f"FIR B={B}: {ms:.3f} ms per polyphase_fir_block call "
              f"(CUDA events, 20 calls)", flush=True)
        prof = device_profile(
            lambda: [polyphase_fir_block(xb, tail, banks) for _ in range(20)],
            f"FIR B={B} x 20 calls")
        res[f"fir_B{B}"] = dict(event_ms=ms, device_ms_per_call=prof[
            "busy_ms"] / 20, profile=prof)

    # 3. The fleet loop through make_batch_demod.
    for B in (128, 1024):
        fn = make_batch_demod(cfg, B, dev)
        xx = cs.fleet_iq(128, 16 * L, 11, dev).repeat(B // 128, 1, 1)
        fn(batch_carry(cfg, B, dev), xx[:, :L])

        def loop(n):
            c = batch_carry(cfg, B, dev)
            for i in range(n):
                c, _ = fn(c, xx[:, i * L:(i + 1) * L])
            return c

        prof = device_profile(lambda: loop(8), f"fleet B={B} x 8 blocks")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(16)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"fleet B={B} x 16 blocks unprofiled: {secs:.4f} s, "
              f"{B * 16 * L / secs / 1e6:.1f} Msamples/s", flush=True)
        res[f"fleet_B{B}"] = dict(profile=prof, secs_16=secs)
        del xx

    # 4. The stream driver at B = 1.
    sig, _ = synth_psk(72000 * 2, cs.FS, carrier_hz=300.0, amplitude=6000.0,
                       snr_db=20.0, seed=1)
    sig = np.tile(sig, 5)
    d = StreamDemodulator(cfg, dev)
    d.process(sig[:8 * L])
    d.sync()
    span = 8 * L
    starts = range(span, len(sig) - span, span)

    def stream():
        for i in starts:
            d.process(sig[i:i + span])
        d.sync()

    n_blocks = len(starts) * 8
    prof = device_profile(stream, f"stream B=1, {n_blocks} blocks")
    print(f"stream: {prof['wall_ms'] / n_blocks:.3f} ms/block (profiled), "
          f"{d.fallback_blocks} blocks replayed on the host", flush=True)
    res["stream"] = dict(profile=prof, blocks=n_blocks,
                         replayed=d.fallback_blocks)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
