#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port on one card, for PERF.md.

    python3 chip_measure.py [--json OUT.json] [--sections a,b,...]
                            [--ab OTHER.cu [OTHER2.cu ...]]

Both modes (230.4 ksps, block_len 8192: QPSK 72 ksym/s and OQPSK 80 ksym/s).
Prints one line per figure, each taken in this run. Sections (all but `ab`
by default):
  sweep   each recurrence kernel's ms per block against the stream count B
          (CUDA events, 10 launches each; Ft tiled from 128 simulated
          streams), and B = 128 on an Ft of 32 distinct streams tiled four
          times (a quarter of the footprint, the same work);
  fir     the FIR per block at B = 1, 128 and 1024: the CUDA-event time of
          the whole polyphase_fir_block call, and the torch.profiler device
          time of each of its kernels per call;
  fleet   torch.profiler breakdowns of the fleet loop (make_batch_demod, 8
          blocks at B = 128 and 1024, per mode) and unprofiled fleet
          Msamples/s (16 blocks);
  driver  the fleet driver (FleetDemodulator, B = 128 x 16 chained blocks,
          per mode): Msamples/s over 4 chains for each upload format and
          output form (f32 or i16 in, float or packed int8 out) beside the
          bare make_batch_demod loop on the same input already on the card,
          in turns, and a torch.profiler breakdown of one i16/int8 chain
          (wall, device busy, the host's share, the upload's copy);
  serving the serving host's loop in this process (ServingFleet, 256 QPSK
          streams in two groups of 128, 16 blocks a chain, f32 in, int8 out,
          one lock-gated writer per stream to the null device): ms per
          chain spent stacking the inputs, in process_blocks and in the
          writers, and Msamples/s;
  stream  a torch.profiler breakdown of the stream demodulator
          (StreamDemodulator, B = 1, ~10 s of signal, per mode), with its
          count of blocks replayed on the host;
  ab      with --ab: the tree's csrc/block_demod.cu against each other
          source given (an earlier commit's copy, a variant under test),
          built with the same flags plus -Xptxas -v (registers and spills are
          printed). Every output and carry leaf of each source is compared
          bitwise with the tree's over two chained blocks at B = 128, then
          ms per block is read at B = 1, 128 and 16896 in turns (tree,
          others, others reversed, tree; 3 rounds, 20 launches a reading)
          and the medians are printed.
The card's name, power limit and max SM clock come first. Exits 1 without a
CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SECTIONS = ("sweep", "fir", "fleet", "driver", "serving", "stream")
SWEEP_B = (1, 32, 128, 512, 1024, 4096, 16896, 33792)
AB_B = (1, 128, 16896)


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


def build_source(path: str, out_dir: str) -> ctypes.CDLL:
    """Compile the .cu at `path` with the package's flags plus -Xptxas -v,
    print what ptxas says of each kernel, and bind its two launchers."""
    from meteor_demod_tpu_torch.kernels import _build
    out = os.path.join(out_dir, f"lib{abs(hash(path))}.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = None
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            fn = "oqpsk" if "oqpsk" in line else "qpsk"
        elif "Used" in line and fn:
            print(f"ptxas {path} [{fn}]: {line.split(':', 1)[-1].strip()}",
                  flush=True)
        elif "spill" in line and fn:
            print(f"ptxas {path} [{fn}]: {line.split(':', 1)[-1].strip()}",
                  flush=True)
    lib = ctypes.CDLL(out)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for f in (lib.block_demod_launch, lib.block_demod_oqpsk_launch):
        f.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        f.restype = i32
    return lib


@contextlib.contextmanager
def use_library(lib: ctypes.CDLL, n_params: int | None):
    """Route the package's kernel wrappers to `lib` (built from another
    source), handing it the first n_params packed parameters (an earlier
    source's Params struct is a prefix of the tree's)."""
    from meteor_demod_tpu_torch.kernels import block_demod as kb
    load, packed = kb.load_kernel, kb._packed_params
    kb.load_kernel = lambda: lib
    kb._packed_params = lambda cfg: packed(cfg)[:n_params]
    try:
        yield
    finally:
        kb.load_kernel, kb._packed_params = load, packed


def params_taken(lib, cfg, dev) -> int | None:
    """How many packed parameters lib's launchers take: the tree's count
    (None) or one fewer per refusal, found by a one-stream launch."""
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.kernels import block_demod as kb
    full = len(kb._packed_params(cfg))
    Ft = torch.zeros((cfg.block_ticks, 2, 1), device=dev)
    for n in range(full, full - 4, -1):
        with use_library(lib, n):
            try:
                kb.block_demod(cfg, batch_carry(cfg, 1, dev), Ft)
                torch.cuda.synchronize()
                return None if n == full else n
            except RuntimeError as e:
                if "cudaError 1" not in str(e):
                    raise
    raise RuntimeError("the library refuses every parameter count")


def mode_configs() -> dict:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.config import DemodConfig
    return dict(qpsk=DemodConfig(samplerate=cs.FS),
                oqpsk=DemodConfig(samplerate=cs.FS, symrate=80000.0,
                                  oqpsk=True))


def fir_output(cfg, n_streams: int, n_blocks: int, seed: int, dev) -> list:
    """The FIR outputs of n_blocks chained blocks of simulated streams."""
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import (make_fir_banks,
                                                polyphase_fir_block)
    L = cfg.block_len
    x = cs.fleet_iq(cfg, n_streams, n_blocks * L, seed, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
    tail = batch_carry(cfg, n_streams, dev).fir_tail
    fts = []
    for i in range(n_blocks):
        Ft, tail = polyphase_fir_block(x[:, i * L:(i + 1) * L], tail, banks)
        fts.append(Ft)
    return fts


def tile_streams(Ft: torch.Tensor, B: int) -> torch.Tensor:
    n = Ft.shape[2]
    return Ft.repeat(1, 1, -(-B // n))[:, :, :B].contiguous()


def section_sweep(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod
    for mode, cfg in cfgs.items():
        L = cfg.block_len
        Ft128 = fir_output(cfg, 128, 1, 7, dev)[0]
        sweep = {}
        for B in SWEEP_B:
            Ft = tile_streams(Ft128, B)
            c = batch_carry(cfg, B, dev)
            block_demod(cfg, c, Ft)
            sweep[B] = cs.cuda_ms(lambda: block_demod(cfg, c, Ft), 10)
            print(f"{mode} kernel B={B:6d}: {sweep[B]:.4f} ms/block, "
                  f"{B * L / sweep[B] / 1e3:.1f} Msamples/s (kernel only)",
                  flush=True)
            del Ft, c
            torch.cuda.empty_cache()
        res[f"{mode}_kernel_ms_vs_B"] = sweep
        # The same 128-stream work on a quarter of the footprint.
        c = batch_carry(cfg, 128, dev)
        full, quarter = Ft128, tile_streams(Ft128[:, :, :32].contiguous(), 128)
        pair = {}
        for name, Ft in (("128 distinct", full), ("32 tiled x4", quarter),
                         ("32 tiled x4", quarter), ("128 distinct", full)):
            block_demod(cfg, c, Ft)
            pair.setdefault(name, []).append(
                cs.cuda_ms(lambda: block_demod(cfg, c, Ft), 20))
        print(f"{mode} kernel B=128, Ft of 128 distinct streams "
              f"({full.numel() * 4 / 1e6:.1f} MB): "
              f"{pair['128 distinct']} ms/block; of 32 distinct streams "
              f"tiled x4: {pair['32 tiled x4']} ms/block", flush=True)
        res[f"{mode}_footprint_B128"] = pair


def section_fir(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.dsp.fir import (make_fir_banks,
                                                polyphase_fir_block)
    cfg = cfgs["qpsk"]
    x = cs.fleet_iq(cfg, 128, cfg.block_len, 7, dev)
    banks = torch.as_tensor(make_fir_banks(cfg), device=dev)
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


def section_fleet(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.state import batch_carry
    for mode, cfg in cfgs.items():
        L = cfg.block_len
        for B in (128, 1024):
            fn = make_batch_demod(cfg, B, dev)
            xx = cs.fleet_iq(cfg, 128, 16 * L, 11, dev).repeat(B // 128, 1, 1)
            fn(batch_carry(cfg, B, dev), xx[:, :L])

            def loop(n):
                c = batch_carry(cfg, B, dev)
                for i in range(n):
                    c, _ = fn(c, xx[:, i * L:(i + 1) * L])
                return c

            prof = device_profile(lambda: loop(8),
                                  f"{mode} fleet B={B} x 8 blocks")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop(16)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            print(f"{mode} fleet B={B} x 16 blocks unprofiled: {secs:.4f} s, "
                  f"{B * 16 * L / secs / 1e6:.1f} Msamples/s", flush=True)
            res[f"{mode}_fleet_B{B}"] = dict(profile=prof, secs_16=secs)
            del xx


def section_driver(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.backend import make_batch_demod
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
    B, K, chains = cs.N_FLEET, cs.CHAIN, 4
    for mode, cfg in cfgs.items():
        L = cfg.block_len
        span = K * L
        xi = cs.fleet_iq(cfg, B, (chains + 1) * span, 11, dev).round().clamp(
            -32768, 32767)
        feeds = {"f32": xi.cpu().numpy(),
                 "i16": xi.to(torch.int16).cpu().numpy()}
        fn = make_batch_demod(cfg, B, dev)

        def bare():
            c = batch_carry(cfg, B, dev)
            for i in range(K, (chains + 1) * K):
                c, _ = fn(c, xi[:, i * L:(i + 1) * L])
            torch.cuda.synchronize()

        def driver(ingest, packed):
            f = FleetDemodulator(cfg, B, dev, chain_blocks=K, ingest=ingest,
                                 packed_output=packed)
            f.process_blocks(feeds[ingest][:, :span])          # warm-up
            t0 = time.perf_counter()
            for c in range(1, chains + 1):
                f.process_blocks(feeds[ingest][:, c * span:(c + 1) * span])
            secs = time.perf_counter() - t0
            if f.recovered_streams:
                raise RuntimeError(f"{f.recovered_streams} streams recovered")
            return secs, f

        bare()
        runs = [("bare loop", None)] + [
            (f"driver {i} in, {'int8' if p else 'float'} out", (i, p))
            for i in ("f32", "i16") for p in (False, True)]
        out: dict = {name: [] for name, _ in runs}
        for order in (runs, runs[::-1]):
            for name, arg in order:
                if arg is None:
                    t0 = time.perf_counter()
                    bare()
                    secs = time.perf_counter() - t0
                else:
                    secs, _ = driver(*arg)
                out[name].append(B * chains * span / secs / 1e6)
        for name, rates in out.items():
            print(f"{mode} {name}, B={B} x {K} blocks x {chains} chains: "
                  f"{rates[0]:.1f} and {rates[1]:.1f} Msamples/s", flush=True)
        _, f = driver("i16", True)
        prof = device_profile(
            lambda: f.process_blocks(feeds["i16"][:, :span]),
            f"{mode} driver chain (i16 in, int8 out), B={B} x {K} blocks")
        print(f"{mode} driver chain: host share "
              f"{prof['wall_ms'] - prof['busy_ms']:.3f} ms of "
              f"{prof['wall_ms']:.3f} ms (profiled)", flush=True)
        res[f"{mode}_driver"] = dict(msamples=out, profile=prof)
        del xi, feeds


def section_serving(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch import serve_fleet
    from meteor_demod_tpu_torch.dsp.fir import f32_to_iq
    from meteor_demod_tpu_torch.io.writer import SymbolWriter
    from meteor_demod_tpu_torch.parallel.serving import ServingFleet
    cfg = cfgs["qpsk"]
    n, K, chains = 256, cs.CHAIN, 4
    span = K * cfg.block_len
    x = f32_to_iq(cs.fleet_iq(cfg, 128, (chains + 1) * span, 11, dev)
                  .cpu().numpy())
    sources = [x[i % 128] for i in range(n)]
    fleet = ServingFleet(cfg, n, group_size=128, device=dev, chain_blocks=K,
                         packed_output=True)
    batch = np.empty((n, span), np.complex64)
    parts = dict(stack=[], dispatch=[], writers=[])
    with open(os.devnull, "wb") as sink:
        writers = [SymbolWriter(sink) for _ in range(n)]
        for c in range(chains + 1):
            t0 = time.perf_counter()
            np.stack([s[c * span:(c + 1) * span] for s in sources], out=batch)
            t1 = time.perf_counter()
            outs = fleet.process_blocks(batch)
            t2 = time.perf_counter()
            for i in range(n):
                serve_fleet._write_rows(writers[i], outs, i)
            t3 = time.perf_counter()
            for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                parts[k].append(dt * 1e3)
    ms = {k: statistics.mean(v[1:]) for k, v in parts.items()}   # 0: warm-up
    total = sum(ms.values())
    print(f"serving loop, {n} streams x {K} blocks a chain (f32 in, int8 "
          f"out): stack {ms['stack']:.1f} ms, process_blocks "
          f"{ms['dispatch']:.1f} ms, writers {ms['writers']:.1f} ms a chain; "
          f"{n * span / total / 1e3:.1f} Msamples/s; "
          f"{sum(w.bytes_out for w in writers)} soft bytes", flush=True)
    res["serving_loop"] = dict(ms_per_chain=ms, all=parts)


def section_stream(cfgs: dict, dev, res: dict) -> None:
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
    from meteor_demod_tpu_torch.sim import synth_psk
    for mode, cfg in cfgs.items():
        L = cfg.block_len
        sig, _ = synth_psk(int(cfg.symrate) * 2, cs.FS, symrate=cfg.symrate,
                           oqpsk=cfg.oqpsk, carrier_hz=300.0,
                           amplitude=6000.0, snr_db=20.0, seed=1)
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
        prof = device_profile(stream, f"{mode} stream B=1, {n_blocks} blocks")
        print(f"{mode} stream: {prof['wall_ms'] / n_blocks:.3f} ms/block "
              f"(profiled), {d.fallback_blocks} blocks replayed on the host",
              flush=True)
        res[f"{mode}_stream"] = dict(profile=prof, blocks=n_blocks,
                                     replayed=d.fallback_blocks)


def section_ab(cfgs: dict, dev, res: dict, others: list[str]) -> None:
    """The tree's kernels against the sources in `others` (see the module
    docstring)."""
    import chip_smoke as cs
    from meteor_demod_tpu_torch.demod.state import batch_carry
    from meteor_demod_tpu_torch.kernels import _build
    from meteor_demod_tpu_torch.kernels.block_demod import block_demod
    tree = str(_build.CSRC / "block_demod.cu")
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for path in [tree] + others:
            lib = build_source(path, tmp)
            libs[path] = (lib, params_taken(lib, cfgs["qpsk"], dev))
        out: dict = {}
        for mode, cfg in cfgs.items():
            fts = fir_output(cfg, 128, 2, 7, dev)

            def run_two(path):
                got = []
                with use_library(*libs[path]):
                    c = batch_carry(cfg, 128, dev)
                    for Ft in fts:
                        c, o = block_demod(cfg, c, Ft)
                        got.append({**cs.leaves(c), **cs.outputs(o)})
                torch.cuda.synchronize()
                return got

            want = run_two(tree)
            for path in others:
                got = run_two(path)
                same = all(np.array_equal(g[k], w[k], equal_nan=True)
                           for g, w in zip(got, want) for k in w)
                print(f"{mode} {path}: outputs and carry bitwise equal to "
                      f"the tree's over 128 streams x 2 blocks: {same}",
                      flush=True)
                out.setdefault(mode, {})[path + " bitwise"] = same
            for B in AB_B:
                Ft = tile_streams(fts[1], B)
                c = batch_carry(cfg, B, dev)
                reads: dict = {p: [] for p in libs}
                order = [tree] + others + others[::-1] + [tree]
                for _ in range(3):
                    for path in order:
                        with use_library(*libs[path]):
                            block_demod(cfg, c, Ft)
                            reads[path].append(cs.cuda_ms(
                                lambda: block_demod(cfg, c, Ft), 20))
                base = statistics.median(reads[tree])
                for path, r in reads.items():
                    med = statistics.median(r)
                    print(f"{mode} B={B:6d} {path}: median {med:.4f} ms/block "
                          f"({100 * (med / base - 1):+.1f} % vs the tree), "
                          f"readings {min(r):.4f}..{max(r):.4f}", flush=True)
                    out.setdefault(mode, {})[f"{path} B={B}"] = r
                del Ft, c
                torch.cuda.empty_cache()
        res["ab"] = out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated subset of " + ",".join(SECTIONS))
    ap.add_argument("--ab", nargs="+", default=[], metavar="OTHER.cu",
                    help="time the tree's kernels against these sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_measure: no CUDA card\n")
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    cfgs = mode_configs()
    res: dict = {"card": smi}
    if args.ab:
        section_ab(cfgs, dev, res, args.ab)
    run = dict(sweep=section_sweep, fir=section_fir, fleet=section_fleet,
               driver=section_driver, serving=section_serving,
               stream=section_stream)
    for name in filter(None, args.sections.split(",")):
        run[name](cfgs, dev, res)

    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
