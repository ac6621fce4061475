"""A recorded pass through the CLI's -T 0, one pass after another.

Set-up makes the pass on the card from the seed (an overhead Meteor-M
pass's Doppler, a seeded phase, the mix's SNR), writes it once as a 16-bit
WAV under TMPDIR, and runs one whole CLI pass to build and warm everything.
Each pass of the window is meteor_demod_tpu_torch.cli.main with -T 0, in
this process, from the WAV on disk to the .s on disk; the next pass
overwrites the .s. The window ends at the first pass boundary after
`seconds`.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..gen import signal
from ..reference import check_pass, params
from ..reference import fir as ref_fir
from ..reference.params import RING_SYMBOLS
from ..trace import span

SPAN = "pass"
GROUP_DELAY = 32.4     # samples from a tick's input to its signal time
FILE_BUFFER_BYTES = 32768


def _argv(run, st) -> list:
    mode = (["-m", "oqpsk", "-r", str(int(run.cfg["symrate"]))]
            if run.cfg["oqpsk"] else [])
    return ["meteor_demod_tpu_torch", "-B", "-q", "-T", "0", *mode,
            "-o", st["out"], st["wav"]]


def _one_pass(run, st) -> int:
    from meteor_demod_tpu_torch import cli
    with span(SPAN):
        rc = cli.main(_argv(run, st))
    return rc


def setup(run) -> dict:
    cfg, mix, dev = run.cfg, run.mix, run.device
    fs, L = int(cfg["samplerate"]), int(cfg["block_len"])
    n = int(round(mix["seconds"] * fs)) // L * L
    x, meta = signal.pass_samples(cfg, mix, run.seed, dev, n_samples=n)
    host = x.cpu().numpy()
    del x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="lrpt_bench_")
    st = dict(host=host, meta=meta, tmp=tmp,
              wav=os.path.join(tmp, "pass.wav"),
              out=os.path.join(tmp, "pass.s"))
    signal.write_wav(st["wav"], host, fs)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if run.warm:
        rc = _one_pass(run, st)
        if rc != 0:
            raise RuntimeError(f"the warm-up pass exited {rc}")
        print(f"pass: {n} samples ({n / fs:.1f} s), WAV "
              f"{os.path.getsize(st['wav'])} bytes, warm-up .s "
              f"{os.path.getsize(st['out'])} bytes", file=sys.stderr)
    return st


def window(run, st: dict) -> dict:
    times, sizes, attempted, failed = [], [], 0, 0
    t0 = time.perf_counter()
    while True:
        attempted += 1
        a = time.perf_counter()
        try:
            rc = _one_pass(run, st)
        except Exception as e:                # a pass that raised: counted
            print(f"pass: raised {e!r}", file=sys.stderr)
            rc = -1
        b = time.perf_counter()
        size = os.path.getsize(st["out"]) if os.path.exists(st["out"]) else 0
        if rc != 0 or size == 0:
            failed += 1
        else:
            times.append(b - a)
            sizes.append(size)
        if b - t0 >= run.seconds or rc != 0:
            break
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, pass_s=times, attempted=attempted,
                failed=failed, passes=len(times),
                samples=len(st["host"]) * len(times),
                symbols=sum(sizes) // 2, sizes=sizes)


def end_to_end(run, st: dict, w: dict) -> dict:
    t = np.array(w["pass_s"])
    print(f"pass: {w['passes']} passes in {w['wall_s']:.3f} s, each "
          f"{', '.join(f'{v:.3f}' for v in t)} s; .s sizes "
          f"{sorted(set(w['sizes']))}", file=sys.stderr)
    return {"pass_s": w["wall_s"] / max(1, w["passes"])}


def release(st: dict) -> None:
    pass


def _informed(run, st, starts: list) -> list:
    """Each lane's state worked out from the traffic at its first block."""
    cfg, mix = run.cfg, run.mix
    fs, L, host = float(cfg["samplerate"]), int(cfg["block_len"]), st["host"]
    infos = []
    for s in starts:
        t0 = s * L - GROUP_DELAY
        xb = host[s * L:(s + 1) * L].astype(np.float64)
        rms = math.sqrt(float(np.mean(xb[:, 0] ** 2 + xb[:, 1] ** 2)))
        # The AGC starts near its target: the matched filter's gain is
        # about 0.4; the loop settles within tens of symbols from there.
        infos.append(dict(
            phase=signal.pass_phase_at(t0, fs, mix, st["meta"]["phase0"]),
            freq_hz=signal.pass_doppler_hz(t0, fs, mix["f_center_hz"],
                                           mix["altitude_km"],
                                           mix["t_ca_s"]),
            u0=t0 * cfg["symrate"] / fs, gain=190.0 / (rms * 0.4)))
    return infos


def check(run, st: dict) -> dict:
    cfg, mix = run.cfg, run.mix
    fs, L = float(cfg["samplerate"]), int(cfg["block_len"])
    oqpsk = bool(cfg["oqpsk"])
    cst = params.derive(cfg)
    bank = ref_fir.banks(cfg)
    host = st["host"]
    prog = (np.fromfile(st["out"], dtype=np.int8) if os.path.exists(st["out"])
            else np.zeros(0, np.int8))
    prog = prog[:len(prog) // 2 * 2].reshape(-1, 2)
    total = len(host) // L
    W, S = int(mix["segment_warmup_blocks"]), int(mix["segment_blocks"])
    per_block = L * cfg["symrate"] / fs
    drift = int(mix["drift_symbols"])
    fire_rate = cfg["symrate"] * (2 if oqpsk else 1)

    def tracking(ref, b):
        dop = signal.pass_doppler_hz((b + 1) * L, fs, mix["f_center_hz"],
                                     mix["altitude_km"], mix["t_ca_s"])
        f = float(ref["p_freq"][0]) * fire_rate / (2 * math.pi)
        return bool(ref["locked"][0]) and abs(f - dop) < mix["track_hz"]

    start = check_pass.start_lane(cst, bank, host, run.device, tracking,
                                  int(mix["settle_blocks"]),
                                  int(mix["start_max_blocks"]))
    E, r0 = start["end"], start["first_ring"]
    written_before_E = start["counts"].sum() - (r0 or 0) * RING_SYMBOLS
    rng = np.random.default_rng(run.seed + 2)
    # Another rounding makes another acquisition: the program's may run
    # longer than the reference's lane, so the segments begin at twice its
    # length; the first right there, the drawn ones after it, the last at
    # the recording's end.
    first = min(2 * E, total - 3 * S - int(mix["check_segments"]))
    drawn = rng.choice(np.arange(first + S, total - 2 * S),
                       int(mix["check_segments"]), replace=False)
    seg = [first] + sorted(drawn.tolist()) + [total - S]
    starts = [s - W for s in seg]
    state = check_pass.informed_state(cst, cfg, _informed(run, st, starts))
    out = check_pass.run_lanes(cst, bank, host, starts, state, W + S,
                               run.device)
    per_seg = 2 * S * int(per_block)
    places, gauges, bytes_d = [], [], []
    seg_off = seg_fail = seg_sym = 0
    found = None
    for i, s in enumerate(seg):
        ref = check_pass.soft_bytes(out[i][W:W + S])
        pred = int(round(written_before_E + (s - E) * per_block))
        # The .s starts at the ring the program's acquisition locked in,
        # some rings from the reference's: the first segment is searched
        # widely, the others near the place it was found at.
        if found is None:
            at, search = pred, int(mix["search_symbols"])
        else:
            at, search = pred + int(round(found)), 4 * drift
        d, tr, agree = (check_pass.align(prog, ref, at, oqpsk, search)
                        if r0 is not None else (None, None, -1.0))
        if d is None or agree < 0.9:
            seg_fail += 1
            places.append(None)
            gauges.append(None)
            continue
        places.append((d / 2 if oqpsk else d) - pred)
        found = places[-1] if found is None else found
        gauges.append((tr, d % 2) if oqpsk else (tr,))
        n_off, mean_d = check_pass.decisions_off(prog, ref, d, tr, oqpsk)
        seg_off += n_off
        bytes_d.append(mean_d)
        seg_sym += len(ref)
    ok = [i for i, g in enumerate(gauges) if g is not None]
    anchor = ok[0] if ok else None
    wrong_gauge = sum(1 for i in ok if gauges[i] != gauges[anchor])
    wrong_place = sum(1 for i in ok
                      if abs(places[i] - places[anchor]) > drift)
    # The length: the CLI reads whole 32 KiB buffers of 4-byte samples
    # (wavfile.c:55); the .s ends with the last symbol of what it read.
    used = len(host) * 4 // FILE_BUFFER_BYTES * FILE_BUFFER_BYTES // 4
    if places[-1] is not None:
        end_at = (total - S) * L
        expect = (places[-1] + written_before_E + (total - S - E)
                  * per_block + (used - end_at) * cfg["symrate"] / fs)
        length_off = max(0, int(abs(len(prog) - expect)) - drift)
    else:
        length_off = per_seg
    detail = dict(start_blocks=E, start_tracked=start["tracked"],
                  first_ring=r0, symbols_written=len(prog),
                  segments=len(seg), segments_failed=seg_fail,
                  segments_off_gauge=wrong_gauge,
                  segments_off_place=wrong_place,
                  segment_decisions_off=seg_off, segment_symbols=seg_sym,
                  place_offsets=sorted(set(round(p) for p in places
                                           if p is not None)),
                  length_off=length_off,
                  segment_mean_abs_byte_diff=(float(np.median(bytes_d))
                                              if bytes_d else None))
    print(f"check pass: {detail}", file=sys.stderr)
    mismatches = (seg_off + length_off
                  + (seg_fail + wrong_gauge + wrong_place) * per_seg)
    shutil.rmtree(st["tmp"], ignore_errors=True)
    return {"numbers": {"mismatches": (mismatches, run.limit("mismatches"))},
            "detail": detail}
