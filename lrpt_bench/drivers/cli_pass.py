"""A recorded pass through the CLI's -T 0, one pass after another.

Set-up makes the pass on the card from the seed (an overhead Meteor-M
pass's Doppler, a seeded phase, the mix's SNR), writes it once as a 16-bit
WAV under TMPDIR, and runs one whole CLI pass to build and warm everything.
Each pass of the window is meteor_demod_tpu_torch.cli.main with -T 0, in
this process, from the WAV on disk to the .s on disk; the next pass
overwrites the .s. The window ends at the first pass boundary after
`seconds`.

The window also keeps, on the card, `replay_blocks` block calls drawn
uniformly from all of the last pass's (turbo's passes and its sequential
path alike): one lane's state, input and output each (_Kept). The check
replays each kept block in the reference from that state and counts the
soft bytes it does not reproduce (`replay_per_mille`).
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from ..gen import signal
from ..reference import check_fleet, check_pass, oracle, params
from ..reference import fir as ref_fir
from ..reference.params import RING_SYMBOLS
from ..reference.quantize import quantize
from ..trace import span

SPAN = "pass"
GROUP_DELAY = 32.4     # samples from a tick's input to its signal time
FILE_BUFFER_BYTES = 32768
REPLAY = "replay_per_mille"
# The numbers check() compares, each with its limit under the mix's
# "limits".
NUMBERS = ("mismatches", REPLAY)
# The mix at a size the CPU runs in a test (tests/small.py).
SMALL = dict(seconds=0.75, t_ca_s=0.0, check_segments=3,
             segment_warmup_blocks=6, segment_blocks=2, settle_blocks=4,
             start_max_blocks=60, replay_blocks=16, replay_min_blocks=4,
             limits={"mismatches": 0,
                     REPLAY: {"qpsk72k": 2.0, "oqpsk80k": 2.0}})
# The readings that set the limit on the card (tests/test_lrpt_control.py):
# the window's seconds (one pass: its warm-up pass is skipped), and how
# many seeds run sound, reordered and TF32.
CONTROL = dict(window_s=1.0, seeds=(12, 3, 3))
# A kept block's leaves, stacked by dtype: one copy a group.
LEAF_GROUPS = (oracle.FLOAT_LEAVES, oracle.INT_LEAVES)
OUT_GROUPS = (("sym_re", "sym_im"), ("valid", "locked_once"))


class _Kept:
    """A stand-in for the program's make_batch_demod through the window
    (where pipeline's sequential path and mesh's fleet step, which turbo's
    passes run, take it from): every demodulator made in a pass keeps, for
    a uniform sample of `n` of all the block calls of the pass (reservoir
    sampling with geometric skips, Li's algorithm L, drawn from `seed`),
    one lane's state, filter delay line, input and output, as clones on
    the card: no copy to the host, no wait, and between kept calls one
    comparison."""

    def __init__(self, n: int, seed: int):
        self.n, self.seed = n, seed
        self.reset()

    def reset(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        self.calls, self.kept, self.w, self.next = 0, [], 1.0, self.n - 1

    def _skip(self) -> None:
        self.w *= math.exp(math.log(1.0 - self.rng.random()) / self.n)
        self.next += int(math.log(1.0 - self.rng.random())
                         / math.log1p(-self.w)) + 1

    def _slot(self):
        i, self.calls = self.calls, self.calls + 1
        if i < self.n:
            self.kept.append(None)
            if i == self.n - 1:
                self._skip()
            return i
        if i < self.next:
            return None
        self._skip()
        return int(self.rng.integers(0, self.n))

    def make(self, orig):
        def make_batch_demod(cfg, batch, *args, **kwargs):
            fn = orig(cfg, batch, *args, **kwargs)

            def demod(carry, x):
                slot = self._slot()
                if slot is None:
                    return fn(carry, x)
                k = int(self.rng.integers(0, batch))
                before = [torch.stack([getattr(carry, n)[k] for n in names])
                          for names in LEAF_GROUPS]
                tail, xin = carry.fir_tail[k].clone(), x[k].clone()
                carry1, outs = fn(carry, x)
                self.kept[slot] = dict(
                    before=before, tail=tail, x=xin,
                    flags=carry1.flags[k].clone(),
                    outs=[torch.stack([getattr(outs, n)[k] for n in names])
                          for names in OUT_GROUPS])
                return carry1, outs
            return demod
        return make_batch_demod


@contextlib.contextmanager
def _keeping(kept: _Kept):
    from meteor_demod_tpu_torch.demod import pipeline
    from meteor_demod_tpu_torch.parallel import mesh
    origs = [(m, m.make_batch_demod) for m in (pipeline, mesh)]
    for m, orig in origs:
        m.make_batch_demod = kept.make(orig)
    try:
        yield
    finally:
        for m, orig in origs:
            m.make_batch_demod = orig


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
              kept=_Kept(int(mix["replay_blocks"]), run.seed + 3),
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
    kept = st["kept"]
    t0 = time.perf_counter()
    while True:
        attempted += 1
        kept.reset()                          # the last pass's blocks
        a = time.perf_counter()
        try:
            with _keeping(kept):
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
    """The kept blocks to the host, once the window has closed."""
    def leaves(groups, names):
        return {n: v[None] for g, ns in zip(groups, names)
                for n, v in zip(ns, g.cpu().numpy())}
    st["kept_np"] = [
        dict(before=leaves(b["before"], LEAF_GROUPS),
             tail=b["tail"].cpu().numpy()[None],
             x=b["x"].cpu().numpy()[None],
             flags=int(b["flags"].item()),
             outs=leaves(b["outs"], OUT_GROUPS))
        for b in st["kept"].kept if b is not None]
    st["kept"].reset()


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


def _place(host: np.ndarray, heads: list) -> list:
    """Each head's ((k, 2) float32 samples) first sample in the (n, 2) int16
    recording, or None where the recording does not hold it."""
    h32 = np.ascontiguousarray(host).view(np.int32).reshape(-1)
    ints = []
    for h in heads:
        q = h.astype(np.int16)
        ints.append(np.ascontiguousarray(q).view(np.int32).reshape(-1)
                    if np.array_equal(q, h) else None)
    firsts = np.array([q[0] for q in ints if q is not None], np.int32)
    cand = np.flatnonzero(np.isin(h32, firsts))
    return [None if q is None else next(
        (int(c) for c in cand[h32[cand] == q[0]]
         if np.array_equal(h32[c:c + len(q)], q)), None) for q in ints]


def replay(run, st: dict, cst: dict, bank: np.ndarray) -> tuple:
    """The kept blocks replayed in the reference from the program's state,
    delay line and input at each (the reference's own filter and
    recurrence): per mille of their soft bytes and lock flags that differ
    from the program's output, over the kept blocks whose lane tracks the
    pass's carrier at the place the recording holds its samples (a lane in
    acquisition, or a block not of the recording, is left out, as is one
    the program's safety net flagged, whose output it does not emit).
    Fewer than `replay_min_blocks` compared reads 1000."""
    cfg, mix, host = run.cfg, run.mix, st["host"]
    fs, L = float(cfg["samplerate"]), int(cfg["block_len"])
    fire_rate = cfg["symrate"] * (2 if cfg["oqpsk"] else 1)
    kept = st["kept_np"]
    places = _place(host, [b["x"][0, :16] for b in kept])
    jobs, rows, blocks = [], [], []
    d = dict(kept=len(kept), flagged=0, unplaced=0, untracked=0,
             compared=0, symbols=0, bytes=0)
    for b, at in zip(kept, places):
        if b["flags"] != 0:
            d["flagged"] += 1
            continue
        if at is None:
            d["unplaced"] += 1
            continue
        dop = signal.pass_doppler_hz(at, fs, mix["f_center_hz"],
                                     mix["altitude_km"], mix["t_ca_s"])
        if not check_fleet.tracking(b["before"], np.array([dop]), fire_rate,
                                    mix["track_hz"])[0]:
            d["untracked"] += 1
            continue
        jobs.append(dict(x=b["x"], tail=b["tail"], state=b["before"]))
        blocks.append(at // L)
        o = b["outs"]
        rows.append(dict(sym_i=quantize(o["sym_re"]),
                         sym_q=quantize(o["sym_im"]),
                         valid=o["valid"], locked_once=o["locked_once"]))
    res = (check_fleet.replay(cst, bank, jobs, 1, run.device)
           if jobs else [])
    one = np.ones(1, bool)
    moved = []
    for r, (ref, locked, _) in zip(rows, res):
        c = check_fleet.compare([r], ref, locked, 1, one, ~one)
        d["bytes"] += c["bytes"]
        d["symbols"] += c["symbols"]
        moved.append(c["bytes"])
    d["compared"] = len(jobs)
    # The blocks that moved most: [bytes, the recording's block].
    d["most"] = sorted(([m, b] for m, b in zip(moved, blocks)),
                       reverse=True)[:3]
    d["median_bytes"] = float(np.median(moved)) if moved else None
    per_mille = (1000.0 * d["bytes"] / (2 * d["symbols"])
                 if d["compared"] >= int(mix["replay_min_blocks"])
                 and d["symbols"] else 1000.0)
    return per_mille, d


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
    found, first_match, first_search_s = None, None, 0.0
    for i, s in enumerate(seg):
        ref = check_pass.soft_bytes(out[i][W:W + S])
        pred = int(round(written_before_E + (s - E) * per_block))
        # The .s starts at the ring the program's acquisition locked in,
        # which may lie far from the reference's: the first segment is
        # searched over the whole acquisition (check_pass.first_span), the
        # others near the place it was found at.
        if r0 is None:
            d, tr, agree = None, None, -1.0
        elif found is None:
            t = time.perf_counter()
            lo, hi = check_pass.first_span(pred, s, per_block, E,
                                           int(mix["search_symbols"]))
            d, tr, agree = check_pass.search_all(prog, ref, lo, hi, oqpsk)
            first_search_s += time.perf_counter() - t
            first_match = [d, tr, agree]
        else:
            d, tr, agree = check_pass.align(
                prog, ref, pred + int(round(found)), oqpsk, 4 * drift)
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
                  first_match=first_match,
                  first_search_s=round(first_search_s, 3),
                  segments=len(seg), segments_failed=seg_fail,
                  segments_off_gauge=wrong_gauge,
                  segments_off_place=wrong_place,
                  segment_decisions_off=seg_off, segment_symbols=seg_sym,
                  place_offsets=sorted(set(round(p) for p in places
                                           if p is not None)),
                  length_off=length_off,
                  segment_mean_abs_byte_diff=(float(np.median(bytes_d))
                                              if bytes_d else None))
    per_mille, detail["replay"] = replay(run, st, cst, bank)
    print(f"check pass: {detail}", file=sys.stderr)
    mismatches = (seg_off + length_off
                  + (seg_fail + wrong_gauge + wrong_place) * per_seg)
    shutil.rmtree(st["tmp"], ignore_errors=True)
    return {"numbers": {REPLAY: (round(per_mille, 4), run.limit(REPLAY)),
                        "mismatches": (mismatches, run.limit("mismatches"))},
            "detail": detail}
