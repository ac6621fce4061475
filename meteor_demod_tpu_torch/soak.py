"""Pass-scale soak: >= 1 Gsample (~78 min of 230.4 ksps signal) through span
turbo, and a sequential chained leg, with a mid-run checkpoint replayed
bitwise.

The reference's real workload is an hours-long live loop (main.c:303-329).
Two legs, each with checks on every step:

- span leg: a B = 1 chained demod warmed to lock, then span after span
  through demod/turbo.py span_submit / span_finish, each chained from the
  previous span's exit carry. Every span must converge with every lane
  accepted (P == chunks), stay locked and pass `sanity` (finite leaves,
  phases in range, 0 < p_err < 1000). At the half-way span the exit carry
  is saved (carry_to_numpy's leaves in an .npz), the next span runs, then
  the file is restored and that span re-run: consumed samples, gauges,
  symbol payload and every exit-carry leaf must be bitwise equal. Host RSS
  every 10 spans, sustained Msamples/s. span_submit takes the span from the
  host, so each span is uploaded (the JAX package kept one on the device;
  the port has no such path, ROADMAP list D): the rate includes the copy.
- sequential leg: B = 1 through make_batch_demod, 16 blocks a dispatch on
  blocks that stay on the device, repeated; 0 flags at every 200th
  dispatch and at the end, a sane carry, locked. One program throughout
  (the port has no locked program, list D).

The signal is seam-periodic: a span holds whole symbols and whole carrier
cycles, so one span chains into itself indefinitely.

    python -m meteor_demod_tpu_torch.soak            # on the card, ~1 Gsample
    python -m meteor_demod_tpu_torch.soak --small --device cpu   # ~8 Msample

It prints one JSON line: {"span": {...}, "sequential": {...}, "device": ...}.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .config import DemodConfig
from .demod.backend import make_batch_demod
from .demod.state import CARRY_FIELDS, batch_carry, carry_to_numpy
from .demod.turbo import span_finish, span_submit
from .dsp.fir import iq_to_f32
from .sim import synth_psk
from .utils import select_device

# Sizes: spans of chunks x kb blocks of block_len, nwarm warm-up blocks,
# chain blocks a dispatch in the sequential leg. --small warms longer, as a
# lock at its nearer carrier takes ~0.5 s of signal.
FULL = dict(block_len=8192, span_samples=1 << 30, chunks=128, kb=16,
            seq_samples=1 << 28, nwarm=24, carrier_hz=400.0, chain=16)
SMALL = dict(block_len=2048, span_samples=8 << 20, chunks=8, kb=8,
             seq_samples=4 << 20, nwarm=60, carrier_hz=80.0, chain=16)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def rss_mb() -> int:
    """This process's resident set in MiB (-1 where /proc is missing)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return -1


def sanity(leaves: dict, where: str) -> None:
    """Counter and accumulator checks on one stream's numpy carry leaves:
    every float leaf finite, p_phase in [0, 2 pi], t_phase in [0, 2 pi]
    (to 1e-3), 0 < p_err < 1000."""
    for k, v in leaves.items():
        a = np.asarray(v)
        if a.dtype.kind == "f" and not np.all(np.isfinite(a)):
            raise AssertionError(f"{where}: {k} is not finite")
    p = float(np.asarray(leaves["p_phase"]).reshape(-1)[0])
    t = float(np.asarray(leaves["t_phase"]).reshape(-1)[0])
    e = float(np.asarray(leaves["p_err"]).reshape(-1)[0])
    if not 0.0 <= p < 2 * math.pi + 1e-3:
        raise AssertionError(f"{where}: p_phase {p}")
    if not -1e-3 <= t < 2 * math.pi + 1e-3:
        raise AssertionError(f"{where}: t_phase {t}")
    if not 0.0 < e < 1000.0:
        raise AssertionError(f"{where}: p_err {e}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def seam_carrier(carrier_hz: float, period: int, samplerate: float) -> float:
    """The carrier nearest carrier_hz with a whole number of cycles in
    `period` samples."""
    return round(carrier_hz * period / samplerate) * samplerate / period


def _signal(cfg: DemodConfig, n: int, carrier_hz: float, seed: int
            ) -> np.ndarray:
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=18.0,
                     seed=seed)
    return iq_to_f32(x[:n])


def _run_blocks(fn, carry, blocks: torch.Tensor):
    """blocks (k, 1, L, 2) on the device through fn, one block a call."""
    for b in range(blocks.shape[0]):
        carry, _ = fn(carry, blocks[b])
    return carry


def span_soak(cfg: DemodConfig, target_samples: int, chunks: int, kb: int,
              ckpt_path: str, device=None, nwarm: int = 24,
              carrier_hz: float = 400.0) -> dict:
    """The span leg (see the module docstring): spans covering
    target_samples, at least 3 (the checkpoint and the span after it).
    Raises AssertionError on any failed check."""
    device = select_device(device)
    L = cfg.block_len
    span_n = chunks * kb * L
    check((span_n * int(cfg.symrate)) % int(cfg.samplerate) == 0,
          f"a span of {span_n} samples holds no whole number of symbols")
    n_spans = max(3, -(-target_samples // span_n))
    carrier = seam_carrier(carrier_hz, span_n, cfg.samplerate)
    xf_all = _signal(cfg, nwarm * L + span_n, carrier, seed=9)

    fn = make_batch_demod(cfg, 1, device)
    warm = _run_blocks(fn, batch_carry(cfg, 1, device), torch.as_tensor(
        xf_all[:nwarm * L], device=device).view(nwarm, 1, L, 2))
    c = {k: v[0] for k, v in carry_to_numpy(warm).items()}
    check(int(c["flags"]) == 0, f"warm-up flags {int(c['flags'])}")
    check(int(c["locked"]) == 1, f"not locked after {nwarm} warm-up blocks")
    xf_span = xf_all[nwarm * L:]

    def one_span(carry0):
        p = span_submit(cfg, carry0, xf_span, chunks=chunks, device=device)
        return p, span_finish(cfg, p)

    p, _ = one_span(c)                                    # warm, untimed
    check(p.P == chunks and p.converged,
          f"warm span: {p.P} of {chunks} lanes, converged {p.converged}")

    ck_span = n_spans // 2
    consumed = n_sym = passes_max = 0
    rss0 = rss_mb()
    rss_track = []
    record = None
    t0 = time.perf_counter()
    for s in range(n_spans):
        p, res = one_span(c)
        check(p.converged and p.P == chunks,
              f"span {s}: {p.P} of {chunks} lanes, converged {p.converged}")
        passes_max = max(passes_max, p.passes)
        consumed += p.consumed
        n_sym += len(res.symbols)
        c = p.exit_carry
        sanity(c, f"span {s}")
        check(int(c["locked"]) == 1, f"span {s}: not locked")
        if s == ck_span:
            np.savez(ckpt_path, **c)
        elif s == ck_span + 1:
            record = (len(res.symbols), p.consumed, p.K.copy(),
                      hashlib.sha256(res.symbols.tobytes()).hexdigest(),
                      {k: np.array(v) for k, v in c.items()})
        if s % 10 == 0:
            rss_track.append(rss_mb())
    wall = time.perf_counter() - t0

    # The checkpoint restored and the span after it re-run: bitwise.
    with np.load(ckpt_path) as z:
        restored = {k: z[k] for k in CARRY_FIELDS}
    p2, res2 = one_span(restored)
    n2, cons2, K2, h2, exit2 = record
    check(p2.consumed == cons2, f"replay consumed {p2.consumed} != {cons2}")
    check(len(res2.symbols) == n2, f"replay {len(res2.symbols)} symbols != "
          f"{n2}")
    check(np.array_equal(p2.K, K2), "replay gauges differ")
    check(hashlib.sha256(res2.symbols.tobytes()).hexdigest() == h2,
          "replay symbol payload differs")
    for k in CARRY_FIELDS:
        check(np.array_equal(np.asarray(p2.exit_carry[k]), exit2[k]),
              f"replay exit carry {k} differs")
    return dict(samples=int(consumed), symbols=int(n_sym), spans=n_spans,
                span_samples=span_n, chunks=chunks, kb=kb,
                passes_max=int(passes_max),
                msamples_per_s=consumed / wall / 1e6, wall_s=wall,
                signal_minutes=consumed / cfg.samplerate / 60,
                rss_start_mb=rss0, rss_track_mb=rss_track,
                rss_end_mb=rss_mb(), checkpoint_span=ck_span,
                replay_bitwise=True,
                note="each span uploaded from the host (span_submit has "
                     "no device-resident span)")


def sequential_soak(cfg: DemodConfig, target_samples: int, device=None,
                    carrier_hz: float = 400.0, chain: int = 16) -> dict:
    """The sequential leg (see the module docstring)."""
    device = select_device(device)
    L = cfg.block_len
    span = chain * L
    carrier = seam_carrier(carrier_hz, span, cfg.samplerate)
    blocks = torch.as_tensor(_signal(cfg, span, carrier, seed=11),
                             device=device).view(chain, 1, L, 2)
    fn = make_batch_demod(cfg, 1, device)
    carry = _run_blocks(fn, batch_carry(cfg, 1, device), blocks)
    check(int(carry.flags[0]) == 0, "warm-up dispatch flagged")
    n_disp = max(2, -(-target_samples // span))
    t0 = time.perf_counter()
    for d in range(n_disp):
        carry = _run_blocks(fn, carry, blocks)
        if d % 200 == 199:
            check(int(carry.flags[0]) == 0, f"dispatch {d} flagged")
    check(int(carry.flags[0]) == 0, "flags at the end")
    wall = time.perf_counter() - t0
    c = {k: v[0] for k, v in carry_to_numpy(carry).items()}
    sanity(c, "sequential end")
    check(int(c["locked"]) == 1, "sequential leg not locked at the end")
    return dict(samples=n_disp * span, dispatches=n_disp, chain=chain,
                msamples_per_s=n_disp * span / wall / 1e6, wall_s=wall,
                note="one program (no locked geometry in the port)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m meteor_demod_tpu_torch.soak",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="2048-sample blocks, 8 lanes x 8 blocks, ~8 "
                         "Msamples of spans and ~4 sequential")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    args = ap.parse_args(argv)
    size = dict(SMALL if args.small else FULL)
    device = select_device(args.device)
    cfg = DemodConfig(samplerate=230400, block_len=size["block_len"])
    with tempfile.TemporaryDirectory() as tmp:
        span = span_soak(cfg, size["span_samples"], size["chunks"],
                         size["kb"],
                         os.path.join(tmp, "soak_carry.npz"), device,
                         nwarm=size["nwarm"], carrier_hz=size["carrier_hz"])
    log(f"span leg: {span}")
    seq = sequential_soak(cfg, size["seq_samples"], device,
                          carrier_hz=size["carrier_hz"], chain=size["chain"])
    log(f"sequential leg: {seq}")
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"span": span, "sequential": seq,
                      "device": str(device), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
