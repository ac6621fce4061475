"""The fleet: a closed loop of chains through FleetDemodulator.process_blocks.

A fleet reprocessing recordings hands the next chain of blocks to the
driver as soon as the last one returns. The IQ is a loop of whole blocks,
symbols and carrier cycles made on the card from the seed and held on the
host as int16 pairs; chains run on across the loop's seam with no jump.
Set-up builds the fleet, warms it over a fixed span of the loop that is long
enough for the acquisition sweep to reach the band's edges, and prints how
many streams locked. The window then runs chains until `seconds` have
passed, each timed alone. Chains drawn from the seed across the whole
window keep the fleet's state before them, their rows and the next
chain's rows for the check (reference/check_fleet.py).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..gen import signal
from ..reference import check_fleet, oracle, params
from ..reference import fir as ref_fir
from ..trace import span

LEAVES = check_fleet.LEAVES
SPAN = "chain"
# The numbers check() compares, each with its limit under the mix's
# "limits".
NUMBERS = ("mismatches",)
# The mix at a size the CPU runs in a test (tests/small.py).
SMALL = dict(streams=6, chain_blocks=2, loop_blocks=18, warmup_chains=30,
             carrier_hz=[20.0, 150.0], dead_streams=1, check_chains=2,
             exact_blocks=1, untracked_max=0, limits={"mismatches": 4})
# The readings that set the limit on the card (tests/test_lrpt_control.py):
# the window's seconds, and how many seeds run sound, reordered and TF32.
CONTROL = dict(window_s=3.0, seeds=(12, 3, 3))


def _carry_np(fleet) -> dict:
    c = fleet.carry
    return {k: getattr(c, k).detach().cpu().numpy() for k in LEAVES}


def _rows_np(outs) -> dict:
    return {k: np.asarray(getattr(outs, k)) for k in
            ("sym_i", "sym_q", "valid", "locked_once")}


def setup(run) -> dict:
    from meteor_demod_tpu_torch.config import DemodConfig
    from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator

    cfg, mix, dev = run.cfg, run.mix, run.device
    pcfg = DemodConfig(**run.demod_fields())
    L, chain = pcfg.block_len, int(mix["chain_blocks"])
    loop_blocks = int(mix["loop_blocks"])
    if loop_blocks % chain:
        raise ValueError("loop_blocks must be a multiple of chain_blocks")
    x, drawn = signal.fleet_loop(cfg, mix, run.seed, dev)
    host = x.cpu().numpy()
    del x
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    n = int(mix["streams"])
    fleet = FleetDemodulator(pcfg, n, device=dev, chain_blocks=chain,
                             ingest="i16", packed_output=True)
    st = dict(fleet=fleet, host=host, drawn=drawn, chain_len=chain * L,
              loop_len=loop_blocks * L, next=0, kept={})
    rng = np.random.default_rng(run.seed + 1)
    # Where in the window the checked chains fall: fractions of it.
    st["check_frac"] = np.sort(rng.random(int(mix["check_chains"])))
    # Warm-up: the same call as the window, over a fixed span of the loop.
    st["start_carry"] = _carry_np(fleet)
    times = []
    for _ in range(int(mix["warmup_chains"])):
        a = time.perf_counter()
        process(st)
        times.append(time.perf_counter() - a)
    locked = int(fleet.carry.locked.sum())
    print(f"fleet: {locked} of {n} streams locked after "
          f"{mix['warmup_chains']} chains "
          f"({mix['warmup_chains'] * st['chain_len'] / cfg['samplerate']:.2f}"
          f" s of signal); carriers drawn over {mix['carrier_hz']} Hz",
          file=sys.stderr)
    st["locked_after_warmup"] = locked
    # The window's length in chains, from the warm-up's last chains with
    # room to spare, so every drawn chain and the one after it fall in it;
    # the window's first chain is always checked.
    per = float(np.mean(times[-max(1, len(times) // 3):]))
    expect = max(2, int(0.7 * run.seconds / per))
    st["check_at"] = sorted(set(
        [0] + (st["check_frac"] * (expect - 1)).astype(int).tolist()))
    return st


def process(st: dict) -> dict:
    """The next chain of the loop through process_blocks; its rows."""
    off = (st["next"] * st["chain_len"]) % st["loop_len"]
    st["next"] += 1
    blocks = st["host"][:, off:off + st["chain_len"]]
    with span("chain"):
        outs = st["fleet"].process_blocks(blocks)
    return _rows_np(outs)


def window(run, st: dict) -> dict:
    """Chains until `seconds` have passed; every chain's wall time."""
    fleet, n = st["fleet"], st["fleet"].n_streams
    times, samples, symbols = [], 0, 0
    attempted, failed, first = 0, 0, st["next"]
    recovered0 = fleet.recovered_streams
    t0 = time.perf_counter()
    while True:
        i = st["next"] - first
        keep = i in st["check_at"]
        before = _carry_np(fleet) if keep else None
        attempted += 1
        a = time.perf_counter()
        try:
            rows = process(st)
        except Exception as e:               # a chain that raised: counted
            failed += 1
            print(f"fleet: chain {i} raised {e!r}", file=sys.stderr)
            break
        b = time.perf_counter()
        times.append(b - a)
        samples += n * st["chain_len"]
        symbols += int(np.count_nonzero(rows["valid"]))
        if keep:
            st["kept"][i] = dict(index=st["next"] - 1, before=before,
                                 rows=[rows])
        if i - 1 in st["kept"]:
            st["kept"][i - 1]["rows"].append(rows)
        if b - t0 >= run.seconds:
            break
    wall = time.perf_counter() - t0
    return dict(wall_s=wall, chain_s=times, samples=samples, symbols=symbols,
                attempted=attempted, failed=failed,
                recovered_streams=fleet.recovered_streams - recovered0,
                chains=len(times))


def end_to_end(run, st: dict, w: dict) -> dict:
    t = np.array(w["chain_s"]) * 1e3
    h = len(t) // 2
    print(f"fleet: {w['chains']} chains in {w['wall_s']:.3f} s, chain ms "
          f"median {np.median(t):.3f} (halves {np.median(t[:h]):.3f}, "
          f"{np.median(t[h:]):.3f}) p95 {np.percentile(t, 95):.3f} max "
          f"{t.max():.3f}; recovered streams {w['recovered_streams']}",
          file=sys.stderr)
    return {"fleet_msamples_per_s": w["samples"] / w["wall_s"] / 1e6}


def release(st: dict) -> None:
    st.pop("fleet", None)


def check(run, st: dict) -> dict:
    """Replay the kept chains in the reference and count what differs."""
    cfg, mix = run.cfg, run.mix
    cst = params.derive(cfg)
    bank = ref_fir.banks(cfg)
    taps, L = bank.shape[1], cst["block_len"]
    exact = int(mix["exact_blocks"])
    chain = st["chain_len"] // L
    host, loop = st["host"], st["loop_len"]

    def job(k, state):
        off = (k["index"] * st["chain_len"]) % loop
        idx = np.arange(off, off + st["chain_len"] + exact * L) % loop
        tail = np.take(host, np.arange(off - taps + 1, off) % loop, 1)
        return dict(x=np.take(host, idx, axis=1), tail=tail, state=state)

    fire_rate = cfg["symrate"] * (2 if cfg["oqpsk"] else 1)
    carrier = np.where(st["drawn"]["signal"], st["drawn"]["carrier_hz"],
                       np.inf)
    track = lambda state: check_fleet.tracking(state, carrier, fire_rate,
                                               mix["track_hz"])
    n_off = check_fleet.state_off(st["start_carry"], cst)
    total = dict(bytes=0, decisions=0, count=0, lanes_exact=0, lanes_held=0,
                 symbols=0, untracked=0)
    window = list(st["kept"].values())
    res = check_fleet.replay(cst, bank, [job(k, k["before"]) for k in window],
                             chain + exact, run.device)
    for k, (ref, locked, after) in zip(window, res):
        # A chain with no successor in the window is compared to its own
        # end.
        upto = min(chain + exact, chain * len(k["rows"]))
        start = track(k["before"])
        d = check_fleet.compare(k["rows"], [r[:upto] for r in ref],
                                locked[:upto], exact, start,
                                start & track(after))
        # Live streams that do not track their carrier: the sweep's dead
        # zone holds a few; more is a fleet that fails to acquire.
        d["untracked"] = max(0, int(np.count_nonzero(
            st["drawn"]["signal"] & ~start)) - int(mix["untracked_max"]))
        print(f"check fleet chain {k['index']}: {d}", file=sys.stderr)
        for key in total:
            total[key] += d[key]
    total.update(start_state=n_off, chains=len(window))
    print(f"check fleet: {total}", file=sys.stderr)
    per_lane = 2 * exact * int(L * cfg["symrate"] / cfg["samplerate"])
    off = (total["bytes"] + total["decisions"] + 2 * total["count"]
           + n_off + per_lane * total["untracked"])
    return {"numbers": {"mismatches": (off, run.limit("mismatches"))},
            "detail": total}
