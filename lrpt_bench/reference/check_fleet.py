"""The fleet's reference run and its comparison with the program's rows.

The demodulator carries every rounding forward: a float32 filter that sums
in another order moves the soft symbols of a stream that tracks its
carrier by a byte here and there within a few blocks, and the whole
trajectory of one that sweeps, or sits in a marginal lock short of its
carrier. So the comparison reads each quantity where any sound float32
program agrees with the reference, each drawn chain replayed from the
program's carry before it:

- every soft byte and lock flag of the chain's first `exact_blocks` blocks,
  for each stream that tracks its carrier (locked, its loop's frequency
  within `track_hz` of the carrier the traffic drew) at the chain's start;
- every hard decision over the rest of the chain and the first
  `exact_blocks` of the next (the handoff through the carry and the
  filter's delay line), and the symbol count, for each stream that also
  stays locked throughout and tracks at the end;
- the fleet's initial state, leaf by leaf.

The reference's filter is float64 rounded once to float32 (fir.py), so its
ticks do not depend on the program's filter or batch shape.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fir, oracle
from .quantize import quantize

LEAVES = oracle.FLOAT_LEAVES + oracle.INT_LEAVES


def replay(cst: dict, bank: np.ndarray, jobs: list, n_blocks: int,
           device) -> list:
    """jobs: [dict(x=(streams, >= n_blocks*L, 2) int16 host samples from
    the state's point on, tail=(streams, taps-1, 2) the samples before
    them, state=dict of (streams,) leaves)]. All jobs run as one vector of
    lanes, block by block. Returns per job (per lane a list of (re, im,
    locked_once) per block, the `locked` flag of each lane after each
    block as (blocks, streams), the state after the last block)."""
    L = cst["block_len"]
    state = {k: np.concatenate([np.asarray(j["state"][k]) for j in jobs])
             for k in LEAVES}
    sizes = [len(j["x"]) for j in jobs]
    lanes = sum(sizes)
    out = [[] for _ in range(lanes)]
    locked = []
    x = np.concatenate([j["x"][:, :n_blocks * L] for j in jobs])
    tail = torch.as_tensor(np.concatenate([j["tail"] for j in jobs])
                           .astype(np.float32), device=device)
    for b in range(n_blocks):
        xb = torch.as_tensor(x[:, b * L:(b + 1) * L], device=device).float()
        ticks = fir.fir_block(xb, tail, bank)
        tail = torch.cat([tail, xb], 1)[:, -(bank.shape[1] - 1):]
        re, im, lo, cnt = oracle.run_block(cst, state, ticks)
        for i in range(lanes):
            out[i].append((re[i, :cnt[i]], im[i, :cnt[i]], lo[i, :cnt[i]]))
        locked.append(state["locked"].copy())
    locked = np.stack(locked)
    res, at = [], 0
    for n in sizes:
        res.append((out[at:at + n], locked[:, at:at + n],
                    {k: v[at:at + n] for k, v in state.items()}))
        at += n
    return res


def _lane_bytes(blocks: list) -> tuple:
    re = np.concatenate([b[0] for b in blocks])
    im = np.concatenate([b[1] for b in blocks])
    lo = np.concatenate([b[2] for b in blocks])
    return np.stack([quantize(re), quantize(im)], 1), lo != 0


def _prog_lane(rows: dict, lane: int) -> tuple:
    v = rows["valid"][lane] != 0
    return (np.stack([rows["sym_i"][lane][v], rows["sym_q"][lane][v]], 1),
            rows["locked_once"][lane][v] != 0)


def _decisions_off(a: np.ndarray, b: np.ndarray) -> int:
    """Hard decisions that differ (a byte of 0 has no decision)."""
    sa, sb = np.sign(a.astype(np.int32)), np.sign(b.astype(np.int32))
    return int(np.count_nonzero((sa != sb) & (sa != 0) & (sb != 0)))


def tracking(state: dict, carrier_hz: np.ndarray, fire_rate: float,
             track_hz: float) -> np.ndarray:
    """Streams locked with the loop's frequency within track_hz of their
    carrier."""
    f = np.asarray(state["p_freq"], np.float64) * fire_rate / (2 * np.pi)
    return ((np.asarray(state["locked"]) != 0)
            & (np.abs(f - carrier_hz) < track_hz))


def compare(segs: list, ref: list, ref_locked: np.ndarray, exact: int,
            at_start: np.ndarray, held: np.ndarray) -> dict:
    """segs: the program's rows after the known state, one PackedOutput
    dict (numpy leaves) a chain in order; ref: replay's lanes for this
    job; at_start: the streams compared byte by byte in the first `exact`
    blocks; held: those compared by decisions after them. Counts what
    differs."""
    d = dict(bytes=0, decisions=0, count=0, lanes_exact=0, lanes_held=0,
             symbols=0)
    held = held & ref_locked.all(axis=0)
    for lane, blks in enumerate(ref):
        if not at_start[lane]:
            continue
        parts = [_prog_lane(r, lane) for r in segs]
        p_b = np.concatenate([p[0] for p in parts])
        p_lo = np.concatenate([p[1] for p in parts])
        r_b, r_lo = _lane_bytes(blks[:exact])
        n = len(r_b)
        m = min(n, len(p_b))
        d["bytes"] += int(np.count_nonzero(p_b[:m] != r_b[:m])
                          + np.count_nonzero(p_lo[:m] != r_lo[:m]))
        d["bytes"] += 2 * (n - m)
        d["symbols"] += n
        d["lanes_exact"] += 1
        if not held[lane] or len(blks) <= exact:
            continue
        r_rest, _ = _lane_bytes(blks[exact:])
        p_rest = p_b[n:n + len(r_rest)]
        d["count"] += abs(len(r_rest) - len(p_rest))
        k = min(len(r_rest), len(p_rest))
        d["decisions"] += _decisions_off(p_rest[:k], r_rest[:k])
        d["lanes_held"] += 1
        d["symbols"] += k
    return d


def state_off(carry: dict, cst: dict) -> int:
    """Leaves of the program's carry that differ from the initial state."""
    ref = oracle.initial_state(len(carry["locked"]), cst)
    return sum(int(np.count_nonzero(
        np.asarray(carry[k]).astype(ref[k].dtype) != ref[k])) for k in LEAVES)
