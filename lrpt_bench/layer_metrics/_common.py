"""Arithmetic the per-layer readers share: device time inside the calls."""

from __future__ import annotations

import numpy as np


def per_call(ctx, layer=None) -> np.ndarray:
    """Device seconds (union) inside each traced call, of one layer or all."""
    tr = ctx["trace"]
    return np.array([tr.device_in(s, e, layer) for s, e in ctx["calls"]])


def walls(ctx) -> np.ndarray:
    return np.array([e - s for s, e in ctx["calls"]])


def idle_pct(ctx) -> float | None:
    lo, hi = ctx["calls"][0][0], ctx["calls"][-1][1]
    if hi <= lo:
        return None
    return 100.0 * (1.0 - ctx["trace"].device_in(lo, hi) / (hi - lo))


def roofline_pct(ctx, work: dict) -> float | None:
    from lrpt_bench.work.demod import least_seconds
    busy = per_call(ctx).sum()
    if busy <= 0:
        return None
    t, side = least_seconds(work)
    import sys
    print(f"roofline: least {t * 1e3:.4f} ms by {side} over "
          f"{busy * 1e3:.3f} ms of device time", file=sys.stderr)
    return 100.0 * t / busy
