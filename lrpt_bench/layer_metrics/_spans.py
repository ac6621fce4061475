"""The program's own spans and call records, for the per-layer readers of
its host stages.

The program marks its stages with torch.profiler ranges named "meteor." +
stage (meteor_demod_tpu_torch/profiling.py span), which the trace keeps
among its host operations; it keeps the changes of its counters over each
CLI run in profiling.calls("cli.main"). A program that records neither (an
older tree) gives these readers nothing: they return None.

A stage's idle time in a call is the length of the union of its spans,
clipped to the call, less the union of device intervals over it. The
stages of one cell do not overlap, so the stage readers and the
unattributed reader add up to the call's wall time less its device time:
fleet.host_ms and pass.host_s.
"""

from __future__ import annotations

import numpy as np

from lrpt_bench.trace import clip, merged

PREFIX = "meteor."
FLEET_STAGES = ("fleet.upload", "fleet.launch", "fleet.readback")
PASS_STAGES = {
    "ingest": ("cli.read", "cli.decode"),
    "fixpoint": ("turbo.prepare", "turbo.warmup", "turbo.pass"),
    "assemble": ("turbo.assemble",),
    "sequential": ("turbo.sequential",),
    "output": ("cli.quantize", "cli.write"),
}


class _Busy:
    """Device time in any [s, e] from the merged device intervals: the
    busy time before t is a prefix sum, looked up by bisection."""

    def __init__(self, dev: np.ndarray):
        m = merged(dev)
        self.starts, self.ends = m[:, 0], m[:, 1]
        self.before = np.concatenate([[0.0], np.cumsum(m[:, 1] - m[:, 0])])

    def upto(self, t: np.ndarray) -> np.ndarray:
        if not len(self.starts):
            return np.zeros_like(t)
        j = np.searchsorted(self.starts, t, side="right") - 1
        jj = np.maximum(j, 0)
        inside = np.clip(t - self.starts[jj], 0.0,
                         self.ends[jj] - self.starts[jj])
        return np.where(j >= 0, self.before[jj] + inside, 0.0)

    def over(self, iv: np.ndarray) -> float:
        if not len(iv):
            return 0.0
        return float((self.upto(iv[:, 1]) - self.upto(iv[:, 0])).sum())


def _state(ctx) -> dict | None:
    """The program's spans by stage name and the device lookup, made once
    a trace (kept in ctx); None when the trace holds no program span."""
    if "_program_spans" not in ctx:
        tr = ctx["trace"]
        by = {}
        for (s, e), n in zip(tr.host_iv, tr.host_names):
            if n.startswith(PREFIX):
                by.setdefault(n[len(PREFIX):], []).append((s, e))
        ctx["_program_spans"] = None if not by else dict(
            spans={k: np.array(v, float) for k, v in by.items()},
            busy=_Busy(tr.dev))
    return ctx["_program_spans"]


def _idle(st: dict, names, lo: float, hi: float) -> float:
    parts = [st["spans"][n] for n in names if n in st["spans"]]
    if not parts:
        return 0.0
    iv = merged(clip(np.concatenate(parts), lo, hi))
    if not len(iv):
        return 0.0
    return float((iv[:, 1] - iv[:, 0]).sum()) - st["busy"].over(iv)


def stage_idle(ctx, names) -> float | None:
    """Mean over the traced calls of the card's idle seconds inside the
    union of the spans `names`."""
    st = _state(ctx)
    if st is None or not ctx["calls"]:
        return None
    return float(np.mean([_idle(st, names, lo, hi)
                          for lo, hi in ctx["calls"]]))


def unattributed_idle(ctx, stages) -> float | None:
    """Mean over the traced calls of the card's idle seconds in none of
    the spans `stages`: each call's wall time less its device time less
    the idle time inside the stages' union."""
    st = _state(ctx)
    if st is None or not ctx["calls"]:
        return None
    out = []
    for lo, hi in ctx["calls"]:
        call = np.array([[lo, hi]])
        out.append(hi - lo - st["busy"].over(call)
                   - _idle(st, stages, lo, hi))
    return float(np.mean(out))


def call_records(ctx, root: str = "cli.main") -> list | None:
    """The program's counter records of the traced calls: the last
    len(ctx["calls"]) of profiling.calls(root), one a call of the window;
    None when the program keeps no such records."""
    try:
        from meteor_demod_tpu_torch import profiling
    except ImportError:
        return None
    calls = getattr(profiling, "calls", None)
    n = len(ctx["calls"])
    if calls is None or n == 0:
        return None
    recs = calls(root)
    return recs[-n:] if len(recs) >= n else None
