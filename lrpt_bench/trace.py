"""Reading a torch.profiler trace of the measured window.

The device side is the union of the intervals in which a kernel or a copy
ran on the card (annotations that mark a span on the card's timeline are no
device work and are left out), so work on several CUDA streams at once is counted once.
Each device operation is put in a layer by the kernel-name map in kernels/
(one JSON file a pattern: {"pattern": <regex>, "layer": <name>}; the
first file in name order whose pattern matches wins). The harness's own
spans (torch.profiler.record_function around each call into the program)
mark the calls; an idle gap of the card is named by the innermost host
operation that runs across its middle.
"""

from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path

import numpy as np
import torch

KERNELS = Path(__file__).resolve().parent / "kernels"
SPAN_PREFIX = "lrpt."


def kernel_map() -> list:
    """[(compiled pattern, layer)] from kernels/*.json, in file-name order."""
    out = []
    for f in sorted(KERNELS.glob("*.json")):
        d = json.loads(f.read_text())
        out.append((re.compile(d["pattern"]), d["layer"]))
    return out


def layer_of(name: str, kmap: list) -> str:
    for pat, layer in kmap:
        if pat.search(name):
            return layer
    return "other"


@contextlib.contextmanager
def span(name: str):
    """A span of the harness around one call into the program."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def union_length(iv: np.ndarray) -> float:
    """Total length of the union of intervals iv (n, 2)."""
    if not len(iv):
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    total, cs, ce = 0.0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > ce:
            total += ce - cs
            cs, ce = s, e
        elif e > ce:
            ce = e
    return total + ce - cs


def merged(iv: np.ndarray) -> np.ndarray:
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s > out[-1][1]:
            out.append([s, e])
        elif e > out[-1][1]:
            out[-1][1] = e
    return np.array(out)


def clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    c = np.stack([np.maximum(iv[:, 0], lo), np.minimum(iv[:, 1], hi)], 1)
    return c[c[:, 1] > c[:, 0]]


def _raw_events(prof) -> list:
    """(start s, end s, name, on the card, a span annotation) of every
    event, from the profiler's raw results (no event tree is built)."""
    out = []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            s, e = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        else:
            s = ev.start_us() * 1e-6
            e = s + ev.duration_us() * 1e-6
        name = ev.name()
        note = name.startswith(SPAN_PREFIX) or (
            hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
        out.append((s, e, name, ev.device_type() == cuda, note))
    return out


class Trace:
    """The events of one profiled window, in seconds on the profiler's
    clock: device operations with their layers, the harness's spans and
    the host operations."""

    def __init__(self, prof):
        kmap = kernel_map()
        layers = {}
        dev, host, spans = [], [], []
        for s, e, name, on_card, note in _raw_events(prof):
            if on_card and not note:
                dev.append((s, e, name))
            elif name.startswith(SPAN_PREFIX) and not on_card:
                spans.append((s, e, name[len(SPAN_PREFIX):]))
            elif not on_card:
                host.append((s, e, name))
        self.dev_names = [d[2] for d in dev]
        self.dev = np.array([d[:2] for d in dev], float).reshape(-1, 2)
        for n in set(self.dev_names):
            layers[n] = layer_of(n, kmap)
        self.dev_layer = np.array([layers[n] for n in self.dev_names],
                                  dtype=object)
        host.sort()
        self.host_iv = np.array([h[:2] for h in host], float).reshape(-1, 2)
        self.host_names = [h[2] for h in host]
        self.spans = sorted(spans)

    def calls(self, name: str) -> list:
        return [(s, e) for s, e, n in self.spans if n == name]

    def device_in(self, lo: float, hi: float, layer: str | None = None
                  ) -> float:
        """Union of device time inside [lo, hi], of one layer or all."""
        iv = self.dev if layer is None else self.dev[self.dev_layer == layer]
        return union_length(clip(iv, lo, hi)) if len(iv) else 0.0

    def breakdown(self, lo: float, hi: float, top: int = 10) -> dict:
        """The device operations that took most time (summed by name), and
        the card's idle time inside [lo, hi] by the innermost host
        operation running across each gap's middle."""
        inside = (self.dev[:, 1] > lo) & (self.dev[:, 0] < hi)
        by_name = {}
        for (s, e), n in zip(self.dev[inside], np.array(
                self.dev_names, dtype=object)[inside]):
            by_name[n] = by_name.get(n, 0.0) + (min(e, hi) - max(s, lo))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged(clip(self.dev, lo, hi))
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        by_host = {}
        starts, ends = self.host_iv[:, 0], self.host_iv[:, 1]
        for s, e in gaps:
            name = self._innermost((s + e) / 2, starts, ends)
            if name is None:
                name = f"python in {self._span_at((s + e) / 2)}"
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        gaps_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, float(v)] for n, v in ops],
                "idle_gaps": [[n, float(v)] for n, v in gaps_top]}

    def _innermost(self, t: float, starts, ends, scan: int = 4096) -> str:
        """The host operation with the latest start that still runs at t
        (host operations nest, so that is the innermost)."""
        i = int(np.searchsorted(starts, t, side="right")) - 1
        for j in range(i, max(-1, i - scan), -1):
            if ends[j] >= t:
                return self.host_names[j]
        return None

    def _span_at(self, t: float) -> str:
        for s, e, n in self.spans:
            if s <= t <= e:
                return SPAN_PREFIX + n
        return "no span"
