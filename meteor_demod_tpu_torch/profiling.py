"""Profiling hooks (the reference has none; these expose torch.profiler).

Set METEOR_DEMOD_PROFILE=<dir> to capture a torch.profiler trace of a CLI run
(CPU and, on a card, CUDA activities) as a Chrome trace file in <dir>; open it
in chrome://tracing or Perfetto. Library users can wrap any region:

    with maybe_trace():            # env-gated
        demod.process(samples)

    with trace("/tmp/trace"):      # explicit
        ...

Spans. The demodulator marks its stages with span(name): a
torch.profiler.record_function range named "meteor." + name, on the same
timeline as the card's kernels and copies, so an idle gap of the card lies
inside the span of the host stage that caused it. A span is recorded only
while a profiler records on the calling thread; otherwise it costs one check
of the profiler's state. Spans never wait for the card or copy anything, so
the output is the same with a profiler on or off.

Counters. count(name, n) adds to process-wide totals; call(root) spans one
call of an entry point and, when it ends, appends the counters' changes over
the call to a ring of the last CALLS_KEPT calls of that root: calls(root).
The CLI's counters are those of turbo (demod/turbo.py): turbo.samples,
turbo.sequential_samples, turbo.passes, turbo.resumes,
turbo.resumed_samples.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
from torch.autograd import _profiler_enabled

PROFILE_ENV = "METEOR_DEMOD_PROFILE"
SPAN_PREFIX = "meteor."
CALLS_KEPT = 4096

_counters: dict[str, int] = {}
_calls: dict[str, collections.deque] = {}


class _Off:
    """The span of a thread no profiler records on: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """`with span("fleet.upload"):` records a "meteor.fleet.upload" range
    when a profiler is recording on this thread; otherwise it is one check
    of the profiler's state and a shared context that does nothing."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add n to the process-wide counter `name`."""
    _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the process-wide counters."""
    return dict(_counters)


def calls(root: str) -> list:
    """The counters' changes over each of the last CALLS_KEPT calls of
    `root` (call(root)), oldest first: one dict a call."""
    return list(_calls.get(root, ()))


@contextlib.contextmanager
def call(root: str):
    """One call of an entry point: span(root) around it, and the counters'
    changes over it appended to calls(root) when it ends, also when it
    raises."""
    before = dict(_counters)
    try:
        with span(root):
            yield
    finally:
        ring = _calls.setdefault(root, collections.deque(maxlen=CALLS_KEPT))
        ring.append({k: v - before.get(k, 0) for k, v in _counters.items()})


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region and write <log_dir>/meteor_demod_<pid>_<ms>.json
    when it ends (also when it raises)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"meteor_demod_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def maybe_trace():
    log_dir = os.environ.get(PROFILE_ENV)
    if not log_dir:
        yield
        return
    with trace(log_dir):
        yield
