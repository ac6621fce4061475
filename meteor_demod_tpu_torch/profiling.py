"""Profiling hooks (the reference has none; these expose torch.profiler).

Set METEOR_DEMOD_PROFILE=<dir> to capture a torch.profiler trace of a CLI run
(CPU and, on a card, CUDA activities) as a Chrome trace file in <dir>; open it
in chrome://tracing or Perfetto. Library users can wrap any region:

    with maybe_trace():            # env-gated
        demod.process(samples)

    with trace("/tmp/trace"):      # explicit
        ...
"""

from __future__ import annotations

import contextlib
import os
import time

PROFILE_ENV = "METEOR_DEMOD_PROFILE"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region and write <log_dir>/meteor_demod_<pid>_<ms>.json
    when it ends (also when it raises)."""
    import torch
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
