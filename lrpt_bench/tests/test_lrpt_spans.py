"""The readers of the program's spans and call records
(layer_metrics/_spans.py and the fleet.idle_*, pass.idle_*,
pass.sequential_pct and pass.turbo_passes readers) on synthetic traces: the
stage readers and the unattributed one add up to the host readers, nested
spans count once, the counter readers take the window's records, and a
program without spans or records gives None."""

import numpy as np
import pytest

from lrpt_bench import run as R
from lrpt_bench.trace import Trace

FLEET = ["fleet.idle_upload_ms", "fleet.idle_launch_ms",
         "fleet.idle_readback_ms"]
PASS = ["pass.idle_ingest_s", "pass.idle_fixpoint_s", "pass.idle_assemble_s",
        "pass.idle_sequential_s", "pass.idle_output_s"]


def _trace(dev, host) -> Trace:
    """A Trace of device intervals [(s, e)] and host operations
    [(s, e, name)], as Trace.__init__ files them."""
    tr = Trace.__new__(Trace)
    tr.dev = np.array(dev, float).reshape(-1, 2)
    tr.dev_names = ["k"] * len(dev)
    tr.dev_layer = np.array(["other"] * len(dev), dtype=object)
    host = sorted(host)
    tr.host_iv = np.array([h[:2] for h in host], float).reshape(-1, 2)
    tr.host_names = [h[2] for h in host]
    tr.spans = []
    return tr


def _ctx(tr, calls):
    return dict(trace=tr, calls=calls, window={}, run=None, state=None)


def _read(name, ctx):
    return R.load_reader(name)(ctx)


def _fleet_chain(t0):
    """One chain at t0: 10 s wall; upload 0-2 (busy 1-1.5), launch 2-3,
    readback 3-8 (busy 3-7), recover 8-9; the device busy 1-1.5, 2.5-7,
    9.5-9.8."""
    dev = [(t0 + a, t0 + b) for a, b in ((1, 1.5), (2.5, 7), (9.5, 9.8))]
    host = [(t0 + a, t0 + b, "meteor." + n) for a, b, n in (
        (0, 9.9, "fleet.process_blocks"), (0, 2, "fleet.upload"),
        (2, 3, "fleet.launch"), (3, 8, "fleet.readback"),
        (8, 9, "fleet.recover"))] + [(t0 + 3.2, t0 + 3.4, "aten::copy_")]
    return dev, host


def test_fleet_stages_add_up_to_host_ms():
    dev, host = [], []
    for t0 in (0.0, 20.0):
        d, h = _fleet_chain(t0)
        dev += d
        host += h
    ctx = _ctx(_trace(dev, host), [(0.0, 10.0), (20.0, 30.0)])
    got = {n: _read(n, ctx) for n in FLEET}
    assert got == pytest.approx({"fleet.idle_upload_ms": 1500.0,
                                 "fleet.idle_launch_ms": 500.0,
                                 "fleet.idle_readback_ms": 1000.0})
    rest = _read("fleet.idle_unattributed_ms", ctx)
    assert rest == pytest.approx(1700.0)
    host_ms = _read("fleet.host_ms", ctx)
    assert sum(got.values()) + rest == pytest.approx(host_ms, rel=1e-9)


def test_pass_stages_add_up_and_nested_spans_count_once():
    """turbo.sequential holds its stream.* children and a second
    turbo.sequential nested in it: its idle time is counted once."""
    dev = [(1.0, 2.0), (4.0, 6.0), (11.0, 12.0)]
    host = [(0.0, 20.0, "meteor.cli.main"), (0.0, 1.0, "meteor.cli.read"),
            (1.0, 2.0, "meteor.cli.decode"),
            (2.0, 3.0, "meteor.turbo.prepare"),
            (3.0, 4.0, "meteor.turbo.warmup"),
            (4.0, 7.0, "meteor.turbo.pass"),
            (7.0, 8.0, "meteor.turbo.assemble"),
            (8.0, 15.0, "meteor.turbo.sequential"),
            (9.0, 14.0, "meteor.turbo.sequential"),
            (9.0, 10.0, "meteor.stream.upload"),
            (10.5, 12.5, "meteor.stream.fetch"),
            (15.0, 16.0, "meteor.cli.quantize"),
            (16.0, 17.0, "meteor.cli.write")]
    ctx = _ctx(_trace(dev, host), [(0.0, 20.0)])
    got = {n: _read(n, ctx) for n in PASS}
    assert got == pytest.approx({
        "pass.idle_ingest_s": 1.0, "pass.idle_fixpoint_s": 3.0,
        "pass.idle_assemble_s": 1.0, "pass.idle_sequential_s": 6.0,
        "pass.idle_output_s": 2.0})
    rest = _read("pass.idle_unattributed_s", ctx)
    assert rest == pytest.approx(3.0)
    assert sum(got.values()) + rest == pytest.approx(
        _read("pass.host_s", ctx), rel=1e-9)


def test_spans_are_clipped_to_the_calls():
    """A stage span that reaches outside the traced call counts only its
    part inside it; spans between calls count for none."""
    host = [(-5.0, 2.0, "meteor.fleet.upload"),
            (12.0, 14.0, "meteor.fleet.launch")]
    ctx = _ctx(_trace([(1.0, 1.5)], host), [(0.0, 10.0)])
    assert _read("fleet.idle_upload_ms", ctx) == pytest.approx(1500.0)
    assert _read("fleet.idle_launch_ms", ctx) == 0.0


def test_counter_readers_take_the_windows_records(monkeypatch):
    """The records before the window (the warm-up pass) are left out: the
    readers take the last len(calls)."""
    from meteor_demod_tpu_torch import profiling
    recs = [{"turbo.samples": 100, "turbo.sequential_samples": 100,
             "turbo.passes": 0},
            {"turbo.samples": 100, "turbo.sequential_samples": 40,
             "turbo.passes": 4},
            {"turbo.samples": 100, "turbo.sequential_samples": 20,
             "turbo.passes": 3}]
    monkeypatch.setattr(profiling, "calls", lambda root: list(recs))
    ctx = _ctx(_trace([], []), [(0.0, 1.0), (1.0, 2.0)])
    assert _read("pass.sequential_pct", ctx) == pytest.approx(30.0)
    assert _read("pass.turbo_passes", ctx) == pytest.approx(3.5)
    ctx = _ctx(_trace([], []), [(0.0, 1.0)] * 4)     # more calls than records
    assert _read("pass.sequential_pct", ctx) is None


def test_every_reader_is_none_without_the_programs_spans(monkeypatch):
    """A program that records no meteor. span and keeps no call records
    (an older tree) gives None from every new reader, not 0."""
    from meteor_demod_tpu_torch import profiling
    monkeypatch.delattr(profiling, "calls")
    dev, _ = _fleet_chain(0.0)
    ctx = _ctx(_trace(dev, [(3.2, 3.4, "aten::copy_")]), [(0.0, 10.0)])
    for name in (FLEET + PASS + [
            "fleet.idle_unattributed_ms", "pass.idle_unattributed_s",
            "pass.sequential_pct", "pass.turbo_passes"]):
        assert _read(name, ctx) is None, name
