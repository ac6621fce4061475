"""The pass.turbo_resumes reader on fake call records: the mean of the
window's turbo.resumes counters, the records before the window left out,
and None where the program keeps no records or no such counter (an older
tree, whose records hold turbo's other counters only)."""

import pytest

from lrpt_bench import run as R


def _ctx(calls):
    return dict(trace=None, calls=calls, window={}, run=None, state=None)


def _read(ctx):
    return R.load_reader("pass.turbo_resumes")(ctx)


def test_turbo_resumes_is_the_windows_mean(monkeypatch):
    from meteor_demod_tpu_torch import profiling
    recs = [{"turbo.samples": 100, "turbo.resumes": 5},
            {"turbo.samples": 100, "turbo.resumes": 1},
            {"turbo.samples": 100, "turbo.resumes": 2},
            {"turbo.samples": 100, "turbo.resumes": 0}]
    monkeypatch.setattr(profiling, "calls", lambda root: list(recs))
    assert _read(_ctx([(0.0, 1.0)] * 3)) == pytest.approx(1.0)
    assert _read(_ctx([(0.0, 1.0)])) == 0.0
    assert _read(_ctx([(0.0, 1.0)] * 5)) is None     # more calls than records


def test_turbo_resumes_is_none_without_the_counter(monkeypatch):
    from meteor_demod_tpu_torch import profiling
    recs = [{"turbo.samples": 100, "turbo.sequential_samples": 40,
             "turbo.passes": 4}]
    monkeypatch.setattr(profiling, "calls", lambda root: list(recs))
    assert _read(_ctx([(0.0, 1.0)])) is None
    monkeypatch.delattr(profiling, "calls")
    assert _read(_ctx([(0.0, 1.0)])) is None
