"""The port's pass-scale soak (meteor_demod_tpu_torch/soak.py) at a CPU
size: its entry point with --small's table cut to 4 lanes x 4 blocks of
2048 samples and 30 warm-up blocks, and a 4-block chain: 3 spans (the
checkpoint at the second, the third re-run from it) and a 2-dispatch
sequential leg. The span arithmetic is span turbo's, which
tests/test_torch_span_turbo.py holds against the JAX package; this holds the
soak's own checks: every span converged with every lane accepted, the carry
sane and locked, the restored checkpoint's span bitwise the first run's,
the sequential leg flag-free and locked, and the JSON line's keys."""

import json

import numpy as np
import pytest

from meteor_demod_tpu_torch import soak

TINY = dict(block_len=2048, span_samples=1, chunks=4, kb=4, seq_samples=1,
            nwarm=30, carrier_hz=80.0, chain=4)


def test_soak_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(soak, "SMALL", TINY)
    assert soak.main(["--small", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    span, seq = out["span"], out["sequential"]
    assert out["device"] == "cpu" and out["card"] == "cpu"
    assert span["spans"] == 3 and span["checkpoint_span"] == 1
    assert span["replay_bitwise"] is True
    assert span["samples"] == 3 * 4 * 4 * 2048
    assert span["symbols"] == pytest.approx(span["samples"] / 3.2, rel=0.01)
    assert 1 <= span["passes_max"] <= 4
    for k in ("msamples_per_s", "wall_s", "signal_minutes", "rss_start_mb",
              "rss_track_mb", "rss_end_mb", "note"):
        assert k in span, k
    assert span["rss_start_mb"] > 0 and span["rss_track_mb"]
    assert seq["samples"] == 2 * 4 * 2048 and seq["dispatches"] == 2
    assert seq["msamples_per_s"] > 0


def test_sanity_rejects_pathologies():
    good = dict(p_phase=np.float32(1.0), t_phase=np.float32(0.5),
                p_err=np.float32(20.0), t_freq=np.float32(0.4))
    soak.sanity(good, "good")
    for bad in (dict(p_phase=np.float32(7.0)), dict(t_phase=np.float32(-1)),
                dict(p_err=np.float32(0.0)), dict(p_err=np.float32(1000.0)),
                dict(t_freq=np.float32(np.nan))):
        with pytest.raises(AssertionError):
            soak.sanity({**good, **bad}, "bad")


def test_seam_period_holds_whole_cycles():
    f = soak.seam_carrier(400.0, 128 * 16 * 8192, 230400)
    cycles = f * 128 * 16 * 8192 / 230400
    assert abs(cycles - round(cycles)) < 1e-6 and abs(f - 400.0) < 0.01
