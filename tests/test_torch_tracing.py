"""The port's spans and counters (meteor_demod_tpu_torch/profiling.py) on the
CPU: a fleet chain (FleetDemodulator.process_blocks) and the
CLI's -T 0 (cli.main -> demod_array_turbo -> the sequential path).

Contracts. Without a profiler no RecordFunction is made. Under
torch.profiler every stage span of the table in profiling's callers is
there, inside its root, and the stages of one call do not overlap. Rows and
.s bytes are bitwise the same with the profiler on and off. The CLI's call
record holds turbo's passes and the samples it handed to the sequential
path, as a direct demod_array_turbo on the same samples reports them. The
ring of call records keeps the last CALLS_KEPT.

Sizes: block_len 1024 (the CLI's configuration is patched to it), a fleet of
2 streams x 2 blocks, and a CLI recording of 8192 samples over 4 lanes of 2
blocks; the profiler records every op of the plain recurrence, ~2 s a
1024-sample block. Turbo's fixpoint is cut to 2 passes and its verdict
poisoned from lane 3 on, so that every run falls back over the last lane.
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

from meteor_demod_tpu_torch import cli, profiling
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import turbo
from meteor_demod_tpu_torch.dsp.fir import iq_to_f32
from meteor_demod_tpu_torch.io.wav import decode_iq, open_input
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.sim import synth_psk, write_wav

L = 1024
N_CLI = 8192                 # one 32 KiB buffer of 16-bit pairs
LANES, P_OK = 4, 3           # -T 0 with TURBO_MIN_BLOCKS 2; lanes verified
FLEET_STAGES = ("fleet.upload", "fleet.launch", "fleet.readback")
CLI_STAGES = ("cli.read", "cli.decode", "turbo.prepare", "turbo.warmup",
              "turbo.pass", "turbo.assemble", "turbo.sequential",
              "cli.quantize", "cli.write")
STREAM = ("stream.upload", "stream.launch", "stream.fetch",
          "stream.collect")


def _poisoned(real):
    """gauge_fixpoint cut to 2 passes, its lanes from P_OK on unverified."""
    def fixpoint(cfg, run, w_np, tails, max_passes, **kw):
        f_np, outs, K, passes, _, resid, ok, stats = real(cfg, run, w_np,
                                                          tails, 2, **kw)
        ok = np.ones(len(ok), bool)
        ok[P_OK:] = False
        return f_np, outs, K, passes, False, max(resid, 0.5), ok, stats
    return fixpoint


def _no_record_function(*a, **kw):
    raise AssertionError("a RecordFunction was made with no profiler on")


def _spans(prof) -> list:
    """(start ns, end ns, name) of every meteor. range the profiler kept."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(profiling.SPAN_PREFIX):
            out.append((ev.start_ns(), ev.end_ns(),
                        name[len(profiling.SPAN_PREFIX):]))
    return sorted(out)


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each path once with no profiler (record_function raising) and once
    under torch.profiler, from the same state."""
    d = tmp_path_factory.mktemp("tracing")
    cfg = DemodConfig(samplerate=230400, block_len=L)
    rng = np.random.default_rng(5)
    x = np.stack([synth_psk(2 * L // 3 + 64, 230400, carrier_hz=hz,
                            amplitude=6000.0, snr_db=20.0, seed=s)[0][:2 * L]
                  for s, hz in ((1, 120.0), (2, -300.0))])
    blocks = np.round(iq_to_f32(x) + rng.normal(0, 1, (2, 2 * L, 2))
                      ).astype(np.int16)
    sig, _ = synth_psk(N_CLI // 3 + 64, 230400, carrier_hz=150.0,
                       amplitude=6000.0, snr_db=18.0, seed=31)
    wav = str(d / "rec.wav")
    write_wav(wav, sig[:N_CLI], 230400, 16)

    def fleet():
        f = FleetDemodulator(cfg, 2, device="cpu", chain_blocks=2,
                             ingest="i16", packed_output=True)
        return f.process_blocks(blocks)

    def cli_run(name):
        out, text = str(d / name), io.StringIO()
        with contextlib.redirect_stdout(text):
            assert cli.main(["meteor_demod_tpu_torch", "-B", "-T", "0",
                             "-o", out, wav]) == 0
        return (np.fromfile(out, dtype=np.int8),
                profiling.calls("cli.main")[-1], text.getvalue())

    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("METEOR_DEMOD_PLATFORM", "cpu")
        mp.setattr(cli, "DemodConfig",
                   functools.partial(DemodConfig, block_len=L))
        mp.setattr(cli, "TURBO_MIN_BLOCKS", 2)
        mp.setattr(turbo, "gauge_fixpoint", _poisoned(turbo.gauge_fixpoint))
        with pytest.MonkeyPatch.context() as off:
            off.setattr(torch.profiler, "record_function",
                        _no_record_function)
            off.setattr(torch.autograd.profiler, "record_function",
                        _no_record_function)
            res["fleet_off"] = fleet()
            res["cli_off"], res["record"], res["status"] = cli_run("off.s")
        res["fleet_on"], res["fleet_spans"] = _profiled(fleet)
        (res["cli_on"], _, _), res["cli_spans"] = _profiled(
            lambda: cli_run("on.s"))
        f, _, _ = open_input(wav)
        with f:
            samples = decode_iq(f.read(), 16)
        res["direct"] = turbo.demod_array_turbo(
            cfg, samples, chunks=LANES, device="cpu", strict=True)
    return res


def _check_stages(spans, root, stages, children=()):
    roots = [(s, e) for s, e, n in spans if n == root]
    assert len(roots) == 1, (root, roots)
    lo, hi = roots[0]
    names = {n for _, _, n in spans}
    for name in stages + children:
        assert name in names, (name, sorted(names))
    staged = [(s, e, n) for s, e, n in spans if n in stages]
    for s, e, n in staged:
        assert lo <= s <= e <= hi, (n, root)
    for (s0, e0, n0), (s1, e1, n1) in zip(staged, staged[1:]):
        assert e0 <= s1, f"{n0} overlaps {n1}"
    for s, e, n in spans:
        if n in children:
            assert any(s0 <= s and e <= e0 for s0, e0, n0 in staged
                       if n0 == "turbo.sequential"), n


def test_no_record_function_without_profiler(runs):
    """(a) The fixture's unprofiled runs made no RecordFunction (it raises);
    a span with no profiler is a cheap no-op context."""
    assert len(runs["cli_off"]) > 0
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("anything") is profiling._OFF


def test_spans_under_profiler(runs):
    """(b) The fleet chain and the CLI's -T 0 each emit their root and
    stage spans, every stage inside the root, the stages disjoint; the
    sequential fallback's stream spans sit inside turbo.sequential."""
    _check_stages(runs["fleet_spans"], "fleet.process_blocks", FLEET_STAGES)
    _check_stages(runs["cli_spans"], "cli.main", CLI_STAGES, STREAM)
    assert sum(n == "turbo.pass" for _, _, n in runs["cli_spans"]) == 2


def test_outputs_bitwise_with_and_without_profiler(runs):
    """(c) Rows of the chain and bytes of the .s are the same bits with the
    profiler on and off."""
    for a, b in zip(dataclasses.astuple(runs["fleet_off"]),
                    dataclasses.astuple(runs["fleet_on"])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(runs["cli_off"], runs["cli_on"])


def test_cli_call_record_matches_turbo(runs):
    """(d) The CLI's last call record: the samples turbo was given, its
    passes, and every sample it handed to the sequential path (the
    unverified suffix, which here holds the tail too), as a direct
    demod_array_turbo(strict=True) on the same samples reports them."""
    rec, res = runs["record"], runs["direct"]
    assert res.fell_back and res.fallback_samples == N_CLI - P_OK * 2 * L
    assert rec["turbo.samples"] == N_CLI
    assert rec["turbo.passes"] == res.passes == 2
    assert rec["turbo.sequential_samples"] == res.fallback_samples


def test_cli_status_line_counts_sequential(runs):
    """The -T status line gives the sequential samples, the fallback's and
    the tail's, beside passes= and converged=."""
    fell = N_CLI - P_OK * 2 * L
    assert "passes=2, converged=False" in runs["status"]
    assert (f"sequential={fell} samples (fallback {fell}, tail 0)"
            in runs["status"])


def test_call_ring_keeps_the_last():
    """(e) calls(root) keeps the last CALLS_KEPT records, oldest first, each
    the counters' change over its call."""
    for i in range(profiling.CALLS_KEPT + 5):
        with profiling.call("test.ring"):
            profiling.count("test.ring_n", i)
    kept = profiling.calls("test.ring")
    assert len(kept) == profiling.CALLS_KEPT
    assert [r["test.ring_n"] for r in kept[:2]] == [5, 6]
    assert kept[-1]["test.ring_n"] == profiling.CALLS_KEPT + 4
