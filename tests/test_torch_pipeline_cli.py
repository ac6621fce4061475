"""The port's StreamDemodulator and CLI (meteor_demod_tpu_torch/demod/pipeline.py,
cli.py) against the JAX package's, on CPU.

Contracts: symbol counts and lock history bitwise; symbol values within
rtol=5e-4, atol=0.05 (tests/test_scan_vs_oracle.py: XLA may fuse a multiply
and an add the port rounds separately, and the two FIRs sum in different
orders). Through the CLI the soft bytes are truncated symbol/2, so a value a
hair either side of an integer can move one byte by 1: every byte within
+-1, and at least 99.9 % of them identical.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meteor_demod_tpu import cli as jax_cli
from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.pipeline import StreamDemodulator as JaxDemod
from meteor_demod_tpu.demod.pipeline import quantize_symbols as jax_quantize
from meteor_demod_tpu.sim import synth_psk, write_raw, write_wav
from meteor_demod_tpu.utils import human_to_float as jax_h2f

from meteor_demod_tpu_torch import cli
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import scalar
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   quantize_symbols)
from meteor_demod_tpu_torch.dsp.fir import (f32_to_iq, iq_to_f32,
                                            make_fir_banks,
                                            polyphase_fir_block)
from meteor_demod_tpu_torch.io.wav import read_sample_blocks, wav_parse
from meteor_demod_tpu_torch.io.writer import SymbolWriter
from meteor_demod_tpu_torch.utils import human_to_float

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 1024


def _signal(n, carrier_hz=80.0, seed=3):
    x, _ = synth_psk(n // 3 + 64, 230400, carrier_hz=carrier_hz,
                     amplitude=6000.0, snr_db=25.0, seed=seed,
                     dc_offset=30 + 20j)
    return x[:n]


def _run(demod, x, chunks=None):
    if chunks is None:
        return np.concatenate([demod.process(x), demod.finish()])
    parts, pos = [], 0
    for take in chunks:
        parts.append(demod.process(x[pos:pos + take]))
        pos += take
    parts.append(demod.process(x[pos:]))
    parts.append(demod.finish())
    return np.concatenate(parts)


@pytest.mark.parametrize("n_blocks", [3, 12])
def test_stream_demodulator_matches_jax(n_blocks):
    """3 blocks: single-block dispatch; 12: a chained span of 8 blocks, then
    singles. Both end in a 777-sample tail through the oracle."""
    x = _signal(n_blocks * L + 777)
    jd = JaxDemod(JaxConfig(samplerate=230400, block_len=L))
    ref = _run(jd, x)
    d = StreamDemodulator(DemodConfig(samplerate=230400, block_len=L), "cpu")
    got = _run(d, x)
    assert d.fallback_blocks == 0
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    np.testing.assert_allclose(got["re"], ref["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], ref["im"], rtol=5e-4, atol=0.05)
    # Telemetry getters.
    assert (d.pll_locked, d.pll_locked_once) == (jd.pll_locked,
                                                 jd.pll_locked_once)
    assert d.pll_locked_once == (n_blocks == 12)
    for get in ("carrier_freq_hz", "symbol_rate_hz"):
        assert getattr(d, get)() == pytest.approx(getattr(jd, get)(),
                                                  rel=5e-4, abs=1e-2), get
    assert d.agc_gain == pytest.approx(jd.agc_gain, rel=5e-4)


@pytest.mark.parametrize("n_blocks, replayed", [(5, 1), (12, 8)])
def test_flagged_block_replays_through_oracle_like_jax(n_blocks, replayed):
    """A set safety flag routes the block (single dispatch) or the chained
    span to the numpy oracle, which both packages share; the younger
    in-flight blocks are re-dispatched from the oracle's carry."""
    x = _signal(n_blocks * L + 100, seed=9)
    jd = JaxDemod(JaxConfig(samplerate=230400, block_len=L))
    jd._carry = jd._carry._replace(flags=jd._carry.flags | 2)
    ref = _run(jd, x)
    d = StreamDemodulator(DemodConfig(samplerate=230400, block_len=L), "cpu")
    d._carry.flags |= 2
    before = StreamDemodulator.replayed_blocks
    got = _run(d, x)
    assert d.fallback_blocks == jd.fallback_blocks == replayed
    assert StreamDemodulator.replayed_blocks == before + replayed
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    n_oracle = int(round(replayed * L * 72000 / 230400)) - 8
    np.testing.assert_array_equal(got[:n_oracle], ref[:n_oracle])
    np.testing.assert_allclose(got["re"], ref["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], ref["im"], rtol=5e-4, atol=0.05)


def test_chunk_invariance():
    cfg = DemodConfig(samplerate=230400, block_len=L)
    x = _signal(10 * L + 777, seed=5)
    one_shot = _run(StreamDemodulator(cfg, "cpu"), x)
    rng = np.random.default_rng(0)
    chunks = rng.integers(1, 3000, size=12)
    chunked = _run(StreamDemodulator(cfg, "cpu"), x, chunks)
    np.testing.assert_array_equal(chunked, one_shot)


def test_sweep_rescue_kick_matches_jax():
    """--sweep-rescue: after the unlocked budget the carry is kicked to the
    downward sweep (p_freq=+fmax, updown=-1), exactly as the JAX package."""
    x = _signal(6 * L, carrier_hz=-150.0, seed=2)
    chunks = [2 * L, 2 * L]
    ref = JaxDemod(JaxConfig(samplerate=230400, block_len=L),
                   sweep_rescue_s=0.005)
    got = StreamDemodulator(DemodConfig(samplerate=230400, block_len=L), "cpu",
                            sweep_rescue_s=0.005)
    r, g = _run(ref, x, chunks), _run(got, x, chunks)
    assert len(g) == len(r)
    np.testing.assert_array_equal(g["locked_once"], r["locked_once"])
    np.testing.assert_allclose(g["re"], r["re"], rtol=5e-4, atol=0.05)
    assert got._rescue_pending_samples == ref._rescue_pending_samples < 0
    assert got.pll_freq == pytest.approx(ref.pll_freq, rel=5e-4, abs=1e-6)


def test_quantize_and_utils_match_jax():
    rng = np.random.default_rng(1)
    syms = np.zeros(4000, dtype=[("re", np.float32), ("im", np.float32),
                                 ("locked_once", np.int32)])
    syms["re"] = rng.standard_normal(4000) * 200
    syms["im"] = np.concatenate([rng.standard_normal(3990) * 200,
                                 [254.0, 253.99, -254.0, -255.5, 1.999,
                                  -1.999, 0.0, -0.0, 300.0, -300.0]])
    np.testing.assert_array_equal(quantize_symbols(syms), jax_quantize(syms))
    for s in ("230400", "2.4M", "1.5k", "72k", "3.9", "-7", "abc", "1e3"):
        assert human_to_float(s) == jax_h2f(s), s


@pytest.mark.parametrize("argv", [
    ["-B", "-o", "a.s", "in.wav"],
    ["--stdout", "-s", "2.4M", "--bps", "8", "-"],
    ["-b", "1.5k", "-d", "3.5k", "-f", "64", "-O", "10", "-r", "80k", "-m",
     "nonsense", "-R", "100", "-q", "--sweep-rescue", "1.5", "x.raw"],
    ["-T", "0", "--checkpoint", "c.npz", "-m", "oqpsk", "x.wav"],
    ["-h"], ["-v"], ["--bogus", "x"], ["-B"],
])
def test_parse_args_matches_jax(argv):
    got = cli.parse_args(["md", *argv])
    ref = jax_cli.parse_args(["md", *argv])
    if isinstance(ref, int):
        assert got == ref
        return
    g, r = vars(got), vars(ref)
    if "-o" not in argv:            # both default to LRPT_<current minute>.s
        g.pop("output_fname"), r.pop("output_fname")
    assert g == r


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    x, _ = synth_psk(16000, 230400, carrier_hz=120.0, amplitude=6000.0,
                     snr_db=20.0, seed=4)
    paths = dict(wav16=str(d / "x16.wav"), wav8=str(d / "x8.wav"),
                 raw8=str(d / "x8.raw"))
    write_wav(paths["wav16"], x, 230400, 16)
    write_wav(paths["wav8"], x / 60, 230400, 8)
    write_raw(paths["raw8"], x / 60, 8)
    return d, paths


KINDS = ("wav16", "wav8", "raw8_stdin")
_RAW_ARGS = ["-s", "230400", "--bps", "8", "-q", "-o"]


@pytest.fixture(scope="module")
def port_cli(fixtures):
    """The port CLI's .s output for each fixture kind (run once each)."""
    d, paths = fixtures
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("METEOR_DEMOD_PLATFORM", "cpu")
        for kind in KINDS:
            out = str(d / f"{kind}.port.s")
            if kind == "raw8_stdin":
                raw = open(paths["raw8"], "rb").read()
                mp.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(raw)))
                rc = cli.main(["meteor_demod_tpu_torch", *_RAW_ARGS, out, "-"])
            else:
                rc = cli.main(["meteor_demod_tpu_torch", "-B", "-q", "-o", out,
                               paths[kind]])
            assert rc == 0
            outs[kind] = np.fromfile(out, dtype=np.int8)
    return outs


def _jax_cli(args, stdin=None):
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-m", "meteor_demod_tpu", *args],
                          input=stdin, capture_output=True, timeout=300,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr.decode()[-500:]


@pytest.mark.parametrize("kind", KINDS)
def test_cli_batch_matches_jax_cli(fixtures, port_cli, kind):
    d, paths = fixtures
    ref_out = str(d / f"{kind}.jax.s")
    if kind == "raw8_stdin":
        _jax_cli([*_RAW_ARGS, ref_out, "-"],
                 stdin=open(paths["raw8"], "rb").read())
    else:
        _jax_cli(["-B", "-q", "-o", ref_out, paths[kind]])
    ref = np.fromfile(ref_out, dtype=np.int8)
    got = port_cli[kind]
    # Same length means the same symbol count and the same lock gating
    # (pre-lock rings are dropped, main.c:305-316).
    assert len(got) == len(ref) > 4000
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    same = float(np.mean(diff == 0))
    assert same >= 0.999, same
    assert 55 < np.mean(np.abs(got.astype(np.float32))) < 75


def test_cli_output_is_the_oracle_bitwise(fixtures, port_cli):
    """The CLI's .s bytes equal, bitwise, the numpy oracle run block by block
    on the port's FIR output, quantized and lock-gated by the writer."""
    _, paths = fixtures
    with open(paths["wav16"], "rb") as f:
        assert wav_parse(f) is not None
        x = np.concatenate(list(read_sample_blocks(f, 16)))
    cfg = DemodConfig(samplerate=230400)
    L = cfg.block_len
    banks = torch.as_tensor(make_fir_banks(cfg))
    tail = torch.zeros((1, cfg.taps - 1, 2))
    st = scalar.initial_state(cfg)
    sink = io.BytesIO()
    writer = SymbolWriter(sink)
    for i in range(0, len(x), L):
        xb = x[i:i + L]
        F = None
        if len(xb) == L:
            Ft, tail = polyphase_fir_block(
                torch.from_numpy(iq_to_f32(xb))[None], tail, banks)
            F = f32_to_iq(Ft[:, :, 0].numpy()).reshape(L, cfg.interp)
        syms, st = scalar.demod_stream_np(cfg, xb, st, F=F)
        writer.feed(quantize_symbols(syms), syms["locked_once"])
    writer.flush_partial()
    ref = np.frombuffer(sink.getvalue(), dtype=np.int8)
    np.testing.assert_array_equal(port_cli["wav16"], ref)


@pytest.mark.parametrize("args, msg", [
    (["-B", "-T", "4"], "-T/--turbo"),
    ([], "the TUI"),
])
def test_cli_refuses_unported(fixtures, args, msg, capsys):
    _, paths = fixtures
    rc = cli.main(["meteor_demod_tpu_torch", *args, "-o", os.devnull,
                   paths["wav16"]])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and msg in err and "not ported" in err


def test_cli_without_cuda_raises(fixtures, monkeypatch):
    """Without METEOR_DEMOD_PLATFORM=cpu the CLI asks for the card, and
    raises where there is none: it never drops to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, paths = fixtures
    monkeypatch.delenv("METEOR_DEMOD_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["meteor_demod_tpu_torch", "-B", "-q", "-o", os.devnull,
                  paths["wav16"]])


def test_cli_status_line(fixtures, monkeypatch, capsys):
    """Batch mode prints the reference's status line format."""
    d, _ = fixtures
    x, _ = synth_psk(6000, 230400, carrier_hz=120.0, amplitude=6000.0,
                     snr_db=20.0, seed=4)
    wav = str(d / "short.wav")
    write_wav(wav, x, 230400, 16)
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    rc = cli.main(["meteor_demod_tpu_torch", "-B", "-R", "10", "-o",
                   str(d / "status.s"), wav])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert lines[0] == f"Input: {wav}, output: {d / 'status.s'}"
    assert any(ln.startswith("(") and "Carrier:" in ln and "Hz, Symbol rate:"
               in ln and "Locked: " in ln for ln in lines[1:])
