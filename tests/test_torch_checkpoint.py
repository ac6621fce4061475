"""The port's checkpoints (meteor_demod_tpu_torch/io/checkpoint.py) and the CLI's
--checkpoint, on the CPU: a resumed demodulator continues bit-identically to
the uninterrupted one (stream, fleet, serving), a save changes nothing, the
loaders refuse the wrong kind of file, and a checkpoint the JAX package wrote
(stream, or fleet, also with a parked stream) resumes in the port with the
JAX run's decisions. tests/test_torch_checkpoint_interop.py moves every kind
both ways.

Mirrors tests/test_io_cli.py (checkpoint section) and
tests/test_fleet_checkpoint.py at a small size. Against the JAX package:
decisions bitwise, soft symbols within rtol=5e-4, atol=0.05 (the tolerances of
tests/test_torch_fleet.py).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.pipeline import StreamDemodulator as JaxDemod
from meteor_demod_tpu.io import checkpoint as jax_ckpt
from meteor_demod_tpu.parallel.mesh import FleetDemodulator as JaxFleet
from meteor_demod_tpu.parallel.mesh import make_mesh
from meteor_demod_tpu.sim import encode_iq, synth_psk

from meteor_demod_tpu_torch import cli
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator
from meteor_demod_tpu_torch.demod.state import carry_to_numpy
from meteor_demod_tpu_torch.io.checkpoint import (
    load_checkpoint, load_fleet_checkpoint, load_serving_checkpoint,
    save_checkpoint, save_fleet_checkpoint, save_serving_checkpoint,
    write_parked_form)
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.parallel.serving import ServingFleet

L = 1024
N = 4


@pytest.fixture(scope="module")
def cfg():
    return DemodConfig(samplerate=230400, block_len=L)


def _signal(n, carrier_hz=200.0, seed=7):
    x, _ = synth_psk(n // 3 + 64, 230400, carrier_hz=carrier_hz,
                     amplitude=6000.0, snr_db=22.0, seed=seed)
    return x[:n]


def _fleet_data(n_streams, n_blocks, seed0=70):
    return np.stack([_signal(n_blocks * L, 60.0 + 15.0 * i, seed0 + i)
                     for i in range(n_streams)])


def _run(fleet, data, lo, hi):
    span = fleet.cfg.block_len * getattr(fleet, "chain_blocks", 1)
    return [fleet.process_blocks(data[:, c * span:(c + 1) * span])
            for c in range(lo, hi)]


def _assert_outs_equal(got, ref, msg=""):
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(ref, f.name),
                                      err_msg=f"{msg} {f.name}")


def _assert_fleets_equal(a, b):
    ca, cb = carry_to_numpy(a.carry), carry_to_numpy(b.carry)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
    assert a.telemetry == b.telemetry
    assert a._block_idx == b._block_idx
    assert a.recovered_streams == b.recovered_streams
    np.testing.assert_array_equal(a._rescue_streak, b._rescue_streak)
    np.testing.assert_array_equal(a.stream_flags, b.stream_flags)


# ------------------------------------------------------------------- stream

@pytest.mark.parametrize("split", [L + 123, L], ids=["tail", "no_tail"])
def test_stream_checkpoint_resume_exact(cfg, tmp_path, split):
    """Save mid-stream, with a block still in the dispatch pipeline (its
    symbols ride in the file as backlog) and with or without a sub-block
    tail pending, resume, and the output is bitwise the uninterrupted
    run's."""
    x = _signal(3 * L + 500)
    d1 = StreamDemodulator(cfg, "cpu")
    full = np.concatenate([d1.process(x), d1.finish()])

    d2 = StreamDemodulator(cfg, "cpu", sweep_rescue_s=0.0)
    part1 = d2.process(x[:split])
    assert len(part1) == 0 and len(d2._inflight) == 1
    ckpt = str(tmp_path / "state.ckpt")        # no .npz: the path is exact
    save_checkpoint(ckpt, d2)
    assert os.path.exists(ckpt) and len(d2._backlog) == 1
    d3 = load_checkpoint(ckpt, "cpu")
    assert d3.cfg == cfg and d3.symbols_out == d2.symbols_out
    assert d3.pll_freq == d2.pll_freq
    part2 = np.concatenate([d3.process(x[split:]), d3.finish()])
    np.testing.assert_array_equal(np.concatenate([part1, part2]), full)
    assert d3.symbols_out == len(full)


def test_jax_stream_checkpoint_resumes_in_port(tmp_path):
    """A StreamDemodulator checkpoint the JAX package wrote loads into the
    port (its configuration's window fields dropped), and the rest of the
    stream comes out with the JAX run's decisions."""
    jcfg = JaxConfig(samplerate=230400, block_len=L)
    x = _signal(14 * L + 300, carrier_hz=80.0, seed=3)
    split = 11 * L + 77
    jd = JaxDemod(jcfg)
    jd.process(x[:split])
    path = str(tmp_path / "jax_stream.npz")
    jax_ckpt.save_checkpoint(path, jd)
    ref = np.concatenate([jd.process(x[split:]), jd.finish()])

    d = load_checkpoint(path, "cpu")
    assert d.cfg == DemodConfig(samplerate=230400, block_len=L)
    assert d.symbols_out == jd.symbols_out - len(ref)
    assert len(d._pending) == split % L
    got = np.concatenate([d.process(x[split:]), d.finish()])
    assert len(got) == len(ref) > 0
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    assert got["locked_once"].any() and not got["locked_once"].all()
    np.testing.assert_allclose(got["re"], ref["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], ref["im"], rtol=5e-4, atol=0.05)


# -------------------------------------------------------------------- fleet

@pytest.mark.parametrize("kw", [
    dict(), dict(chain_blocks=2, packed_output=True, telemetry_every=2,
                 sweep_rescue_s=0.02)], ids=["chain1", "chain2_packed"])
def test_fleet_checkpoint_resume_bitwise(cfg, tmp_path, kw):
    """Save mid-run, resume, and every later dispatch and the final state
    are bit-identical to the uninterrupted fleet; the structural arguments
    (chain, packing) and the policy counters ride in the file."""
    K = kw.get("chain_blocks", 1)
    n_chains, cut = 4, 2
    data = _fleet_data(N, K * n_chains)
    ref = FleetDemodulator(cfg, N, "cpu", **kw)
    ref_outs = _run(ref, data, 0, n_chains)

    fleet = FleetDemodulator(cfg, N, "cpu", **kw)
    _run(fleet, data, 0, cut)
    ckpt = str(tmp_path / "fleet.npz")
    save_fleet_checkpoint(ckpt, fleet)
    resumed = load_fleet_checkpoint(ckpt, "cpu")
    assert (resumed.n_streams, resumed.chain_blocks) == (N, K)
    assert resumed.packed_output == fleet.packed_output
    assert resumed.telemetry_every == fleet.telemetry_every
    assert resumed.sweep_rescue_s == fleet.sweep_rescue_s
    _assert_fleets_equal(resumed, fleet)
    for c, (got, want) in enumerate(zip(_run(resumed, data, cut, n_chains),
                                        ref_outs[cut:])):
        _assert_outs_equal(got, want, f"chain {cut + c}")
    _assert_fleets_equal(resumed, ref)


def test_fleet_checkpoint_save_does_not_mutate(cfg, tmp_path):
    """save_fleet_checkpoint is a pure snapshot: the live fleet goes on
    exactly as one that was never saved."""
    data = _fleet_data(N, 3)
    ref = FleetDemodulator(cfg, N, "cpu")
    fleet = FleetDemodulator(cfg, N, "cpu")
    _run(ref, data, 0, 2)
    _run(fleet, data, 0, 2)
    save_fleet_checkpoint(str(tmp_path / "a.npz"), fleet)
    _assert_fleets_equal(fleet, ref)
    _assert_outs_equal(_run(fleet, data, 2, 3)[0], _run(ref, data, 2, 3)[0])


def test_checkpoint_loaders_reject_wrong_kind(cfg, tmp_path):
    fleet = FleetDemodulator(cfg, N, "cpu")
    p = str(tmp_path / "f.npz")
    save_fleet_checkpoint(p, fleet)
    with pytest.raises(ValueError, match="not a serving checkpoint"):
        load_serving_checkpoint(p, "cpu")
    # The single-stream loader rejects kind-tagged files with a clear error
    # instead of a KeyError deep in reconstruction.
    with pytest.raises(ValueError, match="fleet checkpoint"):
        load_checkpoint(p, "cpu")
    s = str(tmp_path / "s.npz")
    save_checkpoint(s, StreamDemodulator(cfg, "cpu"))
    with pytest.raises(ValueError, match="not a fleet checkpoint"):
        load_fleet_checkpoint(s, "cpu")


def _jax_fleet(jcfg, **kw):
    return JaxFleet(jcfg, N, mesh=make_mesh(jax.devices()[:1]),
                    backend="scan", park=False, **kw)


def _hold_jax(outs, ref_outs, first):
    """The decision contract against the JAX run's chains from `first`."""
    for c, (got, want) in enumerate(zip(outs, ref_outs)):
        for k in ("valid", "locked_once"):
            np.testing.assert_array_equal(getattr(got, k),
                                          np.asarray(getattr(want, k)),
                                          err_msg=f"chain {first + c} {k}")
        v = got.valid.astype(bool)
        for k in ("sym_re", "sym_im"):
            np.testing.assert_allclose(
                getattr(got, k)[v], np.asarray(getattr(want, k))[v],
                rtol=5e-4, atol=0.05, err_msg=f"chain {first + c} {k}")


def test_jax_fleet_checkpoint_resumes_in_port(tmp_path):
    """A fleet checkpoint the JAX package wrote (park=False, chained) loads
    into the port: program-switch and banding fields are kept only to be
    written back, the backend name becomes the port's default, and the next
    chains' decisions match the JAX run's. The same file with a stream
    parked (the JAX package's layout for a stream at the tick it parks it)
    resumes too: the stream's host carry goes back onto its lane, and the
    run is the plain file's, bitwise."""
    jcfg = JaxConfig(samplerate=230400, block_len=L)
    K, n_chains, cut = 2, 6, 4
    data = _fleet_data(N, 16)
    jf = _jax_fleet(jcfg, chain_blocks=K, telemetry_every=2)
    _run(jf, data, 0, cut)
    path = str(tmp_path / "jax_fleet.npz")
    jax_ckpt.save_fleet_checkpoint(path, jf)
    ref_outs = _run(jf, data, cut, n_chains)

    fleet = load_fleet_checkpoint(path, "cpu")
    assert fleet.cfg == DemodConfig(samplerate=230400, block_len=L)
    assert (fleet.chain_blocks, fleet.telemetry_every) == (K, 2)
    assert fleet._backend == "auto" and fleet._block_idx == cut
    # The lock arrives after the resume: the decision is not a constant.
    assert not carry_to_numpy(fleet.carry)["locked_once"].any()
    outs = _run(fleet, data, cut, n_chains)
    _hold_jax(outs, ref_outs, cut)
    assert carry_to_numpy(fleet.carry)["locked_once"].all()
    assert int(fleet.telemetry["locked_streams"]) == int(
        jf.telemetry["locked_streams"])

    parked = str(tmp_path / "jax_fleet_parked.npz")
    write_parked_form(path, parked, [1])
    with np.load(parked) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        assert list(meta["fleet"]["parked"]) == ["1"]
        np.testing.assert_array_equal(z["carry_t_phase"][1],
                                      z["carry_t_phase"][0])
    again = load_fleet_checkpoint(parked, "cpu")
    assert again.parked_streams().size == 0
    again_outs = _run(again, data, cut, n_chains)
    for c, (got, want) in enumerate(zip(again_outs, outs)):
        _assert_outs_equal(got, want, f"parked form, chain {cut + c}")
    _hold_jax(again_outs, ref_outs, cut)


# ------------------------------------------------------------------ serving

def test_serving_checkpoint_resume_bitwise(cfg, tmp_path):
    n_streams, group, n_blocks, cut = 4, 2, 3, 2
    data = _fleet_data(n_streams, n_blocks)
    kw = dict(group_size=group, device="cpu", packed_output=True)
    ref = ServingFleet(cfg, n_streams, **kw)
    serving = ServingFleet(cfg, n_streams, **kw)
    for f in (ref, serving):         # an assignment other than the initial
        f._group_of, f._lane_of = np.array([1, 0, 1, 0]), np.array([0, 0, 1, 1])
    ref_outs = _run(ref, data, 0, n_blocks)
    _run(serving, data, 0, cut)
    ckpt = str(tmp_path / "serving.npz")
    save_serving_checkpoint(ckpt, serving)
    resumed = load_serving_checkpoint(ckpt, "cpu")
    assert resumed.assignment() == serving.assignment()
    assert (resumed.n_streams, resumed.group_size) == (n_streams, group)
    assert resumed.groups[0].packed_output
    for g in range(2):
        _assert_fleets_equal(resumed.groups[g], serving.groups[g])
    for b, (got, want) in enumerate(zip(_run(resumed, data, cut, n_blocks),
                                        ref_outs[cut:])):
        _assert_outs_equal(got, want, f"block {cut + b}")
    with pytest.raises(ValueError, match="not a fleet checkpoint"):
        load_fleet_checkpoint(ckpt, "cpu")


# ---------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A 16-bit raw capture of 5 blocks and a tail, whole and cut in two at
    a block boundary, which is also a 32 KiB chunk boundary of the ingest
    (so that the first half loses no partial chunk and ends in no tail the
    whole run would have demodulated inside a block)."""
    d = tmp_path_factory.mktemp("ckpt_cli")
    x, _ = synth_psk(14000, 230400, carrier_hz=250.0, amplitude=6000.0,
                     snr_db=20.0, seed=7)
    cut = 3 * 8192
    paths = {}
    for name, part in (("all", x), ("a", x[:cut]), ("b", x[cut:])):
        paths[name] = str(d / f"{name}.raw")
        with open(paths[name], "wb") as f:
            f.write(encode_iq(part, 16))
    return d, paths


def _cli(args):
    return cli.main(["meteor_demod_tpu_torch", "-B", "-q", "-s", "230400",
                     "--bps", "16", *args])


def test_cli_checkpoint_split_capture_bitwise(capture, monkeypatch):
    """--checkpoint: a capture cut into two segments, run as two CLI
    invocations sharing a checkpoint file, demodulates as one continuous
    stream: the concatenated .s files are bitwise the single run's."""
    d, paths = capture
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    out = {k: str(d / f"{k}.s") for k in paths}
    ck = str(d / "state.ckpt.npz")
    assert _cli(["-o", out["all"], paths["all"]]) == 0
    assert _cli(["-o", out["a"], "--checkpoint", ck, paths["a"]]) == 0
    assert os.path.exists(ck)
    assert _cli(["-o", out["b"], "--checkpoint", ck, paths["b"]]) == 0
    ref = np.fromfile(out["all"], dtype=np.int8)
    got = np.concatenate([np.fromfile(out[k], dtype=np.int8) for k in "ab"])
    assert len(ref) > 2 * 5000
    np.testing.assert_array_equal(got, ref)
    # The saved state is the whole capture's: every symbol of its whole
    # 32 KiB chunks (the ingest drops a partial trailing chunk), also those
    # before the lock that the writer dropped.
    n_samples = os.path.getsize(paths["all"]) // 32768 * 8192
    assert load_checkpoint(ck, "cpu").symbols_out == pytest.approx(
        n_samples * 72000 / 230400, abs=8)


def test_cli_checkpoint_refusals(capture, monkeypatch, capsys):
    """A checkpoint written under another configuration is refused, and so
    is --checkpoint with -T, each with exit 1 and one line."""
    d, paths = capture
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    ck = str(d / "other.npz")
    save_checkpoint(ck, StreamDemodulator(
        DemodConfig(samplerate=230400, rrc_order=64), "cpu"))
    before = os.path.getmtime(ck)
    assert _cli(["-o", os.devnull, "--checkpoint", ck, paths["a"]]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "different configuration" in err
    assert os.path.getmtime(ck) == before
    assert _cli(["-o", os.devnull, "-T", "4", "--checkpoint",
                 str(d / "t.npz"), paths["a"]]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "--checkpoint cannot be combined" in err
    assert not os.path.exists(d / "t.npz")
