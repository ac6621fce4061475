"""The port's fleet driver (meteor_demod_tpu_torch/parallel/mesh.py) against
the JAX package's FleetDemodulator(backend="scan", park=False) and against
the port's own make_batch_demod, on the CPU.

Contracts (tests/test_scan_vs_oracle.py, tests/test_pallas_kernel.py):
decisions (valid, locked_once, flags, symbol counts, telemetry integers)
bitwise; float carry leaves within rtol=5e-4, atol=1e-3 and soft symbols
(magnitude ~130) within rtol=5e-4, atol=0.05, the tolerances of
tests/test_torch_oqpsk.py (XLA fuses multiplies and adds the port rounds
separately, and the two FIRs sum in different orders). Against its own batch
demodulator the fleet is bitwise.

The cases mirror tests/test_parallel.py, test_fleet_chain.py,
test_fleet_recovery.py, test_raw_ingest.py and test_sweep_rescue.py at a small
size (4 streams, block_len 1024). The CUDA kernels flag only a deferred OQPSK
pre-fire or an unconsumed block, so the recovery cases set the flag by hand on
one lane's carry, in both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.pipeline import egress
from meteor_demod_tpu.parallel.mesh import FleetDemodulator as JaxFleet
from meteor_demod_tpu.parallel.mesh import make_mesh
from meteor_demod_tpu.parallel.serialize import pack_rows as jax_pack_rows
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import (
    numpy_carry_to_scalar_state, oracle_replay, quantize, quantize_symbols)
from meteor_demod_tpu_torch.demod.state import batch_carry, carry_to_numpy
from meteor_demod_tpu_torch.dsp.fir import iq_to_f32
from meteor_demod_tpu_torch.parallel.mesh import (FleetDemodulator,
                                                  make_fleet_demod)
from meteor_demod_tpu_torch.parallel.serialize import pack_rows, unpack_rows

L = 1024
N = 4
FLAGGED = 2
MODES = {
    "qpsk": dict(samplerate=230400),
    "oqpsk": dict(samplerate=230400, symrate=80000.0, oqpsk=True),
}
_OUT = ("sym_re", "sym_im", "valid", "locked_once")
_DECISION_LEAVES = ("locked", "locked_once", "flags", "slot", "tick")
_FLOAT_LEAVES = ("t_phase", "t_freq", "p_freq", "agc_gain", "inphase")


def _cfgs(mode):
    kw = MODES[mode]
    return DemodConfig(block_len=L, **kw), JaxConfig(block_len=L, **kw)


def _data(mode, n_blocks, seed0=70):
    """(N, n_blocks*L) complex64: N simulated streams, carriers 60-105 Hz."""
    kw = MODES[mode]
    symrate = kw.get("symrate", 72000.0)
    n = n_blocks * L
    xs = []
    for i in range(N):
        x, _ = synth_psk(int(n * symrate / 230400) + 64, 230400,
                         symrate=symrate, oqpsk=kw.get("oqpsk", False),
                         carrier_hz=60.0 + 15.0 * i, amplitude=6000.0,
                         snr_db=22.0, seed=seed0 + i)
        xs.append(x[:n])
    return np.stack(xs)


def _jax_fleet(jcfg, **kw):
    return JaxFleet(jcfg, N, mesh=make_mesh(jax.devices()[:1]),
                    backend="scan", park=False, **kw)


def _np(outs) -> dict:
    if isinstance(outs, dict):
        return {k: np.asarray(v) for k, v in outs.items()}
    if dataclasses.is_dataclass(outs):
        return {f.name: np.asarray(getattr(outs, f.name))
                for f in dataclasses.fields(outs)}
    return {k: np.asarray(v) for k, v in outs._asdict().items()}


def _assert_bitwise(got, want, msg=""):
    got, want = _np(got), _np(want)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, f"{msg} {k} dtype"
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def _assert_against_jax(got, ref, msg="", streams=slice(None),
                        values="slots"):
    """Decisions bitwise, fired values within the float contract.
    values="order" compares a stream's fired values in firing order (a
    recovered stream's rows are left-justified)."""
    got, ref = _np(got), _np(ref)
    for k in ("valid", "locked_once"):
        np.testing.assert_array_equal(got[k][streams], ref[k][streams],
                                      err_msg=f"{msg} {k}")
    for k in ("sym_re", "sym_im"):
        for g, r, gv, rv in zip(got[k][streams], ref[k][streams],
                                got["valid"][streams].astype(bool),
                                ref["valid"][streams].astype(bool)):
            g = g[gv] if values == "order" else g[rv]
            np.testing.assert_allclose(g, r[rv], rtol=5e-4, atol=0.05,
                                       err_msg=f"{msg} {k}")


def _assert_carry_against_jax(fleet, jfleet, msg=""):
    a = carry_to_numpy(fleet.carry)
    b = egress(jfleet.carry)._asdict()
    for k in _DECISION_LEAVES:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                      err_msg=f"{msg} {k}")
    for k in _FLOAT_LEAVES:
        np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=5e-4,
                                   atol=1e-3, err_msg=f"{msg} {k}")


def _assert_telemetry_against_jax(fleet, jfleet, msg=""):
    for k in ("locked_streams", "locked_once_streams", "symbols", "flags"):
        assert fleet.telemetry[k].dtype == np.int32
        assert int(fleet.telemetry[k]) == int(jfleet.telemetry[k]), (msg, k)
    assert fleet.telemetry["mean_agc_gain"].dtype == np.float32
    np.testing.assert_allclose(fleet.telemetry["mean_agc_gain"],
                               np.float32(jfleet.telemetry["mean_agc_gain"]),
                               rtol=5e-4, err_msg=msg)


def _chains(data, K):
    span = K * L
    return [data[:, c * span:(c + 1) * span]
            for c in range(data.shape[1] // span)]


def _set_flag(fleet, lane=FLAGGED):
    """Force a safety flag on one lane's carry (either package's fleet)."""
    if isinstance(fleet, FleetDemodulator):
        flags = fleet.carry.flags.clone()
        flags[lane] |= 2
        fleet.carry = dataclasses.replace(fleet.carry, flags=flags)
    else:
        fleet.carry = fleet.carry._replace(
            flags=fleet.carry.flags.at[lane].set(2))


# ------------------------------------------------------- test_parallel.py:36

@pytest.mark.parametrize("mode", list(MODES))
def test_fleet_matches_batch_demod_and_jax(mode):
    cfg, jcfg = _cfgs(mode)
    n_blocks = 3
    data = _data(mode, n_blocks)
    fleet = FleetDemodulator(cfg, N, "cpu")
    jfleet = _jax_fleet(jcfg)
    fn = make_batch_demod(cfg, N, "cpu")
    carry = batch_carry(cfg, N, "cpu")
    rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)
    for b, blk in enumerate(_chains(data, 1)):
        got = fleet.process_blocks(blk)
        carry, ref = fn(carry, torch.from_numpy(iq_to_f32(blk)))
        assert got.valid.shape == (N, rows)
        _assert_bitwise(got, {k: getattr(ref, k).numpy() for k in _OUT},
                        f"block {b}")
        _assert_against_jax(got, jfleet.process_blocks(blk), f"block {b}")
        _assert_telemetry_against_jax(fleet, jfleet, f"block {b}")
    # Per-stream carry equality too (everything, not just emitted symbols).
    _assert_bitwise(carry_to_numpy(fleet.carry), carry_to_numpy(carry))
    _assert_carry_against_jax(fleet, jfleet)


# ------------------------------------------------------- test_parallel.py:72

def test_fleet_telemetry_sums():
    cfg, _ = _cfgs("qpsk")
    fleet = FleetDemodulator(cfg, N, "cpu")
    assert fleet.telemetry is None and fleet.flagged_streams().size == 0
    outs = fleet.process_blocks(_data("qpsk", 1, seed0=60))
    tel = fleet.telemetry
    assert set(tel) == {"locked_streams", "locked_once_streams", "symbols",
                        "mean_agc_gain", "flags"}
    assert int(tel["symbols"]) == int(outs.valid.sum())
    assert int(tel["flags"]) == 0
    assert 0 <= int(tel["locked_streams"]) <= N
    assert tel["mean_agc_gain"] == pytest.approx(
        float(fleet.carry.agc_gain.mean()))
    assert fleet.stream_flags.shape == (N,)
    assert fleet.flagged_streams().size == 0
    # The step built without telemetry computes none of it.
    step = make_fleet_demod(cfg, N, "cpu", telemetry=False)
    _, _, none = step(batch_carry(cfg, N, "cpu"),
                      torch.zeros((N, L, 2)))
    assert none == {}


# ------------------------------------------------------- test_parallel.py:88

def test_fleet_telemetry_amortized_matches_per_block():
    """telemetry_every=K must not change any stream's output or carry, and
    telemetry must update exactly on the refresh ticks (dispatches 0, K,
    2K, ...) while staying at the last tick's values in between."""
    cfg, _ = _cfgs("qpsk")
    n_blocks, K = 4, 3
    data = _data("qpsk", n_blocks, seed0=80)
    ref = FleetDemodulator(cfg, N, "cpu")
    amo = FleetDemodulator(cfg, N, "cpu", telemetry_every=K)
    seen = []
    for b, blk in enumerate(_chains(data, 1)):
        r, a = ref.process_blocks(blk), amo.process_blocks(blk)
        _assert_bitwise(a, r, f"block {b}")
        if b % K == 0:
            assert amo.telemetry == ref.telemetry, b
        seen.append(dict(amo.telemetry))
        assert amo.stream_flags.shape == (N,)
    assert seen[1] == seen[0] and seen[2] == seen[0]
    assert seen[3]["symbols"] != seen[0]["symbols"] or seen[3] != seen[0]
    _assert_bitwise(carry_to_numpy(amo.carry), carry_to_numpy(ref.carry))


# ------------------------------------------------------ test_parallel.py:130

def test_fleet_rejects_bad_shapes_and_arguments():
    cfg, _ = _cfgs("qpsk")
    fleet = FleetDemodulator(cfg, N, "cpu")
    with pytest.raises(ValueError, match="expected"):
        fleet.process_blocks(np.zeros((N - 1, L), dtype=np.complex64))
    with pytest.raises(ValueError, match="expected"):
        fleet.process_blocks(np.zeros((N, 2 * L), dtype=np.complex64))
    raw = FleetDemodulator(cfg, N, "cpu", ingest="i16")
    with pytest.raises(ValueError, match="int16"):
        raw.process_blocks(np.zeros((N, L, 2), dtype=np.float32))
    for bad in (dict(telemetry_every=0), dict(chain_blocks=0),
                dict(ingest="i8")):
        with pytest.raises(ValueError):
            FleetDemodulator(cfg, N, "cpu", **bad)
    with pytest.raises(ValueError):
        FleetDemodulator(cfg, 0, "cpu")
    with pytest.raises(ValueError):
        make_fleet_demod(cfg, N, "cpu", chain=0)
    with pytest.raises(ValueError):
        make_fleet_demod(cfg, N, "cpu", ingest="i8")


# ---------------------------------------------------- test_fleet_chain.py:96

@pytest.mark.parametrize("mode", list(MODES))
def test_chain_equals_unchained(mode):
    """chain_blocks=K is K calls of the same block program, so the chained
    rows are bitwise the unchained fleet's step-concatenation ((N, K*S), and
    K*(S+1) for OQPSK); against the JAX chained fleet (a different compiled
    program there) the decisions are bitwise."""
    cfg, jcfg = _cfgs(mode)
    K, n_chains = 2, 2
    data = _data(mode, K * n_chains)
    ref = FleetDemodulator(cfg, N, "cpu")
    ref_outs = [_np(ref.process_blocks(blk)) for blk in _chains(data, 1)]
    fleet = FleetDemodulator(cfg, N, "cpu", chain_blocks=K)
    jfleet = _jax_fleet(jcfg, chain_blocks=K)
    rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)
    for c, span in enumerate(_chains(data, K)):
        got = fleet.process_blocks(span)
        assert got.valid.shape == (N, K * rows)
        want = {k: np.concatenate([o[k] for o in ref_outs[c * K:(c + 1) * K]],
                                  axis=1) for k in _OUT}
        _assert_bitwise(got, want, f"chain {c}")
        _assert_against_jax(got, jfleet.process_blocks(span), f"chain {c}")
    _assert_bitwise(carry_to_numpy(fleet.carry), carry_to_numpy(ref.carry))
    _assert_carry_against_jax(fleet, jfleet)
    _assert_telemetry_against_jax(fleet, jfleet)


# ------------------------------- test_fleet_recovery.py:52, fleet_chain:127

@pytest.mark.parametrize("mode, K", [("qpsk", 1), ("qpsk", 2), ("oqpsk", 2)])
def test_fleet_recovers_flagged_stream_exactly(mode, K):
    """A flag on one lane (sticky over the chain) sends that stream's whole
    K-block span to the scalar oracle from the pre-chain carry: its rows are
    bitwise the oracle's, left-justified; the other streams are untouched;
    the corrected carry keeps the next dispatch clean. Decisions match the
    JAX fleet given the same flag."""
    cfg, jcfg = _cfgs(mode)
    n_chains, trip = 3, 1
    data = _data(mode, K * n_chains, seed0=90)
    clean = FleetDemodulator(cfg, N, "cpu", chain_blocks=K)
    fleet = FleetDemodulator(cfg, N, "cpu", chain_blocks=K)
    jfleet = _jax_fleet(jcfg, chain_blocks=K)
    others = [i for i in range(N) if i != FLAGGED]
    flagged_seen = []
    for c, span in enumerate(_chains(data, K)):
        if c == trip:
            _set_flag(fleet)
            _set_flag(jfleet)
            entry = {k: v[FLAGGED]
                     for k, v in carry_to_numpy(fleet.carry).items()}
        want = clean.process_blocks(span)
        got = fleet.process_blocks(span)
        jgot = jfleet.process_blocks(span)
        flagged_seen.append(fleet.flagged_streams().tolist())
        assert flagged_seen[-1] == jfleet.flagged_streams().tolist()
        if c < trip:
            _assert_bitwise(got, want, f"chain {c}")
        else:
            _assert_bitwise({k: v[others] for k, v in _np(got).items()},
                            {k: v[others] for k, v in _np(want).items()},
                            f"chain {c} others")
        order = "order" if c == trip else "slots"
        _assert_against_jax(got, jgot, f"chain {c}", values=order)
        if c == trip:
            sym, st = oracle_replay(
                cfg, data[FLAGGED, c * K * L:(c + 1) * K * L],
                numpy_carry_to_scalar_state(cfg, entry))
            n = len(sym)
            np.testing.assert_array_equal(got.valid[FLAGGED, :n], 1)
            np.testing.assert_array_equal(got.valid[FLAGGED, n:], 0)
            np.testing.assert_array_equal(got.sym_re[FLAGGED, :n], sym["re"])
            np.testing.assert_array_equal(got.sym_im[FLAGGED, :n], sym["im"])
            np.testing.assert_array_equal(got.locked_once[FLAGGED, :n],
                                          sym["locked_once"])
            assert int(fleet.telemetry["symbols"]) == int(got.valid.sum())
        _assert_telemetry_against_jax(fleet, jfleet, f"chain {c}")
    assert flagged_seen == [[FLAGGED] if c == trip else []
                            for c in range(n_chains)]
    assert fleet.recovered_streams == jfleet.recovered_streams == 1
    assert int(fleet.telemetry["flags"]) == 0
    _assert_carry_against_jax(fleet, jfleet)


# --------------------------------------------------- test_fleet_recovery.py:94

def test_fleet_recovery_between_telemetry_ticks():
    """With telemetry_every=2 a flag on dispatch 1 (not a tick) must still
    recover from the per-dispatch per-stream flags and leave the last tick's
    telemetry untouched; the corrected state shows in the next tick."""
    cfg, _ = _cfgs("qpsk")
    data = _data("qpsk", 3, seed0=90)
    fleet = FleetDemodulator(cfg, N, "cpu", telemetry_every=2)
    ref = FleetDemodulator(cfg, N, "cpu")
    for b, blk in enumerate(_chains(data, 1)):
        if b == 1:
            _set_flag(fleet)
            _set_flag(ref)
            tick0 = dict(fleet.telemetry)
        outs, router = fleet.process_blocks(blk), ref.process_blocks(blk)
        if b == 1:
            assert fleet.flagged_streams().tolist() == [FLAGGED]
            assert fleet.telemetry == tick0
        _assert_bitwise(outs, router, f"block {b}")
    assert fleet.recovered_streams == 1
    assert fleet.telemetry == ref.telemetry
    _assert_bitwise(carry_to_numpy(fleet.carry), carry_to_numpy(ref.carry))


# -------------------------------------------------- test_fleet_recovery.py:133

def test_fleet_sticky_flags_without_recovery():
    cfg, _ = _cfgs("qpsk")
    data = _data("qpsk", 3, seed0=90)
    fleet = FleetDemodulator(cfg, N, "cpu", recover_flagged=False)
    for b, blk in enumerate(_chains(data, 1)):
        if b == 1:
            _set_flag(fleet)
        fleet.process_blocks(blk)
        expect = [FLAGGED] if b >= 1 else []        # sticky once tripped
        assert fleet.flagged_streams().tolist() == expect, b
    assert fleet.recovered_streams == 0
    assert int(fleet.telemetry["flags"]) != 0


# ------------------------------------------------------ test_raw_ingest.py:46

def test_quantize_edge_values_match_numpy():
    """The device quantizer's math on a torch tensor equals the host's on a
    numpy array, value for value, also at the clamp, at the truncation
    boundaries, on signed zero, infinities and NaN."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        (rng.standard_normal(4000) * 200).astype(np.float32),
        np.float32([254.0, 253.99, 254.01, -254.0, -253.99, -255.5, 1.999,
                    -1.999, 2.0, -2.0, 0.0, -0.0, 300.0, -300.0, 1e30,
                    -1e30, np.inf, -np.inf, np.nan, 1e-40])])
    with np.errstate(invalid="ignore"):
        want = quantize(x)
        got = quantize(torch.from_numpy(x))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.to(torch.int8).numpy()[:-2],
                                      want.astype(np.int8)[:-2])
    assert np.nanmin(want) == -127 and np.nanmax(want) == 127


def test_packed_output_bitwise_equals_host_quantize():
    """packed_output=True gives exactly the bytes quantize_symbols would on
    the float outputs, for device rows and for an oracle-recovered stream,
    and the JAX packed fleet's decisions."""
    cfg, jcfg = _cfgs("qpsk")
    K = 2
    data = _data("qpsk", 2 * K, seed0=90)
    a = FleetDemodulator(cfg, N, "cpu", chain_blocks=K)
    b = FleetDemodulator(cfg, N, "cpu", chain_blocks=K, packed_output=True)
    jb = _jax_fleet(jcfg, chain_blocks=K, packed_output=True)
    for c, span in enumerate(_chains(data, K)):
        if c == 1:
            for f in (a, b, jb):
                _set_flag(f)
        ga, gb, gj = (f.process_blocks(span) for f in (a, b, jb))
        for k in ("sym_i", "sym_q", "valid", "locked_once"):
            assert getattr(gb, k).dtype == np.int8
        np.testing.assert_array_equal(gb.valid, ga.valid)
        np.testing.assert_array_equal(gb.locked_once, ga.locked_once)
        np.testing.assert_array_equal(gb.valid, np.asarray(gj.valid))
        np.testing.assert_array_equal(gb.locked_once,
                                      np.asarray(gj.locked_once))
        for s in range(N):
            v = ga.valid[s].astype(bool)
            sym = np.zeros(int(v.sum()), dtype=[("re", np.float32),
                                                ("im", np.float32),
                                                ("locked_once", np.int32)])
            sym["re"], sym["im"] = ga.sym_re[s][v], ga.sym_im[s][v]
            want = quantize_symbols(sym)
            np.testing.assert_array_equal(gb.sym_i[s][v], want[0::2])
            np.testing.assert_array_equal(gb.sym_q[s][v], want[1::2])
            # The two packages' bytes differ by at most one level.
            for got, ref in ((gb.sym_i, gj.sym_i), (gb.sym_q, gj.sym_q)):
                d = np.abs(got[s][v].astype(np.int16)
                           - np.asarray(ref)[s][v].astype(np.int16))
                assert d.max() <= 1
    assert b.recovered_streams == jb.recovered_streams == 1


# ------------------------------------------------------ test_raw_ingest.py:88

@pytest.mark.parametrize("ingest", ["i16", "u8"])
def test_raw_ingest_bitwise_equals_f32(ingest):
    """The on-device decode is io/wav.py decode_iq's math, so a raw-ingest
    fleet is bitwise the f32 fleet on the same samples, through an oracle
    recovery too; decisions match the JAX raw-ingest fleet."""
    cfg, jcfg = _cfgs("qpsk")
    K = 2
    data = _data("qpsk", 2 * K)
    scale = 1.0 if ingest == "i16" else 1.0 / 60.0
    pairs = np.stack([np.round(data.real * scale),
                      np.round(data.imag * scale)], axis=-1)
    if ingest == "i16":
        raw = np.clip(pairs, -32768, 32767).astype(np.int16)
        f32 = raw.astype(np.float32)
    else:
        raw = np.clip(pairs + 128.0, 0, 255).astype(np.uint8)
        f32 = raw.astype(np.float32) - np.float32(128.0)
    a = FleetDemodulator(cfg, N, "cpu", chain_blocks=K)
    b = FleetDemodulator(cfg, N, "cpu", chain_blocks=K, ingest=ingest)
    jb = _jax_fleet(jcfg, chain_blocks=K, ingest=ingest)
    span = K * L
    for c in range(2):
        if c == 1:
            for f in (a, b, jb):
                _set_flag(f)
        fa = np.ascontiguousarray(f32[:, c * span:(c + 1) * span])
        fr = np.ascontiguousarray(raw[:, c * span:(c + 1) * span])
        gb = b.process_blocks(fr)
        _assert_bitwise(gb, a.process_blocks(fa), f"{ingest} chain {c}")
        _assert_against_jax(gb, jb.process_blocks(fr), f"{ingest} chain {c}",
                            values="order" if c == 1 else "slots")
    assert b.recovered_streams == 1
    _assert_bitwise(carry_to_numpy(b.carry), carry_to_numpy(a.carry))


# ---------------------------------------------------- test_sweep_rescue.py:70

def test_fleet_rescue_kicks_device_lanes_like_jax():
    """After the unlocked budget (here 2 blocks) every unlocked lane is
    kicked onto the downward sweep (p_freq=+fmax, updown=-1) and its counter
    goes negative by the transit; a lane still in its cooldown is left
    alone. Same lanes, same dispatch and same counters as the JAX fleet."""
    cfg, jcfg = _cfgs("qpsk")
    rescue_s = 2 * L / 230400
    data = _data("qpsk", 3)
    base = FleetDemodulator(cfg, N, "cpu")
    fleet = FleetDemodulator(cfg, N, "cpu", sweep_rescue_s=rescue_s)
    jfleet = _jax_fleet(jcfg, sweep_rescue_s=rescue_s)
    assert fleet._rescue_blocks == jfleet._rescue_blocks == 2
    assert fleet._rescue_transit_blocks == jfleet._rescue_transit_blocks
    fleet._rescue_streak[1] = jfleet._rescue_streak[1] = -5
    for b, blk in enumerate(_chains(data, 1)):
        ref, got = base.process_blocks(blk), fleet.process_blocks(blk)
        jfleet.process_blocks(blk)
        np.testing.assert_array_equal(fleet._rescue_streak,
                                      jfleet._rescue_streak, err_msg=str(b))
        if b < 2:                    # the kick lands after dispatch 1
            _assert_bitwise(got, ref, f"block {b}")
        else:                        # lane 1 was never kicked
            _assert_bitwise({k: v[1] for k, v in _np(got).items()},
                            {k: v[1] for k, v in _np(ref).items()})
    kicked = [0, 2, 3]
    assert (fleet._rescue_streak[kicked] < 0).all()
    updown = carry_to_numpy(fleet.carry)["updown"]
    np.testing.assert_array_equal(updown, np.asarray(
        egress(jfleet.carry.updown)))
    assert (updown[kicked] == -1.0).all() and updown[1] == 1.0
    _assert_carry_against_jax(fleet, jfleet)
    # Reconfiguring turns it off again.
    fleet.set_sweep_rescue(0.0)
    assert fleet._rescue_blocks == 0


# ------------------------------------------------------ parallel/serialize.py

def test_pack_rows_matches_jax():
    rows = [dict(sym_re=np.float32([1, 2]), sym_im=np.float32([3, 4]),
                 valid=np.int32([1, 0]), locked_once=np.int32([0, 1])),
            dict(sym_re=np.float32([5]), sym_im=np.float32([6]),
                 valid=np.int32([1]), locked_once=np.int32([1]))]
    for case in (rows, []):
        got, want = {}, {}
        assert pack_rows(case, got, "p_") == jax_pack_rows(case, want, "p_")
        _assert_bitwise(got, want)

    class Z(dict):
        files = property(lambda self: list(self))

    back = unpack_rows(Z(got), "q_")
    assert back == []
    pack_rows(rows, got, "p_")
    (row,) = unpack_rows(Z(got), "p_")
    np.testing.assert_array_equal(row["sym_re"], [1, 2, 5])
    np.testing.assert_array_equal(row["valid"], [1, 0, 1])
