"""The port's fleet over a device list (FleetDemodulator / ServingFleet /
the checkpoint loaders with mesh=) on the CPU, where a list of "cpu"
repeated is a valid mesh, against the one-device port and the JAX package.

Sharding the stream axis runs the same per-shard program on fewer rows, so
every sharded result is bitwise the one-device port's (the weak-scaling
invariance of tests/test_multihost.py::test_weak_scaling_work_invariance
and tests/test_parallel.py::test_fleet_matches_unsharded); against the JAX
FleetDemodulator on make_mesh(jax.devices()[:k]) decisions are bitwise,
float carry leaves within rtol=5e-4, atol=1e-3 and soft symbols (magnitude
~130) within rtol=5e-4, atol=0.05, tests/test_torch_fleet.py's contract
(XLA fuses multiplies and adds the port rounds separately). The telemetry
combines on the host: integer sums exact, mean_agc_gain (the mean of the
shard means, as pmean) within rtol=1e-6 of one device. The host <-> card
copies' repair is held on every visible card in a `gpu` case.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.pipeline import egress
from meteor_demod_tpu.parallel.mesh import FleetDemodulator as JaxFleet
from meteor_demod_tpu.parallel.mesh import make_mesh as jax_make_mesh
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch import cli
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.state import carry_to_numpy
from meteor_demod_tpu_torch.io.checkpoint import (load_fleet_checkpoint,
                                                  load_serving_checkpoint,
                                                  save_fleet_checkpoint,
                                                  save_serving_checkpoint)
from meteor_demod_tpu_torch.parallel import mesh as mesh_mod
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.parallel.serving import ServingFleet
from meteor_demod_tpu_torch.utils import (STAGE_BYTES, make_mesh, to_device,
                                          to_host)

L = 1024
SPD = 2                     # streams a shard in the weak-scaling case
_OUT = ("sym_re", "sym_im", "valid", "locked_once")
_DECISION_LEAVES = ("locked", "locked_once", "flags", "slot", "tick")
_FLOAT_LEAVES = ("t_phase", "t_freq", "p_freq", "agc_gain", "inphase")
CFG = DemodConfig(samplerate=230400, block_len=L)


def _data(n_streams, n_blocks, seed0=70):
    """(n_streams, n_blocks*L) complex64, carriers 40 + 10*g Hz, 22 dB."""
    n = n_blocks * L
    return np.stack([synth_psk(int(n * 72000 / 230400) + 64, 230400,
                               carrier_hz=40.0 + 10.0 * g, amplitude=6000.0,
                               snr_db=22.0, seed=seed0 + g)[0][:n]
                     for g in range(n_streams)])


def _blocks(data, n_blocks):
    return [data[:, b * L:(b + 1) * L] for b in range(n_blocks)]


def _bitwise(got, want, msg=""):
    for k in _OUT:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, (msg, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


def _same_telemetry(a: dict, b: dict) -> None:
    """Integer values equal, mean_agc_gain within rtol=1e-6: the mean of
    the shard means rounds differently for another shard count."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "mean_agc_gain":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        else:
            assert a[k] == b[k], k


def _same_carry(a, b, msg=""):
    ca, cb = carry_to_numpy(a.carry), carry_to_numpy(b.carry)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=f"{msg} {k}")


# ------------------------------------------- weak scaling, against the JAX

@pytest.fixture(scope="module")
def weak():
    """16 streams, 2 blocks, through the one-device port."""
    data = _data(8 * SPD, 2)
    one = FleetDemodulator(CFG, 8 * SPD, device="cpu")
    outs = [one.process_blocks(b) for b in _blocks(data, 2)]
    return data, outs, carry_to_numpy(one.carry)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_weak_scaling_bitwise_and_against_jax(weak, k):
    data, want, want_carry = weak
    n = SPD * k
    fleet = FleetDemodulator(CFG, n, mesh=["cpu"] * k)
    assert fleet.mesh == [torch.device("cpu")] * k
    jfleet = JaxFleet(JaxConfig(samplerate=230400, block_len=L), n,
                      mesh=jax_make_mesh(jax.devices()[:k]),
                      backend="scan", park=False)
    for b, blk in enumerate(_blocks(data[:n], 2)):
        got = fleet.process_blocks(blk)
        ref = dataclasses.replace(want[b], **{
            f: getattr(want[b], f)[:n] for f in _OUT})
        _bitwise(got, ref, f"k={k} block {b}")
        j = {f: np.asarray(v) for f, v in
             egress(jfleet.process_blocks(blk))._asdict().items()}
        for f in ("valid", "locked_once"):
            np.testing.assert_array_equal(getattr(got, f), j[f],
                                          err_msg=f"k={k} block {b} {f}")
        np.testing.assert_array_equal(got.valid.sum(1), j["valid"].sum(1))
        for f in ("sym_re", "sym_im"):
            v = got.valid.astype(bool)
            np.testing.assert_allclose(getattr(got, f)[v], j[f][v],
                                       rtol=5e-4, atol=0.05,
                                       err_msg=f"k={k} block {b} {f}")
    carry = carry_to_numpy(fleet.carry)
    jcarry = egress(jfleet.carry)._asdict()
    for f in carry:
        np.testing.assert_array_equal(carry[f], want_carry[f][:n],
                                      err_msg=f"k={k} carry {f}")
    for f in _DECISION_LEAVES:
        np.testing.assert_array_equal(carry[f], np.asarray(jcarry[f]))
    for f in _FLOAT_LEAVES:
        np.testing.assert_allclose(carry[f], np.asarray(jcarry[f]),
                                   rtol=5e-4, atol=1e-3, err_msg=f)
    for f in ("locked_streams", "locked_once_streams", "symbols", "flags"):
        assert int(fleet.telemetry[f]) == int(jfleet.telemetry[f]), f


# ------------------------------------------------------------- telemetry

def test_telemetry_combined_on_the_host():
    data = _data(8, 1, seed0=60)
    one = FleetDemodulator(CFG, 8, device="cpu")
    four = FleetDemodulator(CFG, 8, mesh=["cpu"] * 4)
    outs = four.process_blocks(data)
    _bitwise(outs, one.process_blocks(data))
    _same_telemetry(four.telemetry, one.telemetry)
    for k, v in four.telemetry.items():
        assert v.dtype == (np.float32 if k == "mean_agc_gain" else np.int32)
    assert four.telemetry["symbols"] == outs.valid.sum()
    gains = carry_to_numpy(four.carry)["agc_gain"].reshape(4, 2).mean(1)
    np.testing.assert_allclose(four.telemetry["mean_agc_gain"], gains.mean(),
                               rtol=1e-6)
    assert four.stream_flags.shape == (8,) and not four.flagged_streams().size


def test_telemetry_amortized_matches_per_block():
    """test_parallel.py:88 on 2 shards: telemetry_every=3 changes no output
    or carry, and the telemetry moves on ticks 0 and 3 only."""
    n_blocks, K = 5, 3
    data = _data(4, n_blocks, seed0=80)
    ref = FleetDemodulator(CFG, 4, mesh=["cpu"] * 2)
    amo = FleetDemodulator(CFG, 4, mesh=["cpu"] * 2, telemetry_every=K)
    seen = []
    for b, blk in enumerate(_blocks(data, n_blocks)):
        _bitwise(amo.process_blocks(blk), ref.process_blocks(blk), f"{b}")
        if b % K == 0:
            assert amo.telemetry == ref.telemetry, b
        seen.append(dict(amo.telemetry))
        assert amo.stream_flags.shape == (4,)
    assert seen[1] == seen[0] and seen[2] == seen[0]
    assert seen[3]["symbols"] != seen[0]["symbols"]
    _same_carry(amo, ref)


# ------------------------------------------------------------ bad shapes

def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="divisible by mesh size 2"):
        FleetDemodulator(CFG, 3, mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        FleetDemodulator(CFG, 4, "cpu", mesh=["cpu"] * 2)
    with pytest.raises(ValueError):
        ServingFleet(CFG, 6, group_size=3, mesh=["cpu"] * 2)
    fleet = FleetDemodulator(CFG, 4, mesh=["cpu"] * 2)
    with pytest.raises(ValueError):
        fleet.process_blocks(np.zeros((2, L), dtype=np.complex64))
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError):
        make_mesh("cpu")


def test_make_mesh_default(monkeypatch):
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    assert make_mesh() == make_mesh("auto") == [torch.device("cpu")]
    assert FleetDemodulator(CFG, 2).mesh == [torch.device("cpu")]
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.delenv("METEOR_DEMOD_PLATFORM")
    if torch.cuda.is_available():
        assert make_mesh() == [torch.device("cuda", i) for i in
                               range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


# ------------------------------------------------------ recovery on a shard

def test_flag_in_one_shard_recovered_on_its_rows(monkeypatch):
    """A flag forced on stream 3 (shard 1 of 2): stream 3 is replayed by the
    oracle as on one device, shard 0's rows and carry are not rewritten."""
    data = _data(4, 2, seed0=90)
    blocks = _blocks(data, 2)
    one = FleetDemodulator(CFG, 4, device="cpu")
    two = FleetDemodulator(CFG, 4, mesh=["cpu"] * 2)
    clean = FleetDemodulator(CFG, 4, device="cpu")
    for f in (one, two, clean):
        f.process_blocks(blocks[0])
    for f in (one, two):
        c = f.carry
        flags = c.flags.clone()
        flags[3] |= 2
        f.carry = dataclasses.replace(c, flags=flags)
    rebuilt = []
    real = mesh_mod.carry_from_numpy
    monkeypatch.setattr(mesh_mod, "carry_from_numpy", lambda leaves, dev:
                        rebuilt.append(len(leaves["t_phase"]))
                        or real(leaves, dev))
    shard0 = two._carries[0]
    got = two.process_blocks(blocks[1])
    assert rebuilt == [2], rebuilt                 # shard 1 only
    assert two._carries[0] is not shard0           # the step's new carry ...
    want = one.process_blocks(blocks[1])
    _bitwise(got, want)
    _same_carry(two, one)
    assert list(two.flagged_streams()) == [3] and two.recovered_streams == 1
    _same_telemetry(two.telemetry, one.telemetry)
    assert two.telemetry["flags"] == 0
    # ... and shard 0's rows are those of a fleet that never flagged.
    ok = clean.process_blocks(blocks[1])
    for k in _OUT:
        np.testing.assert_array_equal(getattr(got, k)[:2],
                                      getattr(ok, k)[:2], err_msg=k)
    np.testing.assert_array_equal(
        carry_to_numpy(two._carries[0])["p_phase"],
        carry_to_numpy(clean.carry)["p_phase"][:2])


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("kind", ["fleet", "serving"])
@pytest.mark.parametrize("shards", [(1, 2), (2, 1)], ids=["1to2", "2to1"])
def test_checkpoint_moves_between_shard_counts(tmp_path, kind, shards):
    """Saved on one device list, resumed on another: the next block bitwise
    equal to the uninterrupted run's, outputs and carry."""
    save_on, load_on = (["cpu"] * n for n in shards)
    data = _data(8, 2, seed0=100)
    blocks = _blocks(data, 2)
    path = str(tmp_path / "ck.npz")
    if kind == "fleet":
        a = FleetDemodulator(CFG, 8, mesh=save_on, chain_blocks=1)
        a.process_blocks(blocks[0])
        save_fleet_checkpoint(path, a)
        b = load_fleet_checkpoint(path, mesh=load_on)
        assert b.mesh == [torch.device("cpu")] * shards[1]
        pairs = [(a, b)]
    else:
        a = ServingFleet(CFG, 8, group_size=4, mesh=save_on)
        a.process_blocks(blocks[0])
        save_serving_checkpoint(path, a)
        b = load_serving_checkpoint(path, mesh=load_on)
        assert b.mesh == [torch.device("cpu")] * shards[1]
        pairs = list(zip(a.groups, b.groups))
    _bitwise(b.process_blocks(blocks[1]), a.process_blocks(blocks[1]))
    for fa, fb in pairs:
        _same_carry(fb, fa)
        _same_telemetry(fb.telemetry, fa.telemetry)
        assert fb._block_idx == fa._block_idx == 2


def test_serving_fleet_over_a_mesh():
    data = _data(8, 1, seed0=110)
    one = ServingFleet(CFG, 8, group_size=4, device="cpu")
    two = ServingFleet(CFG, 8, group_size=4, mesh=["cpu"] * 2)
    assert two.mesh == [torch.device("cpu")] * 2
    assert all(len(g._shards) == 2 for g in two.groups)
    _bitwise(two.process_blocks(data), one.process_blocks(data))


# ------------------------------------------------------- the CLI's -T 0

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_turbo_lanes_against_the_reference_formula(n_dev):
    """cli.py:465-470 of the JAX package: clip to [1, 128 * n_dev], then a
    count of at least n_dev snaps down to a multiple of n_dev."""
    for n in (5000, 3 * 32 * 8192, 27648000, 200 * 32 * 8192, 10 ** 9):
        chunks = int(np.clip(n // (32 * 8192), 1, 128 * n_dev))
        if chunks >= n_dev:
            chunks -= chunks % n_dev
        assert cli.turbo_lanes(n, 8192, n_dev) == chunks, (n, n_dev)
    if n_dev == 1:
        assert cli.turbo_lanes(27648000, 8192, 1) == 105
        assert cli.turbo_lanes(27648000, 8192) == 105


# ------------------------------------------------------------- the card

@pytest.mark.gpu
def test_copies_to_every_card_round_trip():
    """utils.to_device / to_host on each visible card with another card (or
    none) current: more than two STAGE_BYTES pieces up, so the pinned
    buffers are reused and must be guarded by that card's events; then a
    readback of every card's tensor at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    rng = np.random.default_rng(1)
    rows = (5 * STAGE_BYTES) // (4 * 2 * 1024) + 3
    a = rng.standard_normal((rows, 1024, 2)).astype(np.float32)
    cards = make_mesh()
    up = []
    for i, dev in enumerate(cards):
        with torch.cuda.device(cards[(i + 1) % len(cards)]):
            t = to_device(a, dev)
        assert t.device == dev
        up.append(t * 1)
    for t, back in zip(up, to_host(up)):
        np.testing.assert_array_equal(back, a, err_msg=str(t.device))
