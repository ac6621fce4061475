"""Checkpoints moved between the two packages, on the CPU, against real files
of the JAX package (meteor_demod_tpu_torch/io/checkpoint.py against
meteor_demod_tpu/io/checkpoint.py).

JAX -> port: a fleet with a parked stream, a serving fleet with parked,
retired and deferred rows, and a multihost fleet, built with the JAX
package's own parking fixture (tests/test_parking.py: 8 streams, one noise
stream, park_after=3, block_len 2048), in QPSK and in OQPSK. Port -> JAX:
all four kinds in both modes. JAX -> port -> JAX keeps the policy fields.
The port's list of the fields the JAX loaders read (JAX_FIELDS) is held
against those loaders, and its parked-form writer against a JAX file.

The decision contract (ROADMAP list C): valid and locked_once bitwise, and
symbols within rtol=5e-4, atol=0.05 (int8 bytes within 1), on every stream
that is locked at the cut or locks after it. A stream that stays unlocked is
held on its locked_once; its symbols are held bitwise to the port's own run
from the same carry, since decisions before a lock follow the FIR's
summation order. Deferred rows are data and come out bitwise as stored.
"""

import dataclasses
import json
import re
import types

import jax
import numpy as np
import pytest

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod.pipeline import StreamDemodulator as JaxDemod
from meteor_demod_tpu.io import checkpoint as jax_ckpt
from meteor_demod_tpu.parallel.mesh import FleetDemodulator as JaxFleet
from meteor_demod_tpu.parallel.mesh import make_mesh
from meteor_demod_tpu.parallel.multihost import MultiHostFleet as JaxMultiHost
from meteor_demod_tpu.parallel.serving import ServingFleet as JaxServing
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.pipeline import StreamDemodulator, quantize
from meteor_demod_tpu_torch.demod.state import carry_from_numpy, carry_to_numpy
from meteor_demod_tpu_torch.io import checkpoint as ckpt
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.parallel.serialize import ROW_KEYS
from meteor_demod_tpu_torch.parallel.serving import ServingFleet

MODES = ("qpsk", "oqpsk")
PARK_L = 2048        # the JAX parking fixture's block
L = 1024             # port -> JAX: streams lock in their 9th block
NOISE, LATE = 5, 3   # the noise stream; the stream whose signal comes late


def _kw(mode):
    return dict(symrate=80000.0, oqpsk=True) if mode == "oqpsk" else {}


def _cfgs(mode, block_len):
    kw = dict(samplerate=230400, block_len=block_len, **_kw(mode))
    return JaxConfig(**kw), DemodConfig(**kw)


def _signal(cfg, n, carrier, seed, snr=22.0):
    x, _ = synth_psk(int(n * cfg.symrate / cfg.samplerate) + 64,
                     cfg.samplerate, symrate=cfg.symrate, oqpsk=cfg.oqpsk,
                     carrier_hz=carrier, amplitude=6000.0, snr_db=snr,
                     seed=seed)
    return x[:n]


def _noise(n, seed=99):
    rng = np.random.default_rng(seed)
    return (500.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _park_data(cfg, n_blocks, late=False):
    """tests/test_parking.py's mixed fleet: 8 streams at 60 + 15 i Hz and
    the noise stream NOISE; with `late`, stream LATE is noise for 12 blocks
    and then a pass (the fixture of its unpark test)."""
    n = n_blocks * cfg.block_len
    xs = [_noise(n) if i == NOISE else _signal(cfg, n, 60.0 + 15.0 * i,
                                               70 + i) for i in range(8)]
    if late:
        cut = 12 * cfg.block_len
        xs[LATE] = np.concatenate([_noise(cut, 7),
                                   _signal(cfg, n, 80.0, 123)[cut:]])
    return np.stack(xs)


def _lock_data(cfg, n_streams, n_blocks, seed0=70):
    n = n_blocks * cfg.block_len
    return np.stack([_signal(cfg, n, 8.0 * i, seed0 + i)
                     for i in range(n_streams)])


def _chain(data, span, c):
    return data[:, c * span:(c + 1) * span]


def _one_device():
    return make_mesh(jax.devices()[:1])


def _rows(z, prefix):
    """The rows stored under prefix in an open npz, as one dict."""
    return {k: np.asarray(z[f"{prefix}{k}"]) for k in ROW_KEYS}


def _cat_rows(parts):
    parts = [p for p in parts if len(p["valid"])]
    return {k: np.concatenate([p[k] for p in parts]) for k in ROW_KEYS}


def _quantized(rows):
    """Rows as a packed fleet's parked_output gives them."""
    out = dict(rows)
    for k in ("sym_re", "sym_im"):
        out[k] = quantize(rows[k].astype(np.float32)).astype(np.int8)
    return out


def _assert_rows_equal(got, want, msg=""):
    for k in ROW_KEYS:
        assert got[k].dtype == want[k].dtype, (msg, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def _syms(out):
    return ("sym_i", "sym_q") if hasattr(out, "sym_i") else ("sym_re",
                                                             "sym_im")


def _hold(got, want, held, msg, symbols=True):
    """The decision contract on one dispatch: port outputs `got`, JAX
    outputs `want` (either package's row layout); valid and locked_once on
    every stream, and with `symbols` the symbols of the streams `held`.

    Symbols are held on the first dispatch after a cut only: further on, a
    symbol whose timing gate fires within float rounding of a FIR tick can
    fire on the next tick in one package and not in the other (the two FIRs
    sum in different orders), and the loops take some hundreds of symbols
    to pull the two back together. valid and locked_once stay bitwise
    through such a near-tie; the port's own run from the same carry is held
    bitwise instead (_own)."""
    for k in ("valid", "locked_once"):
        np.testing.assert_array_equal(getattr(got, k),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{msg} {k}")
    if not symbols:
        return
    for k in _syms(got):
        a = getattr(got, k)[held].astype(np.float32)
        b = np.asarray(getattr(want, k))[held].astype(np.float32)
        v = got.valid[held].astype(bool)
        if k in ("sym_i", "sym_q"):
            assert np.abs(a[v] - b[v]).max(initial=0) <= 1, (msg, k)
        else:
            np.testing.assert_allclose(a[v], b[v], rtol=5e-4, atol=0.05,
                                       err_msg=f"{msg} {k}")


def _assert_outs_equal(got, want, msg=""):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(want, f.name),
                                      err_msg=f"{msg} {f.name}")


def _own(pcfg, leaves, spans, **kw):
    """The port's own run from numpy carry leaves (a batch axis of n
    streams) over spans (n, span) each: its outputs."""
    n = len(leaves["t_phase"])
    f = FleetDemodulator(pcfg, n, "cpu", **kw)
    f.carry = carry_from_numpy(leaves, "cpu")
    return [f.process_blocks(x) for x in spans]


def _spliced(z, prefix=""):
    """A capture's carry with each parked stream's host carry on its lane,
    as the JAX package's unpark splice puts it."""
    leaves = {k: v.copy() for k, v in _leaves(z, f"{prefix}carry_").items()}
    meta = ckpt._read_meta(z)
    fm = (meta["fleet"] if "fleet" in meta
          else meta["groups"][int(prefix[1:-1])])
    for i in fm["parked"]:
        for k, v in _leaves(z, f"{prefix}parked_{i}_carry_").items():
            leaves[k][int(i)] = v
    return leaves


def _lane_rows(outs, i):
    """Stream i's rows over several dispatches, as one dict."""
    a, b = _syms(outs[0])
    return {"sym_re": np.concatenate([getattr(o, a)[i] for o in outs]),
            "sym_im": np.concatenate([getattr(o, b)[i] for o in outs]),
            "valid": np.concatenate([o.valid[i] for o in outs]),
            "locked_once": np.concatenate([o.locked_once[i] for o in outs])}


def _leaves(z, prefix):
    n = len(prefix)
    return {k[n:]: np.asarray(z[k]) for k in z.files if k.startswith(prefix)}


def _drain(fleet):
    for g in getattr(fleet, "groups", [fleet]):
        g.wait_parked_drained()


# --------------------------------------------- JAX -> port: a parked fleet

PARK_CUT, PARK_MORE = 8, 3


@pytest.fixture(scope="module", params=MODES)
def jax_parked(request, tmp_path_factory):
    """A JAX fleet (the parking fixture) saved at the tick that parks the
    noise stream (`at_park`, nothing fed to it yet) and two blocks later
    (`path`), then run PARK_MORE blocks on: its outputs and the noise
    stream's whole deferred output."""
    mode = request.param
    jcfg, pcfg = _cfgs(mode, PARK_L)
    d = tmp_path_factory.mktemp(f"parked_{mode}")
    data = _park_data(jcfg, PARK_CUT + PARK_MORE)
    jf = JaxFleet(jcfg, 8, park_after=3)
    at_park = None
    for b in range(PARK_CUT):
        jf.process_blocks(_chain(data, PARK_L, b))
        _drain(jf)
        if at_park is None and len(jf.parked_streams()):
            at_park = str(d / "at_park.npz")
            jax_ckpt.save_fleet_checkpoint(at_park, jf)
    assert list(jf.parked_streams()) == [NOISE] and at_park is not None
    path = str(d / "parked.npz")
    jax_ckpt.save_fleet_checkpoint(path, jf)
    outs = [jf.process_blocks(_chain(data, PARK_L, b))
            for b in range(PARK_CUT, PARK_CUT + PARK_MORE)]
    _drain(jf)
    return types.SimpleNamespace(
        mode=mode, jcfg=jcfg, pcfg=pcfg, data=data, path=path,
        at_park=at_park, outs=outs, deferred=jf.parked_output(NOISE),
        locked_once=np.asarray(jf.carry.locked_once),
        noise_locked=int(jf._parked[NOISE].carry["locked_once"]))


def test_jax_parked_fleet_resumes_in_port(jax_parked):
    """The parked stream's host carry goes back onto its lane, its deferred
    rows come out of parked_output once, bitwise, and the next blocks hold
    the decision contract; the noise lane, never locked, is held on its
    locked_once against the JAX host program's rows and bitwise to the
    port's own run from the parked carry."""
    j = jax_parked
    fleet = ckpt.load_fleet_checkpoint(j.path, "cpu")
    assert fleet.parked_streams().size == 0
    fleet.wait_parked_drained()
    with np.load(j.path) as z:
        stored = _rows(z, f"parked_{NOISE}_rows_")
        parked_carry = _leaves(z, f"parked_{NOISE}_carry_")
        spliced = _spliced(z)
    assert len(stored["valid"]) > 0
    lane = {k: v[NOISE] for k, v in carry_to_numpy(fleet.carry).items()}
    for k, v in parked_carry.items():
        np.testing.assert_array_equal(lane[k], v, err_msg=k)
    got = fleet.parked_output(NOISE)
    _assert_rows_equal(got, stored, "deferred")
    n = len(stored["valid"])
    _assert_rows_equal(got, {k: v[:n] for k, v in j.deferred.items()},
                       "JAX parked_output")
    empty = fleet.parked_output(NOISE)
    assert all(len(v) == 0 for v in empty.values())
    assert [empty[k].dtype for k in ROW_KEYS] == [
        np.float32, np.float32, np.int32, np.int32]

    outs = [fleet.process_blocks(_chain(j.data, PARK_L, b))
            for b in range(PARK_CUT, PARK_CUT + PARK_MORE)]
    # The JAX fleet's lane of a parked stream holds a donor's copy; the
    # stream's own state is its host carry.
    assert not j.noise_locked
    lanes = [i for i in range(8) if i != NOISE]
    assert j.locked_once[lanes].all()
    for c, (g, w) in enumerate(zip(outs, j.outs)):
        _hold(type(g)(*(v[lanes] for v in dataclasses.astuple(g))),
              type(w)(*(np.asarray(v)[lanes] for v in w)),
              np.arange(len(lanes)), f"{j.mode} block {PARK_CUT + c}",
              symbols=c == 0)
    np.testing.assert_array_equal(_lane_rows(outs, NOISE)["locked_once"],
                                  j.deferred["locked_once"][n:])
    own = _own(j.pcfg, spliced, [_chain(j.data, PARK_L, b) for b in
                                 range(PARK_CUT, PARK_CUT + PARK_MORE)])
    for c, (g, w) in enumerate(zip(outs, own)):
        _assert_outs_equal(g, w, f"own run, block {PARK_CUT + c}")


def test_parked_form_writer_matches_a_jax_file(jax_parked, tmp_path):
    """write_parked_form turns the port's file of a fleet into the JAX
    package's parked form, key by key (names, dtypes, shapes; the carries
    bitwise) as the JAX fleet's own file at the tick it parked the
    stream; and loading it is loading the plain file."""
    j = jax_parked
    fleet = ckpt.load_fleet_checkpoint(j.at_park, "cpu")
    plain, form = str(tmp_path / "plain.npz"), str(tmp_path / "form.npz")
    ckpt.save_fleet_checkpoint(plain, fleet)
    ckpt.write_parked_form(plain, form, [NOISE])
    with np.load(j.at_park) as a, np.load(form) as b:
        ja, pa = jax_ckpt.json.loads(bytes(a["meta"]).decode()), \
            ckpt._read_meta(b)
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k == "meta":
                continue
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            if "carry_" in k:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert set(ja["fleet"]) <= set(pa["fleet"])
    assert pa["fleet"]["parked"] == ja["fleet"]["parked"]
    assert ckpt.jax_fields_missing(form) == []
    back = ckpt.load_fleet_checkpoint(form, "cpu")
    before, after = carry_to_numpy(fleet.carry), carry_to_numpy(back.carry)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_unresumable_parked_stream_is_refused(jax_parked, tmp_path):
    """A parked stream whose host carry is behind its fed blocks, or whose
    carry is missing, raises ValueError naming it; nothing is dropped."""
    with np.load(jax_parked.path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta"].tobytes()).decode())

    def write(name, m, a):
        a = dict(a, meta=np.frombuffer(json.dumps(m).encode(), np.uint8))
        p = str(tmp_path / name)
        np.savez(p, **a)
        return p

    behind = json.loads(json.dumps(meta))
    behind["fleet"]["parked"][str(NOISE)]["blocks_done"] -= 1
    with pytest.raises(ValueError, match=f"parked stream {NOISE}"):
        ckpt.load_fleet_checkpoint(write("behind.npz", behind, arrays),
                                   "cpu")
    gone = {k: v for k, v in arrays.items()
            if k != f"parked_{NOISE}_carry_p_freq"}
    with pytest.raises(ValueError, match=f"parked_{NOISE}_carry_p_freq"):
        ckpt.load_fleet_checkpoint(write("gone.npz", meta, gone), "cpu")


# ----------------------- JAX -> port: serving, parked, retired and deferred

SERVE_MORE = 2


@pytest.fixture(scope="module", params=MODES)
def jax_serving(request, tmp_path_factory):
    """A packed JAX ServingFleet (2 groups of 4, band 6, park_after 3) on
    the parking fixture with a late stream: both stragglers park; a block
    later their rows go to the stream-keyed store through the serving
    fleet's own drain (the one its sort runs; QPSK sorts as well, OQPSK
    never); the late stream
    locks on the host path and is spliced back (its rows retired). Saved
    the block after that (`path`), and its LATE group as a fleet file
    (`retired`); then run SERVE_MORE blocks on."""
    mode = request.param
    jcfg, pcfg = _cfgs(mode, PARK_L)
    d = tmp_path_factory.mktemp(f"serving_{mode}")
    data = _park_data(jcfg, 34, late=True)
    js = JaxServing(jcfg, 8, group_size=4, band=6, mesh=_one_device(),
                    park_after=3, packed_output=True)
    def parked(s):
        return int(js._lane_of[s]) in js.groups[int(js._group_of[s])]._parked

    was_parked, b = False, 0
    while True:
        js.process_blocks(_chain(data, PARK_L, b))
        b += 1
        _drain(js)
        g = js.groups[int(js._group_of[LATE])]
        lane = int(js._lane_of[LATE])
        if not was_parked and parked(LATE) and parked(NOISE):
            # One block on the host path for both, then into the store.
            js.process_blocks(_chain(data, PARK_L, b))
            b += 1
            _drain(js)
            js._drain_parked_rows()
            was_parked = True
        elif was_parked and lane in g._retired_rows:
            break
        assert b < 30, "the late stream never came back from parking"
    assert (mode == "qpsk") == js.sorted_once
    path, retired = str(d / "serving.npz"), str(d / "retired.npz")
    jax_ckpt.save_serving_checkpoint(path, js)
    jax_ckpt.save_fleet_checkpoint(retired, g)
    cut = b
    outs = [js.process_blocks(_chain(data, PARK_L, c))
            for c in range(cut, cut + SERVE_MORE)]
    _drain(js)
    return types.SimpleNamespace(
        mode=mode, pcfg=pcfg, data=data, path=path, retired=retired,
        cut=cut, outs=outs, js=js, late_lane=(int(js._group_of[LATE]), lane),
        deferred={s: js.parked_output(s) for s in (LATE, NOISE)})


def test_jax_serving_resumes_in_port(jax_serving):
    """Every deferred row (stream-keyed, retired and parked) comes out of
    parked_output in caller stream identity, quantized as the JAX host
    writes them, once; the next blocks hold the decision contract."""
    j = jax_serving
    serving = ckpt.load_serving_checkpoint(j.path, "cpu")
    with np.load(j.path) as z:
        meta = ckpt._read_meta(z)
        assert sorted(meta["deferred"]) == [LATE, NOISE]
        np.testing.assert_array_equal(serving._group_of, z["group_of"])
        np.testing.assert_array_equal(serving._lane_of, z["lane_of"])
        stored = {}
        for s in (LATE, NOISE):
            g, lane = int(z["group_of"][s]), int(z["lane_of"][s])
            kind = "retired" if s == LATE else "parked"
            stored[s] = _cat_rows([_rows(z, f"deferred_{s}_rows_"),
                                   _rows(z, f"g{g}_{kind}_{lane}_rows_")])
            assert len(z[f"g{g}_{kind}_{lane}_rows_valid"]) > 0, (s, kind)
        slots = z["group_of"] * 4 + z["lane_of"]
        spliced = [_spliced(z, f"g{g}_") for g in range(2)]
    for s in (LATE, NOISE):
        got = serving.parked_output(s)
        _assert_rows_equal(got, _quantized(stored[s]), f"stream {s}")
        n = len(stored[s]["valid"])
        _assert_rows_equal(got, _quantized(
            {k: v[:n] for k, v in j.deferred[s].items()}), f"JAX {s}")
        assert len(serving.parked_output(s)["valid"]) == 0
    assert len(j.deferred[LATE]["valid"]) == len(stored[LATE]["valid"])

    outs = [serving.process_blocks(_chain(j.data, PARK_L, c))
            for c in range(j.cut, j.cut + SERVE_MORE)]
    lanes = [i for i in range(8) if i != NOISE]
    for c, (g, w) in enumerate(zip(outs, j.outs)):
        _hold(type(g)(*(v[lanes] for v in dataclasses.astuple(g))),
              type(w)(*(np.asarray(v)[lanes] for v in w)),
              np.arange(len(lanes)), f"{j.mode} block {j.cut + c}",
              symbols=c == 0)
    n = len(stored[NOISE]["valid"])
    np.testing.assert_array_equal(_lane_rows(outs, NOISE)["locked_once"],
                                  j.deferred[NOISE]["locked_once"][n:])
    # The port's own run of each group from the same carries, its rows put
    # back in caller order through the saved assignment.
    own = [_own(j.pcfg, spliced[g], [
        _chain(j.data[np.argsort(slots)][4 * g:4 * g + 4], PARK_L, c)
        for c in range(j.cut, j.cut + SERVE_MORE)], packed_output=True)
        for g in range(2)]
    for c, got in enumerate(outs):
        cat = [np.concatenate([dataclasses.astuple(own[g][c])[f]
                               for g in range(2)])[slots]
               for f in range(4)]
        _assert_outs_equal(got, type(got)(*cat), f"own run {j.cut + c}")


def test_jax_retired_fleet_resumes_in_port(jax_serving):
    """A fleet file whose stream came back from parking: its retired rows
    come out once, bitwise, and its lanes' carries are the file's."""
    j = jax_serving
    fleet = ckpt.load_fleet_checkpoint(j.retired, "cpu")
    lane = j.late_lane[1]
    with np.load(j.retired) as z:
        stored = _rows(z, f"retired_{lane}_rows_")
        carry = _leaves(z, "carry_")
    _assert_rows_equal(fleet.parked_output(lane), _quantized(stored))
    assert len(fleet.parked_output(lane)["valid"]) == 0
    got = carry_to_numpy(fleet.carry)
    for k in got:
        np.testing.assert_array_equal(got[k], carry[k], err_msg=k)


def test_policy_fields_survive_jax_port_jax(jax_serving, tmp_path):
    """JAX -> port -> JAX: the JAX ServingFleet's policy fields come back
    as they were, and so do the rows the port did not deliver."""
    j = jax_serving
    serving = ckpt.load_serving_checkpoint(j.path, "cpu")
    back = str(tmp_path / "back.npz")
    ckpt.save_serving_checkpoint(back, serving)
    assert ckpt.jax_fields_missing(back) == []
    with np.load(j.path) as a, np.load(back) as b:
        ja, pa = ckpt._read_meta(a), ckpt._read_meta(b)
    for k in ("band", "sorted_once", "resort_wanted", "n_streams",
              "group_size"):
        assert pa[k] == ja[k], k
    for gj, gp in zip(ja["groups"], pa["groups"]):
        for k in ("axis_name", "backend", "park", "park_after",
                  "unpark_after", "park_max", "flap_park", "banded_cfg",
                  "recover_flagged", "telemetry_every", "chain_blocks",
                  "ingest", "packed_output", "block_idx"):
            assert gp[k] == gj[k], k
    js = jax_ckpt.load_serving_checkpoint(back, mesh=_one_device())
    assert js.band == 6 and js.sorted_once == j.js.sorted_once
    for f, ref in zip(js.groups, j.js.groups):
        assert (f.park_after, f.unpark_after, f.park_max, f.flap_park,
                f.park_enabled) == (3, ref.unpark_after, ref.park_max,
                                    ref.flap_park, True)
        assert (f.banded_cfg is None) == (ref.banded_cfg is None)
    for s in (LATE, NOISE):
        got = js.parked_output(s)
        n = len(got["valid"])
        assert n > 0
        _assert_rows_equal(got, {k: v[:n] for k, v in j.deferred[s].items()},
                           f"stream {s}")


# ----------------------------------- multihost, JAX -> port -> JAX, both modes

@pytest.mark.parametrize("mode", MODES)
def test_multihost_both_ways(mode, tmp_path):
    """A JAX MultiHostFleet's file (flat meta: no local fleet's meta, no
    rank) resumes in the port at the same topology (8 shards of one stream
    on the CPU), and the port's file resumes in the JAX package, each for
    the block where the streams lock, under the decision contract."""
    jcfg, pcfg = _cfgs(mode, L)
    cut = 8
    data = _lock_data(jcfg, 8, cut + 2)
    jm = JaxMultiHost(jcfg, 1, telemetry_every=2)
    for b in range(cut):
        jm.process_local_blocks(_chain(data, L, b))
    first = str(tmp_path / "jax_mh.npz")
    jax_ckpt.save_multihost_checkpoint(first, jm)
    ref = [jm.process_local_blocks(_chain(data, L, b))
           for b in (cut, cut + 1)]
    locked = np.asarray(jm.carry.locked_once).astype(bool)
    assert locked.all()

    pm = ckpt.load_multihost_checkpoint(first, mesh=["cpu"] * 8)
    assert (pm.n_local, pm._fleet._block_idx) == (8, cut)
    _hold(pm.process_local_blocks(_chain(data, L, cut)), ref[0],
          np.arange(8), f"{mode} port block {cut}")
    second = str(tmp_path / "port_mh.npz")
    ckpt.save_multihost_checkpoint(second, pm)
    assert ckpt.jax_fields_missing(second) == []
    jm2 = jax_ckpt.load_multihost_checkpoint(second)
    assert jm2._block_idx == cut + 1 and jm2.telemetry_every == 2
    got = pm.process_local_blocks(_chain(data, L, cut + 1))
    _hold(got, jm2.process_local_blocks(_chain(data, L, cut + 1)),
          np.arange(8), f"{mode} JAX block {cut + 1}")
    _hold(got, ref[1], np.arange(8), f"{mode} uninterrupted {cut + 1}",
          symbols=False)


# --------------------------------------- port -> JAX: stream, fleet, serving

@pytest.mark.parametrize("mode", MODES)
def test_port_stream_resumes_in_jax(mode, tmp_path):
    """The port's stream file has the JAX stream carry (no batch axis): the
    JAX StreamDemodulator resumes it, and the rest of the stream comes out
    with the port's decisions."""
    jcfg, pcfg = _cfgs(mode, L)
    x = _lock_data(jcfg, 1, 11)[0]
    split = 8 * L + 300
    d = StreamDemodulator(pcfg, "cpu")
    d.process(x[:split])
    path = str(tmp_path / "stream.npz")
    ckpt.save_checkpoint(path, d)
    assert ckpt.jax_fields_missing(path) == []
    with np.load(path) as z:
        assert z["carry_t_phase"].shape == ()
    jd = jax_ckpt.load_checkpoint(path)
    want = np.concatenate([jd.process(x[split:]), jd.finish()])
    got = np.concatenate([d.process(x[split:]), d.finish()])
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got["locked_once"], want["locked_once"])
    assert got["locked_once"].any()
    np.testing.assert_allclose(got["re"], want["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], want["im"], rtol=5e-4, atol=0.05)
    assert jd.symbols_out == d.symbols_out


@pytest.mark.parametrize("mode", MODES)
def test_port_serving_and_fleet_resume_in_jax(mode, tmp_path):
    """A ServingFleet the port made (2 groups of 2, chains of 2, telemetry
    every 2) saved unlocked; its file and its first group's fleet file
    resume in the JAX package, with the JAX constructor's policy defaults,
    and the chain where the streams lock holds the decision contract."""
    jcfg, pcfg = _cfgs(mode, L)
    K, cut = 2, 4
    data = _lock_data(jcfg, 4, K * (cut + 1))
    span = K * L
    serving = ServingFleet(pcfg, 4, group_size=2, device="cpu",
                           chain_blocks=K, telemetry_every=2)
    for c in range(cut):
        serving.process_blocks(_chain(data, span, c))
    assert not carry_to_numpy(serving.groups[0].carry)["locked_once"].any()
    spath, fpath = str(tmp_path / "serving.npz"), str(tmp_path / "fleet.npz")
    ckpt.save_serving_checkpoint(spath, serving)
    ckpt.save_fleet_checkpoint(fpath, serving.groups[0])
    assert ckpt.jax_fields_missing(spath) == []
    assert ckpt.jax_fields_missing(fpath) == []

    js = jax_ckpt.load_serving_checkpoint(spath, mesh=_one_device())
    jf = jax_ckpt.load_fleet_checkpoint(fpath, mesh=_one_device())
    default = JaxFleet(jcfg, 2, mesh=_one_device())
    for f in js.groups + [jf]:
        assert (f.park_enabled, f.park_after, f.unpark_after, f.park_max,
                f.flap_park, f._backend, f.axis_name) == (
            default.park_enabled, default.park_after, default.unpark_after,
            default.park_max, default.flap_park, "auto", default.axis_name)
        assert (f.chain_blocks, f.telemetry_every, f._block_idx) == (
            K, 2, cut)
    assert js.band == 8 and not js.sorted_once

    x = _chain(data, span, cut)
    got = serving.process_blocks(x)
    _hold(got, js.process_blocks(x), np.arange(4), f"{mode} serving")
    _hold(type(got)(*(v[:2] for v in dataclasses.astuple(got))),
          jf.process_blocks(x[:2]), np.arange(2), f"{mode} fleet")
    assert carry_to_numpy(serving.groups[0].carry)["locked_once"].all()


# ----------------------------------------------------- the list of fields

class _Reads(dict):
    """A meta dict that logs every key read through it, as a dotted path."""

    def __init__(self, d, path, log):
        super().__init__(d)
        self._path, self._log = path, log

    def __getitem__(self, k):
        self._log.add(f"{self._path}{k}")
        return _node(super().__getitem__(k), f"{self._path}{k}.", self._log)

    def get(self, k, default=None):
        self._log.add(f"{self._path}{k}")
        return self[k] if k in self else default

    def items(self):
        return [(k, _node(v, f"{self._path}*.", self._log))
                for k, v in super().items()]


class _ReadsList(list):
    def __init__(self, v, path, log):
        super().__init__(v)
        self._path, self._log = path, log

    def __getitem__(self, i):
        return _node(super().__getitem__(i), self._path, self._log)

    def __iter__(self):
        return (_node(v, self._path, self._log) for v in list.__iter__(self))


def _node(v, path, log):
    if isinstance(v, dict):
        return _Reads(v, path, log)
    if isinstance(v, list):
        return _ReadsList(v, f"{path}[].", log)
    return v


_PLACES = ((r"^g\d+_", "g{g}_"), (r"parked_\d+_", "parked_{i}_"),
           (r"retired_\d+_", "retired_{i}_"),
           (r"^deferred_\d+_", "deferred_{s}_"))


def _jax_reads(monkeypatch, loader, path, **kw):
    """The fields the JAX loader reads from the file at path."""
    log = set()
    real_load, real_loads = np.load, json.loads
    monkeypatch.setattr(jax_ckpt, "json", types.SimpleNamespace(
        loads=lambda s: _Reads(real_loads(s), "", log)))

    def load(p, *a, **k):
        return _Recorded(real_load(p, *a, **k), log)

    monkeypatch.setattr(np, "load", load)
    try:
        loader(path, **kw)
    finally:
        monkeypatch.setattr(np, "load", real_load)
        monkeypatch.setattr(jax_ckpt, "json", json)
    return log


class _Recorded:
    """An open npz that logs every array read, with its indices replaced by
    the placeholders of JAX_FIELDS."""

    def __init__(self, z, log):
        self._z, self._log, self.files = z, log, z.files

    def __getitem__(self, k):
        if k != "meta":
            name = k
            for pat, rep in _PLACES:
                name = re.sub(pat, rep, name)
            self._log.add(f"array:{name}")
        return self._z[k]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._z.close()


def _listed(kind):
    meta, arrays = ckpt.JAX_FIELDS[kind]
    return set(meta) | {f"array:{a}" for a in arrays}


@pytest.mark.parametrize("jax_parked, jax_serving", [(m, m) for m in MODES],
                         indirect=True, ids=MODES)
def test_field_list_is_what_the_jax_loaders_read(jax_parked, jax_serving,
                                                 monkeypatch, tmp_path):
    """JAX_FIELDS, kind by kind, is exactly what the JAX package's loaders
    read from its own files that hold every optional part (a backlog,
    parked, retired and deferred rows), and every field they read from a
    file the port wrote is on the list."""
    jcfg, _ = _cfgs(jax_parked.mode, L)
    x = _lock_data(jcfg, 1, 3)[0]
    jd = JaxDemod(jcfg)
    jd.process(x[:2 * L + 100])
    stream = str(tmp_path / "stream.npz")
    jax_ckpt.save_checkpoint(stream, jd)
    jm = JaxMultiHost(jcfg, 1)
    jm.process_local_blocks(_lock_data(jcfg, 8, 1))
    mh = str(tmp_path / "mh.npz")
    jax_ckpt.save_multihost_checkpoint(mh, jm)
    one = dict(mesh=_one_device())
    reads = {
        "stream": _jax_reads(monkeypatch, jax_ckpt.load_checkpoint, stream),
        "fleet": (_jax_reads(monkeypatch, jax_ckpt.load_fleet_checkpoint,
                             jax_parked.path, **one)
                  | _jax_reads(monkeypatch, jax_ckpt.load_fleet_checkpoint,
                               jax_serving.retired, **one)),
        "serving": _jax_reads(monkeypatch, jax_ckpt.load_serving_checkpoint,
                              jax_serving.path, **one),
        "multihost": _jax_reads(monkeypatch,
                                jax_ckpt.load_multihost_checkpoint, mh),
    }
    for kind, got in reads.items():
        assert got == _listed(kind), (kind, got ^ _listed(kind))

    serving = ckpt.load_serving_checkpoint(jax_serving.path, "cpu")
    port = str(tmp_path / "port_serving.npz")
    ckpt.save_serving_checkpoint(port, serving)
    fleet = str(tmp_path / "port_fleet.npz")
    ckpt.save_fleet_checkpoint(fleet, serving.groups[0])
    for kind, loader, path in (
            ("serving", jax_ckpt.load_serving_checkpoint, port),
            ("fleet", jax_ckpt.load_fleet_checkpoint, fleet)):
        assert ckpt.jax_fields_missing(path) == []
        assert _jax_reads(monkeypatch, loader, path, **one) <= _listed(kind)


def test_port_fleet_policy_is_the_jax_constructors():
    """A fleet the port made writes the JAX FleetDemodulator's constructor
    defaults, and a ServingFleet the JAX ServingFleet's band."""
    jcfg, pcfg = _cfgs("qpsk", L)
    for n in (4, 64):
        meta, arrays = FleetDemodulator(pcfg, n, "cpu").state_dict()
        jf = JaxFleet(jcfg, n, mesh=_one_device())
        assert (meta["axis_name"], meta["park"], meta["park_after"],
                meta["unpark_after"], meta["park_max"], meta["flap_park"],
                meta["banded_cfg"]) == (
            jf.axis_name, jf.park_enabled, jf.park_after, jf.unpark_after,
            jf.park_max, jf.flap_park, None)
        assert (meta["parked"], meta["retired"], meta["tick_idx"]) == (
            {}, [], 0)
        for k in ("unlock_streak", "flap_count"):
            assert arrays[k].dtype == jf._unlock_streak.dtype
            assert not arrays[k].any()
    assert ServingFleet(pcfg, 4, group_size=4, device="cpu").band == \
        JaxServing(jcfg, 4, group_size=4, mesh=_one_device()).band
