"""The port's bench (meteor_demod_tpu_torch/bench.py) on the CPU.

Its helpers and inline workloads against the root bench.py (the JAX
package's bench: its functions are read from the file with ast and run with
the JAX package's synth_psk, since importing the file would configure JAX's
compilation cache; a section's workload is read by running the root's
section and the port's on a synth_psk that records its calls, each until it
has built its blocks, and also against numbers written out from the root's
lines), each section at a tiny size on device="cpu" with its
checks passing and raising on a set flag or a corrupted output, the lock
steps of the acquisition against the numpy oracles fed the port's FIR
output (as tests/torch_oracle_checks.py feeds them), the JSON line's keys
against the root bench's literal, and main(): no card, no line; a section
that fails, no line. Numbers measured here are CPU times and are never
checked as rates. The one `gpu` test runs the headline on the card as
main() does and skips without one; the JAX package is imported inside the tests that use it, so
that the GPU machine (no jax) can run it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_bench.py
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meteor_demod_tpu_torch import bench
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import scalar
from meteor_demod_tpu_torch.demod.turbo import SpanPending, TurboResult

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_BENCH = os.path.join(ROOT, "bench.py")
FS = 230400
# The tiny size: block_len 1024, 4 streams, 2 blocks a chained call, one
# window; carriers near 0 Hz, so that a stream locks within ~10 blocks.
TINY = DemodConfig(samplerate=FS, block_len=1024)
TINY_SPAN = DemodConfig(samplerate=FS, block_len=512)
B, CHAIN = 4, 2
SMALL = dict(device="cpu", chain=CHAIN)


def root_tree() -> ast.Module:
    with open(ROOT_BENCH) as f:
        return ast.parse(f.read())


def root_function(name: str, **names):
    """A function of the root bench.py beside the root's constants, run on
    the JAX package's sim and iq_to_f32, or on the stand-ins in `names`."""
    from meteor_demod_tpu import sim as jax_sim
    from meteor_demod_tpu.dsp.fir import iq_to_f32
    tree = root_tree()
    consts = [n for n in tree.body if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Constant)]
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {"np": np, "synth_psk": jax_sim.synth_psk, "iq_to_f32": iq_to_f32,
          **names}
    exec(compile(ast.Module(consts + [fn], []), ROOT_BENCH, "exec"), ns)
    return ns[name]


class Enough(Exception):
    """Raised by a stand-in once the workload has been read."""


def recording_synth(calls: list):
    """A synth_psk that records each call's workload (its arguments: symbol
    count, carrier, ramp, SNR, seed) and returns a constant signal that
    names the call (seed + 1j * snr_db), long enough for the caller."""
    def synth_psk(nsym, samplerate, **kw):
        calls.append(dict(nsym=nsym, samplerate=samplerate, **kw))
        n = int(nsym * samplerate / kw["symrate"]) + 1
        return np.full(n, kw["seed"] + 1j * kw["snr_db"], np.complex64), None
    return synth_psk


class RootJnp:
    """The root's jnp up to the first device array it builds from the
    workload: asarray records its argument, take gives numpy's take and
    raises Enough, any other function raises Enough."""

    def __init__(self):
        self.arrays, self.taken = [], None

    def asarray(self, x):
        self.arrays.append(np.asarray(x))
        return self.arrays[-1]

    def take(self, g, idx, axis):
        self.taken = np.take(g, np.asarray(idx), axis=axis)
        raise Enough

    def __getattr__(self, name):
        raise Enough


def root_workload(name: str, *args, **kw):
    """Run the root bench.py's `name` on a recording synth_psk and RootJnp
    until it has built its workload: (synth calls, RootJnp)."""
    calls, jnp = [], RootJnp()
    fn = root_function(name, synth_psk=recording_synth(calls), jnp=jnp,
                       jax=SimpleNamespace(jit=lambda f: f))
    with pytest.raises(Enough):
        fn(*args, **kw)
    return calls, jnp


def port_workload(monkeypatch, name: str, stop: str, *args, maker=False,
                  **kw):
    """Run the port's section `name` on a recording synth_psk until it hands
    its workload to `stop` (a name in bench, replaced by a recorder that
    raises Enough; with maker, `stop` makes the function so replaced):
    (synth calls, the arguments that function was given)."""
    calls, given = [], []

    def recorder(*a, **k):
        given.append((a, k))
        raise Enough

    monkeypatch.setattr(bench, "synth_psk", recording_synth(calls))
    monkeypatch.setattr(bench, stop, (lambda *a, **k: recorder) if maker
                        else recorder)
    with pytest.raises(Enough):
        getattr(bench, name)(*args, device="cpu", **kw)
    return calls, given[0]


def root_dict_keys(func: str) -> set:
    """Keys a root bench function's result dict `out` (or the json.dumps
    literal of main) can hold: the literal's and those assigned later."""
    fn = next(n for n in root_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  "") == "dumps":
            keys |= {k.value for k in node.args[0].keys}
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if (isinstance(t, ast.Name) and t.id == "out"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "out"):
                keys.add(t.slice.value)
    return keys


def absent(field: str) -> set:
    """ABSENT_ON_PORT's names inside the line's field `field`."""
    return {k.split(".", 1)[1] for k in bench.ABSENT_ON_PORT
            if k.startswith(field + ".")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain recurrence at 4 streams runs many tiny ops a step: one
    thread is faster than many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- helpers and workloads against the root bench.py

@pytest.mark.parametrize("kw,seed", [({}, 0), ({}, 7),
                                     (dict(symrate=80000.0, oqpsk=True), 0)])
def test_make_signal_bitwise_to_root(kw, seed):
    from meteor_demod_tpu.config import DemodConfig as JaxConfig
    got = bench._make_signal(DemodConfig(samplerate=FS, **kw), 20000, seed)
    want = root_function("_make_signal")(JaxConfig(samplerate=FS, **kw),
                                         20000, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("rates", [[3.1e8, 1.2e8, 2.5e8],
                                   [7.0e6, 1.0e6, 4.0e6, 2.0e6], [5.5e7]])
def test_spread_bitwise_to_root(rates):
    assert bench._spread(rates) == root_function("_spread")(rates)


@pytest.mark.parametrize("mode,want", [
    # bench.py l.211-225 at block_len 8192, 128 lanes x 128 blocks.
    ("qpsk", dict(kb=128, kb_w=8, chunk_len=1048576, n_samples=134217728,
                  carrier_hz=399.90234375)),
    ("oqpsk", dict(kb=126, kb_w=8, chunk_len=1032192, n_samples=132120576,
                   carrier_hz=400.0)),
])
def test_turbo_geometry_written_out(mode, want):
    cfg = DemodConfig(samplerate=FS, **({} if mode == "qpsk" else dict(
        symrate=80000.0, oqpsk=True)))
    assert bench.turbo_geometry(cfg, 128, 128) == want


def test_seam_carriers_written_out():
    cfg = DemodConfig(samplerate=FS)
    fmax_hz = float(cfg.pll_fmax) * cfg.symrate / (2 * np.pi)
    span = bench.CHAIN * cfg.block_len
    # bench.py l.320-321 (a span of 128 x 16 blocks) and l.655-657 (the
    # acquisition's 16-block span at 400 Hz and +-0.85 fmax).
    assert bench._seam_carrier(400.0, 128 * 16 * 8192, FS) == \
        399.99847412109375
    assert bench._seam_carrier(400.0, span, FS) == 400.78125
    assert bench._seam_carrier(0.85 * fmax_hz, span, FS) == 2921.484375
    assert bench._seam_carrier(-0.85 * fmax_hz, span, FS) == -2921.484375


def test_diverse_groups_written_out():
    cfg = DemodConfig(samplerate=FS)
    meta, lane_map = bench.diverse_groups(cfg, bench.CHAIN * 8192, 128)
    # bench.py l.414-435: fmax 3437.75 Hz, seam-periodic over 131072 samples.
    carriers = [-2921.484375, -2533.0078125, -2142.7734375, -1752.5390625,
                -1364.0625, -973.828125, -583.59375, -195.1171875,
                195.1171875, 583.59375, 973.828125, 1364.0625, 1752.5390625,
                2142.7734375, 2533.0078125, 2921.484375]
    assert [m["carrier_hz"] for m in meta] == carriers
    assert [m["snr_db"] for m in meta] == [12.0, 15.0, 18.0, 25.0] * 4
    assert [m["seed"] for m in meta] == list(range(33, 49))
    assert lane_map[0] == 0                       # the noise lane
    assert list(lane_map[1:18]) == list(range(1, 17)) + [1]
    assert np.bincount(lane_map).tolist() == [1] + [8] * 15 + [7]


def test_ramp_groups_written_out():
    meta, lane_map = bench.ramp_groups(128)
    # bench.py l.566-590.
    assert meta == [dict(carrier_hz=80.0, seed=44), dict(carrier_hz=300.0,
                                                         seed=45),
                    dict(carrier_hz=700.0, seed=46), dict(carrier_hz=1400.0,
                                                          seed=47)]
    assert list(lane_map[:6]) == [0, 1, 2, 3, 0, 1]


@pytest.mark.parametrize("mode,seed", [("qpsk", 3), ("oqpsk", 5)])
def test_turbo_workload_is_the_roots(monkeypatch, mode, seed):
    """The root's _bench_turbo and the port's, each at 2 lanes of the full
    chunk: the same synth call (symbols, carrier, seed) and the same chunk
    (kb blocks), the port's recording that chunk tiled."""
    from meteor_demod_tpu.config import DemodConfig as JaxConfig
    kw = {} if mode == "qpsk" else dict(symrate=80000.0, oqpsk=True)
    calls, jnp = root_workload("_bench_turbo", JaxConfig(samplerate=FS, **kw),
                               chunks=2, seed=seed)
    cfg = DemodConfig(samplerate=FS, **kw)
    mine, ((_, rec), _) = port_workload(monkeypatch, "_bench_turbo",
                                        "demod_array_turbo", cfg, chunks=2,
                                        seed=seed)
    assert mine == calls and len(calls) == 1
    chunk = jnp.arrays[0]
    assert chunk.shape == (bench.turbo_geometry(cfg, 2, 128)["kb"],
                           cfg.block_len, 2)
    assert np.array_equal(rec, np.tile(chunk.reshape(-1, 2), (2, 1)))


def test_diverse_workload_is_the_roots(monkeypatch):
    """The root's _bench_acquisition_diverse and the port's at 20 lanes:
    the same 16 synth calls (carriers, SNRs, seeds) and the same blocks
    (the noise lane and the groups over the lanes), bitwise."""
    from meteor_demod_tpu.config import DemodConfig as JaxConfig
    calls, jnp = root_workload("_bench_acquisition_diverse",
                               JaxConfig(samplerate=FS), batch=20)
    mine, ((_, blocks), _) = port_workload(
        monkeypatch, "_bench_acquisition_diverse", "_acq_chained",
        DemodConfig(samplerate=FS), batch=20, maker=True)
    assert mine == calls and len(calls) == 16
    assert np.array_equal(blocks.numpy(), jnp.taken)


def test_ramp_workload_is_the_roots(monkeypatch):
    """The root's _bench_acquisition_ramp and the port's at 8 lanes: the
    same 4 synth calls (carriers, ramp, seeds) and the same blocks."""
    from meteor_demod_tpu.config import DemodConfig as JaxConfig
    calls, jnp = root_workload("_bench_acquisition_ramp",
                               JaxConfig(samplerate=FS), batch=8)
    mine, ((_, _, blocks, _, _), _) = port_workload(
        monkeypatch, "_bench_acquisition_ramp", "_replay_lock_steps",
        DemodConfig(samplerate=FS), batch=8)
    assert mine == calls and len(calls) == 4
    assert np.array_equal(blocks.numpy(), jnp.taken)


# ---- the line

def fake_results() -> dict:
    fleet = (6.1e8, [5.9e2, 6.0e2, 6.1e2])
    turbo = (5.0e7, 3, True, [45.0, 48.0, 50.0])
    acq = {"lock_signal_s_p50": 1.0}
    return {"fleet": fleet, "single": fleet, "turbo": turbo, "oqpsk": fleet,
            "hifi": fleet, "turbo_oqpsk": turbo, "turbo_mesh1": turbo,
            "span": (7.0e7, 2, True, [60.0, 65.0, 70.0], 3.2, 0.41),
            "fir": {"sharded": fleet, "plain": fleet}, "acq_diverse": acq,
            "acq_ramp": acq, "acq_edge": acq, "acq_neg_edge": acq,
            "hifi_pllbw": {"0.5": fleet, "2.0": fleet}}


def test_line_keys_are_the_root_bench_keys():
    line = bench.compose_line(fake_results(), "card", 700.0,
                              {"block_demod": 1, "block_demod_oqpsk": 1})
    top_absent = {k for k in bench.ABSENT_ON_PORT if "." not in k}
    root = root_dict_keys("main")
    assert set(line) - set(bench.PORT_ONLY) | top_absent == root
    assert not top_absent & set(line)
    assert {k.split(".")[0] for k in bench.ABSENT_ON_PORT} <= root
    assert line["device"] == "cuda"
    assert line["hifi_pllbw_fleet_msamples_per_s"] == {"0.5": 610.0,
                                                       "2.0": 610.0,
                                                       "1.0": 610.0}
    with pytest.raises(bench.GateError, match="null"):
        bench.compose_line(fake_results(), None, 700.0, {})


# ---- the sections at a tiny size

@pytest.fixture(scope="module")
def spy():
    """Each _replay_lock_steps call's blocks and lock steps, by section."""
    calls = []
    orig = bench._replay_lock_steps

    def replay(cfg, fn, blocks, batch, device):
        steps = orig(cfg, fn, blocks, batch, device)
        calls.append((cfg, [b.clone() for b in blocks], steps.copy()))
        return steps

    bench._replay_lock_steps = replay
    yield calls
    bench._replay_lock_steps = orig


@pytest.fixture(scope="module")
def diverse(spy):
    out = bench._bench_acquisition_diverse(TINY, B, 8, groups=3, frac=0.0,
                                           **SMALL)
    return out, spy[-1]


def test_fleet_section_passes_its_checks():
    sps, spread = bench._bench(TINY, B, 0.01, windows=1, carrier_hz=0.0,
                               **SMALL)
    assert sps > 0 and len(spread) == 3 and spread[0] == spread[2]


def test_fir_section_passes_its_checks():
    out = bench._bench_fir(TINY, 0.01, device="cpu", n=1 << 14, windows=1)
    assert set(out) == {"sharded", "plain"}
    assert all(r[0] > 0 for r in out.values())


def test_turbo_section_passes_its_checks():
    sps, passes, converged, spread = bench._bench_turbo(
        TINY, chunks=4, kb=2, device="cpu", windows=1, carrier_hz=0.0)
    assert converged and 2 <= passes <= 4 and sps > 0


def test_span_section_passes_its_checks():
    sps, passes, ok, spread, warm_s, first_s = bench._bench_stream_span(
        TINY_SPAN, chunks=2, kb=2, nspans=1, device="cpu", nwarm=20,
        windows=1, carrier_hz=0.0)
    assert ok and sps > 0 and passes <= 4


def test_acquisition_edge_section_passes_its_checks():
    out = bench._bench_acquisition(TINY, B, 8, 0.0, **SMALL)
    assert out["all_locked"] and out["streams_locked"] == B
    assert out["lock_signal_s_p50"] > 0
    assert set(out) | absent("fleet_acquisition_fmax_edge") == \
        root_dict_keys("_bench_acquisition")


def test_acquisition_diverse_section_passes_its_checks(diverse):
    out, _ = diverse
    assert out["all_signal_locked"] and not out["noise_lane_locked"]
    assert out["per_group_locked"] == {0: 1, 1: 1, 2: 1}
    assert out["rescue_kick"]["kicked_streams"] == 1     # the noise lane
    assert out["rescue_kick"]["never_locked_after_rescue"] == 1
    assert set(out) | absent("fleet_acquisition_diverse") == \
        root_dict_keys("_bench_acquisition_diverse")


def test_acquisition_ramp_section_passes_its_checks():
    out = bench._bench_acquisition_ramp(TINY, B, n_disp=5,
                                        carriers=(20.0, 40.0), **SMALL)
    assert out["streams_locked"] == B and out["per_group_locked"] == [2, 2]
    assert set(out) == root_dict_keys("_bench_acquisition_ramp")


def oracle_lock_step(parts: list, S: int) -> int:
    """The step at which an oracle's locked_once is first set: its block k
    and symbol j within the block as k * S + j (a block's symbols are its
    first rows), -1 if never."""
    for k, p in enumerate(parts):
        hit = np.nonzero(p["locked_once"] > 0)[0]
        if len(hit):
            return k * S + int(hit[0])
    return -1


def test_acquisition_lock_steps_are_the_oracles(diverse):
    """The diverse section's replayed lock steps (a noise lane and three
    signal groups) against both numpy oracles on the port's FIR output."""
    import torch_oracle_checks as chk
    from meteor_demod_tpu.demod import scalar as jax_scalar
    cfg, calls, steps = diverse[1]
    jcfg = chk.jax_cfg(cfg)
    assert (steps >= 0).sum() == 3 and steps[0] == -1
    for lane in range(B):
        x = np.concatenate([chk.f32_to_iq(b[:, lane].reshape(-1, 2).numpy())
                            for b in calls])
        fir = chk.port_fir(cfg, x)
        mine = chk.oracle(scalar, cfg, x, fir)
        theirs = chk.oracle(jax_scalar, jcfg, x, fir)
        assert oracle_lock_step(mine.parts, cfg.steps_per_block) == \
            steps[lane], f"lane {lane}"
        assert oracle_lock_step(theirs.parts, jcfg.steps_per_block) == \
            steps[lane], f"lane {lane}"


# ---- a set flag or a corrupted output makes a section raise

def tampered_demod(kind: str):
    """bench.make_batch_demod whose calls set a flag or drop the symbols."""
    make = bench.make_batch_demod

    def make_tampered(*a, **kw):
        demod = make(*a, **kw)

        def step(carry, x):
            carry, outs = demod(carry, x)
            if kind == "flag":
                carry.flags = carry.flags | 2
            else:
                outs.valid = torch.zeros_like(outs.valid)
                outs.locked_once = torch.zeros_like(outs.locked_once)
            return carry, outs

        return step

    return make_tampered


@pytest.mark.parametrize("kind,match", [("flag", "flags set"),
                                        ("output", "symbols where")])
def test_fleet_section_raises(monkeypatch, kind, match):
    monkeypatch.setattr(bench, "make_batch_demod", tampered_demod(kind))
    with pytest.raises(bench.GateError, match=match):
        bench._bench(TINY, B, 0.01, windows=1, carrier_hz=0.0, **SMALL)


@pytest.mark.parametrize("kind,match", [("flag", "flags set"),
                                        ("output", "no stream locked")])
def test_acquisition_sections_raise(monkeypatch, kind, match):
    monkeypatch.setattr(bench, "make_batch_demod", tampered_demod(kind))
    with pytest.raises(bench.GateError, match=match):
        bench._bench_acquisition(TINY, B, 1, 0.0, **SMALL)
    with pytest.raises(bench.GateError, match=match):
        bench._bench_acquisition_ramp(TINY, B, n_disp=1, carriers=(20.0,),
                                      **SMALL)


@pytest.mark.parametrize("result,match", [
    (dict(fell_back=True, converged=False), "flagged chunk"),
    (dict(converged=False), "did not converge"),
    (dict(n=100), "symbols where"),
])
def test_turbo_section_raises(monkeypatch, result, match):
    def fake(cfg, x, chunks, max_passes, device=None, mesh=None):
        n = result.get("n", int(len(x) * cfg.symrate / cfg.samplerate))
        return TurboResult(symbols=np.zeros(n), passes=2,
                           converged=result.get("converged", True),
                           max_residual=0.0,
                           fell_back=result.get("fell_back", False))

    monkeypatch.setattr(bench, "demod_array_turbo", fake)
    with pytest.raises(bench.GateError, match=match):
        bench._bench_turbo(TINY, chunks=4, kb=2, device="cpu", windows=1)


@pytest.mark.parametrize("nwarm,P,match", [(2, 2, "not locked"),
                                           (20, 1, "verified 1 of 2")])
def test_span_section_raises(monkeypatch, nwarm, P, match):
    def fake_submit(cfg, carry0, xf, chunks, device):
        return SpanPending(None, {}, np.zeros(chunks), 2, False, P,
                           len(xf) // chunks * P, carry0)

    monkeypatch.setattr(bench, "span_submit", fake_submit)
    monkeypatch.setattr(bench, "span_finish",
                        lambda cfg, p: pytest.fail("finished a bad span"))
    if P < 2:          # a locked stream, without demodulating it here
        monkeypatch.setattr(bench, "_chained_fn", lambda cfg, b, d: (
            lambda c, x: (dataclasses.replace(
                c, locked=torch.ones_like(c.locked)), None)))
    with pytest.raises(bench.GateError, match=match):
        bench._bench_stream_span(TINY_SPAN, chunks=2, kb=2, nspans=1,
                                 device="cpu", nwarm=nwarm, windows=1,
                                 carrier_hz=0.0)


def test_fir_section_raises(monkeypatch):
    make = bench.make_sharded_fir

    def off_by_one_ulp(cfg, mesh):
        fir = make(cfg, mesh)
        return lambda x: [torch.nextafter(f, f + 1) for f in fir(x)]

    monkeypatch.setattr(bench, "make_sharded_fir", off_by_one_ulp)
    with pytest.raises(bench.GateError, match="differs from the plain"):
        bench._bench_fir(TINY, 0.01, device="cpu", n=1 << 14, windows=1)
    monkeypatch.undo()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(bench.GateError, match="TF32"):
        bench._bench_fir(TINY, 0.01, device="cpu", n=1 << 14, windows=1)


# ---- main

def test_main_without_a_card_prints_no_line():
    env = {k: v for k, v in os.environ.items()
           if k != "METEOR_DEMOD_PLATFORM"}
    env["CUDA_VISIBLE_DEVICES"] = ""          # no card, also where one is
    p = subprocess.run([sys.executable, "-m", "meteor_demod_tpu_torch.bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA is not available" in p.stderr


def test_main_refuses_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="CUDA card only"):
        bench.main([])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("failing", [None, "_bench", "_bench_fir",
                                     "_bench_acquisition"])
def test_main_prints_one_line_or_none(monkeypatch, capsys, failing):
    """main() on faked sections: every section passing prints one compact
    JSON line with no null; one that fails (the headline, or a later one)
    propagates and nothing is printed on stdout."""
    fake = fake_results()
    monkeypatch.setattr(bench, "card_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(bench, "power_limit",
                        lambda: ("NVIDIA H100 80GB HBM3, 700.00 W", 700.0))
    monkeypatch.setattr(bench.torch.cuda, "get_device_name", lambda d: "card")
    sections = {"_bench": fake["fleet"], "_bench_turbo": fake["turbo"],
                "_bench_stream_span": fake["span"], "_bench_fir": fake["fir"],
                "_bench_acquisition_diverse": fake["acq_diverse"],
                "_bench_acquisition_ramp": fake["acq_ramp"],
                "_bench_acquisition": fake["acq_edge"]}
    for name, value in sections.items():
        def section(*a, _name=name, _value=value, **kw):
            if _name == failing:
                raise bench.GateError(f"{_name} failed")
            return _value
        monkeypatch.setattr(bench, name, section)
    if failing:
        with pytest.raises(bench.GateError, match=failing):
            bench.main([])
        assert capsys.readouterr().out == ""
        return
    assert bench.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and ": " not in out[0]
    line = json.loads(out[0])
    assert line["card"] == "card" and line["power_limit_w"] == 700.0
    assert line["kernel_launches"] == {
        name: {"block_demod": 0, "block_demod_oqpsk": 0}
        for name in ("fleet",) + bench.SECTIONS}


@pytest.mark.gpu
def test_headline_on_the_card():
    """The headline alone on the card, through run_sections and
    compose_line as main() calls them: both gates held (flags 0, every
    stream locked), the QPSK kernel launched and the OQPSK one not, a line
    with the card's name and no null."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    device = bench.card_device()
    res, launches = bench.run_sections((), device)
    assert set(res) == set(launches) == {"fleet"}
    assert launches["fleet"]["block_demod"] > 0
    assert launches["fleet"]["block_demod_oqpsk"] == 0
    _, watts = bench.power_limit()
    line = bench.compose_line(res, torch.cuda.get_device_name(0), watts,
                              launches)
    assert line["device"] == "cuda" and line["value"] > 0 and watts > 0
    assert json.loads(json.dumps(line)) == line
