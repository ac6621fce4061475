"""CUDA streams and the port: shards that share a card, each on a CUDA stream
of its own, against one device; and every entry point run under a caller's
stream against the same call on the default stream.

Tests marked `gpu` need a CUDA card and nvcc, and skip without them. This
file imports neither jax nor meteor_demod_tpu, so it runs on the card's
machine (where tests/conftest.py, which imports jax, cannot load):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streams.py

Every comparison is bitwise: the work of a shard or of a call does not
depend on the stream it is queued on, so neither may its result.
"""

import dataclasses

import numpy as np
import pytest
import torch

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   quantize_symbols)
from meteor_demod_tpu_torch.demod.state import (CARRY_FIELDS, batch_carry,
                                                batch_carry_np, carry_to_numpy)
from meteor_demod_tpu_torch.dsp.fir import iq_to_f32
from meteor_demod_tpu_torch.parallel.mesh import (FleetDemodulator, Shards,
                                                  make_fleet_demod)
from meteor_demod_tpu_torch.sim import synth_psk

FS = 230400
CARD0 = torch.device("cuda", 0)
CARD1 = torch.device("cuda", 1)
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The CUDA card; decided here, when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda", torch.cuda.current_device())


def _cfg(mode: str, block_len: int) -> DemodConfig:
    if mode == "oqpsk":
        return DemodConfig(samplerate=FS, symrate=80000.0, oqpsk=True,
                           block_len=block_len)
    return DemodConfig(samplerate=FS, block_len=block_len)


# ------------------------------------------------- which shards get a stream

@pytest.mark.parametrize("devices, own", [
    ([CPU], [False]),
    ([CPU] * 4, [False] * 4),
    ([CARD0], [False]),
    ([CARD0, CARD1], [False, False]),
    ([CARD0] * 2, [True, True]),
    ([CARD0, CARD0, CARD1], [True, True, False]),
    ([CARD0, CARD1, CARD0, CARD1], [True] * 4),
], ids=["cpu", "cpu-x4", "one-card", "two-cards", "one-card-x2",
        "shared-and-alone", "two-cards-x2"])
def test_shards_sharing_a_card_get_a_stream_each(devices, own):
    """A shard gets a CUDA stream of its own exactly when another shard
    shares its card; a CPU shard, and a card's only shard, take none.
    Deciding needs no card (streams are made at the first launch)."""
    sh = Shards(devices, 4 * len(devices))
    assert sh.own_stream == own
    assert sh.rows == [slice(4 * i, 4 * (i + 1)) for i in range(len(devices))]


def test_cpu_shards_take_no_stream():
    """On the CPU a shard's work runs where it is called: `on` makes no
    stream and changes nothing, and the fleet over CPU shards is bitwise
    the one-device fleet."""
    cfg = _cfg("qpsk", 1024)
    sh = Shards([CPU] * 2, 4)
    with sh.on(0, [torch.zeros(2)]):
        t = torch.arange(3)
    assert t.device.type == "cpu" and sh._streams == {}
    x = np.stack([synth_psk(700, FS, carrier_hz=100.0 + 50 * i,
                            amplitude=6000.0, snr_db=20.0, seed=i)[0][:2048]
                  for i in range(4)])
    one = FleetDemodulator(cfg, 4, "cpu", chain_blocks=2)
    two = FleetDemodulator(cfg, 4, mesh=["cpu"] * 2, chain_blocks=2)
    a, b = one.process_blocks(x), two.process_blocks(x)
    for k in ("sym_re", "sym_im", "valid", "locked_once"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def test_to_host_async_of_cpu_tensors_waits_for_nothing():
    """CPU tensors come back as their numpy views, with no card touched."""
    from meteor_demod_tpu_torch.utils import to_host_async
    t = [torch.arange(4, dtype=torch.int32), torch.ones((2, 3))]
    got = to_host_async(t)()
    assert [g.dtype for g in got] == [np.int32, np.float32]
    np.testing.assert_array_equal(got[0], [0, 1, 2, 3])
    assert np.shares_memory(got[1], t[1].numpy())


# ------------------------------------------------------------ on the card

# Cycles of torch.cuda._sleep, a spin kernel: ~50 ms at an H100's clock, far
# longer than any host step between two queued pieces of work here.
SPIN = 100_000_000


def _iq(cfg: DemodConfig, n_streams: int, n: int) -> np.ndarray:
    """(n_streams, n) complex64 (O)QPSK at cfg's rates: carriers 60 Hz and
    up, SNR 15-24 dB, a DC offset; the last stream is noise only."""
    xs = [synth_psk(int(n * cfg.symrate / FS) + 64, FS, symrate=cfg.symrate,
                    oqpsk=cfg.oqpsk, carrier_hz=60.0 + 37 * b,
                    amplitude=6000.0, snr_db=15.0 + b % 10, seed=b,
                    dc_offset=20 - 5j)[0][:n] for b in range(n_streams)]
    rng = np.random.default_rng(n_streams)
    xs[-1] = (1500 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return np.stack(xs).astype(np.complex64)


def _raw(x: np.ndarray) -> np.ndarray:
    """complex64 -> int16 sample pairs (the fleets' "i16" ingest)."""
    return np.round(iq_to_f32(x)).clip(-32768, 32767).astype(np.int16)


def _leaves(prefix: str, obj) -> dict:
    """A dataclass of tensors or arrays -> {prefix + field: numpy}."""
    return {prefix + f.name: np.asarray(torch.as_tensor(
        getattr(obj, f.name)).cpu()) for f in dataclasses.fields(obj)}


def _stream_contract(dev, build, drive) -> None:
    """drive(build()) on the default stream, then (a) built and driven under
    a caller's side stream while the default stream spins, and (b) built on
    the default stream behind a spin and driven under the side stream while
    the default stream spins again: every array of (a) and (b) bitwise the
    first run's."""
    want = drive(build())
    side = torch.cuda.Stream(dev)
    torch.cuda._sleep(SPIN)
    with torch.cuda.stream(side):
        got_a = drive(build())
    torch.cuda._sleep(SPIN)
    obj = build()
    torch.cuda._sleep(SPIN)
    with torch.cuda.stream(side):
        got_b = drive(obj)
    torch.cuda.synchronize(dev)
    for name, got in (("side", got_a), ("built on default", got_b)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name}: {k}")


L = 2048
B = 8
FLAGGED = 5


def _fleet_drive(raw, chain, n_chains=3):
    """Drive a FleetDemodulator over n_chains chains; before chain 1 the
    caller's stream spins and then sets a flag in one stream's carry in
    place, which the fleet must see (it recovers that stream on the host)."""
    def drive(fleet):
        out = {}
        span = chain * L
        for c in range(n_chains):
            if c == 1:
                torch.cuda._sleep(SPIN)
                per = fleet._shards.per
                fleet._carries[FLAGGED // per].flags[FLAGGED % per] |= 2
            got = fleet.process_blocks(raw[:, c * span:(c + 1) * span])
            out.update(_leaves(f"{c}.", got))
            out.update({f"{c}.tel.{k}": np.asarray(v)
                        for k, v in fleet.telemetry.items()})
        out.update(_leaves("carry.", fleet.carry))
        out["recovered"] = np.asarray(fleet.recovered_streams)
        assert fleet.recovered_streams == 1
        return out
    return drive


ENTRIES = ["make_batch_demod", "make_fleet_demod", "fleet", "fleet_2_shards",
           "stream_blocks", "stream_chained", "stream_span", "turbo",
           "turbo_2_shards", "serving"]


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("mode", ["qpsk", "oqpsk"])
def test_entry_point_bitwise_under_a_callers_stream(cuda_device, mode, entry):
    """Each entry point queued under a caller's `torch.cuda.stream(side)`,
    and each object built on the default stream and driven under `side`,
    give bitwise the outputs, carries and .s bytes of the same calls on the
    default stream (_stream_contract)."""
    from meteor_demod_tpu_torch.demod.turbo import demod_array_turbo
    from meteor_demod_tpu_torch.parallel.serving import ServingFleet
    from meteor_demod_tpu_torch.utils import to_device, to_host
    cfg = _cfg(mode, L)
    dev = cuda_device
    if entry == "make_batch_demod":
        x = iq_to_f32(_iq(cfg, B, 3 * L))

        def build():
            return make_batch_demod(cfg, B, dev), batch_carry(cfg, B, dev)

        def drive(built):
            fn, carry = built
            xt = torch.as_tensor(x, device=dev)
            out = {}
            for i in range(3):
                carry, o = fn(carry, xt[:, i * L:(i + 1) * L])
                out.update(_leaves(f"{i}.", o))
            out.update(_leaves("carry.", carry))
            return out
    elif entry == "make_fleet_demod":
        raw = _raw(_iq(cfg, B, 4 * L))

        def build():
            return (make_fleet_demod(cfg, B, dev, chain=2, ingest="i16",
                                     packed=True), batch_carry(cfg, B, dev))

        def drive(built):
            step, carry = built
            out = {}
            for c in range(2):
                carry, o, tel = step(carry, to_device(
                    np.ascontiguousarray(raw[:, c * 2 * L:(c + 1) * 2 * L]),
                    dev))
                out.update(_leaves(f"{c}.", o))
                out.update(zip((f"{c}.tel.{k}" for k in tel),
                               to_host(list(tel.values()))))
            out.update(_leaves("carry.", carry))
            return out
    elif entry in ("fleet", "fleet_2_shards"):
        raw = _raw(_iq(cfg, B, 3 * 2 * L))
        kw = dict(chain_blocks=2, ingest="i16", packed_output=True)
        if entry == "fleet":
            build = lambda: FleetDemodulator(cfg, B, dev, **kw)  # noqa: E731
        else:
            build = lambda: FleetDemodulator(  # noqa: E731
                cfg, B, mesh=[dev] * 2, **kw)
        drive = _fleet_drive(raw, 2)
    elif entry.startswith("stream"):
        span_n = 4 * 16 * L
        x = _iq(cfg, 1, 2 * span_n + 3000)[0] if entry == "stream_span" \
            else _iq(cfg, 1, 24 * L + 3000)[0]
        piece = {"stream_blocks": L, "stream_chained": 8 * L,
                 "stream_span": 8192}[entry]

        def build():
            if entry == "stream_span":
                return StreamDemodulator(cfg, dev, span_turbo=True,
                                         span_chunks=4)
            return StreamDemodulator(cfg, dev)

        def drive(d):
            parts = [d.process(x[at:at + piece])
                     for at in range(0, len(x), piece)]
            parts.append(d.finish())
            sym = np.concatenate(parts)
            if entry == "stream_span":
                assert d.spans_run >= 2
            return {"s": quantize_symbols(sym), "re": sym["re"],
                    "im": sym["im"], "locked_once": sym["locked_once"],
                    **_leaves("carry.", d._carry)}
    elif entry.startswith("turbo"):
        lanes, kb = 4, 24
        x = _iq(cfg, 1, lanes * kb * L + 3000)[0]
        mesh = [dev] * 2 if entry == "turbo_2_shards" else None
        build = lambda: None  # noqa: E731

        def drive(_):
            kw = dict(mesh=mesh) if mesh else dict(device=dev)
            res = demod_array_turbo(cfg, x, chunks=lanes, strict=True, **kw)
            return {"re": res.symbols["re"], "im": res.symbols["im"],
                    "locked_once": res.symbols["locked_once"],
                    "gauges": np.asarray(res.gauges),
                    "passes": np.asarray(res.passes)}
    else:
        raw = _raw(_iq(cfg, B, 3 * 2 * L))
        build = lambda: ServingFleet(  # noqa: E731
            cfg, B, group_size=4, device=dev, chain_blocks=2, ingest="i16",
            packed_output=True)

        def drive(host):
            out = {}
            for c in range(3):
                got = host.process_blocks(raw[:, c * 2 * L:(c + 1) * 2 * L])
                out.update(_leaves(f"{c}.", got))
            for g, f in enumerate(host.groups):
                out.update(_leaves(f"carry{g}.", f.carry))
            return out
    _stream_contract(dev, build, drive)


@pytest.mark.gpu
def test_initial_carry_is_ready_on_any_stream(cuda_device):
    """batch_carry's leaves are written when it returns: made on the default
    stream behind a spin, over memory that held other values, and copied at
    once on a side stream (device-to-device, which waits for no other
    stream), they are the initial values. Everything runs once first, so
    that no lazy load of a kernel's module synchronizes the card on the
    way."""
    cfg = _cfg("qpsk", L)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        warm = batch_carry(cfg, B, cuda_device)
        [getattr(warm, k).clone() for k in CARRY_FIELDS]
    torch.cuda.synchronize(cuda_device)
    del warm
    junk = [torch.full((B,) + s, 7.0, device=cuda_device)
            for s in [()] * 64 + [(cfg.taps - 1, 2)] * 4]
    del junk
    torch.cuda._sleep(SPIN)
    carry = batch_carry(cfg, B, cuda_device)
    with torch.cuda.stream(side):
        snap = {k: getattr(carry, k).clone() for k in CARRY_FIELDS}
    torch.cuda.synchronize(cuda_device)
    got = {k: v.cpu().numpy() for k, v in snap.items()}
    want = batch_carry_np(cfg, B)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _fleet_raw(n_streams: int, n_samples: int, seed: int,
               dev) -> np.ndarray:
    """(n_streams, n_samples, 2) int16 QPSK at 72 ksym/s: 4 symbol
    sequences given per-stream carriers +50..+600 Hz, noise and a DC
    offset on the card; the last stream is noise only."""
    bases = [synth_psk(int(n_samples * 72000 / FS) + 64, FS, carrier_hz=0.0,
                       amplitude=1.0, snr_db=300.0, seed=seed + k)[0][
                           :n_samples] for k in range(4)]
    base = torch.tensor(np.stack(bases), device=dev)
    n = torch.arange(n_samples, device=dev, dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    carrier = np.linspace(50.0, 600.0, n_streams)
    out = torch.empty((n_streams, n_samples, 2), dtype=torch.int16,
                      device=dev)
    for b in range(n_streams):
        rot = torch.exp(2j * np.pi * carrier[b] / FS * n).to(torch.complex64)
        amp = 0.0 if b == n_streams - 1 else 6000.0
        z = torch.view_as_real(base[b % 4] * rot * amp + (20 - 5j))
        noise = torch.randn((n_samples, 2), generator=gen, device=dev) * 900
        out[b] = (z + noise).round().clamp(-32768, 32767).to(torch.int16)
    return out.cpu().numpy()


def _run_fleet(fleet, raw, span, n_chains):
    """Each chain's outputs, and the carry and telemetry after each, as
    host values."""
    outs, carries, tels = [], [], []
    for c in range(n_chains):
        got = fleet.process_blocks(raw[:, c * span:(c + 1) * span])
        outs.append(_leaves("", got))
        carries.append(carry_to_numpy(fleet.carry))
        tels.append(dict(fleet.telemetry))
    return outs, carries, tels


@pytest.mark.gpu
def test_stream_per_shard_equals_one_device_with_warm_pools(cuda_device):
    """chip_smoke.py (j)'s shape: FleetDemodulator(cfg, 128, mesh=[card] * 2,
    chain_blocks=16, ingest="i16", packed_output=True) over 3 chains against
    the fleet on the card alone, after the one-device fleet has run and
    been freed in this process, twice (so torch's caching allocator holds
    its blocks, as the smoke's does by then): every chain's outputs, and
    the carry and the integer telemetry after each chain, bitwise; the
    shards ran on two streams of their own, neither the caller's."""
    cfg = _cfg("qpsk", 8192)
    n, chain, n_chains = 128, 16, 3
    span = chain * cfg.block_len
    raw = _fleet_raw(n, n_chains * span, 2024, cuda_device)
    kw = dict(chain_blocks=chain, ingest="i16", packed_output=True)
    want = _run_fleet(FleetDemodulator(cfg, n, cuda_device, **kw), raw, span,
                      n_chains)
    _run_fleet(FleetDemodulator(cfg, n, cuda_device, **kw), raw, span, 1)
    assert (torch.cuda.memory_reserved(cuda_device)
            > torch.cuda.memory_allocated(cuda_device))

    fleet = FleetDemodulator(cfg, n, mesh=[cuda_device] * 2, **kw)
    got = _run_fleet(fleet, raw, span, n_chains)
    streams = fleet._shards._streams
    caller = torch.cuda.current_stream(cuda_device)
    assert fleet._shards.own_stream == [True, True]
    assert len({s.cuda_stream for s in streams.values()}) == 2
    assert caller.cuda_stream not in {s.cuda_stream for s in streams.values()}
    for c in range(n_chains):
        for k in want[0][c]:
            np.testing.assert_array_equal(got[0][c][k], want[0][c][k],
                                          err_msg=f"chain {c} {k}")
        for k in want[1][c]:
            np.testing.assert_array_equal(got[1][c][k], want[1][c][k],
                                          err_msg=f"chain {c} carry {k}")
        for k, v in want[2][c].items():
            if k != "mean_agc_gain":
                assert got[2][c][k] == v, (c, k)
    assert fleet.recovered_streams == 0
