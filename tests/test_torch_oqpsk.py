"""The port's OQPSK path (meteor_demod_tpu_torch) held against the JAX
package on identical inputs, on the CPU.

Fixture: 4 streams at 230.4 ksps, 80 ksym/s OQPSK (three signals with
different carriers and DC offsets, one noise-only so the unlocked sweep
runs), block_len 1024, 2 chained blocks after WARM blocks of JAX-scan
warm-up, so that the carrier locks inside the blocks under test and both
block-boundary parities occur (a symbol split across the boundary, carry
slot == 2, runs the block-entry pre-fire). Each block's FIR output comes
from the JAX package's tick-major FIR and each block starts from the JAX
carry converted through carry_from_numpy.

Contracts (tests/test_pallas_kernel.py, tests/test_scan_vs_oracle.py):
- vs the JAX scan and the interpret-mode Pallas kernel: decisions (valid,
  locked_once, integer carry leaves) bitwise; symbols within rtol=5e-4,
  atol=0.05 and float carry within rtol=5e-4, atol=1e-3, because XLA may
  contract a multiply and an add into an FMA where the port rounds twice.
  Values are compared on valid rows only: the JAX scan leaves the pre-fire
  row's values unmasked where no symbol was split, the Pallas kernel and the
  port write zeros there;
- vs the numpy oracle fed the same F: bitwise, values included.
"""

import io
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import scalar as jax_scalar
from meteor_demod_tpu.demod.pipeline import StreamDemodulator as JaxDemod
from meteor_demod_tpu.demod.scan import make_block_demod
from meteor_demod_tpu.demod.state import batch_carry as jax_batch_carry
from meteor_demod_tpu.demod.state import carry_to_numpy as jax_carry_to_numpy
from meteor_demod_tpu.dsp.fir import (make_fir_banks as jax_banks,
                                      polyphase_fir_block_tmajor)
from meteor_demod_tpu.kernels.block_demod import make_pallas_batch_demod
from meteor_demod_tpu.sim import synth_psk, write_wav

from meteor_demod_tpu_torch import cli
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import scalar as port_scalar
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   numpy_carry_to_scalar_state,
                                                   quantize_symbols)
from meteor_demod_tpu_torch.demod.state import (CARRY_FIELDS,
                                                FLAG_WINDOW_MISS,
                                                carry_from_numpy,
                                                carry_to_numpy)
from meteor_demod_tpu_torch.dsp.fir import (f32_to_iq, iq_to_f32,
                                            make_fir_banks,
                                            polyphase_fir_block)
from meteor_demod_tpu_torch.io.wav import read_sample_blocks, wav_parse
from meteor_demod_tpu_torch.io.writer import SymbolWriter
from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                        block_demod_oqpsk,
                                                        block_demod_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 230400
SYMRATE = 80000.0
B = 4
N_BLOCKS = 2
WARM = 8          # the lock EMA settles inside blocks 8-9
L = 1024
OQ = dict(samplerate=FS, symrate=SYMRATE, oqpsk=True)
_OUT = ("sym_re", "sym_im", "valid", "locked_once")
_DERIVED = ("pll_bw_eff", "pll_gains", "pll_fmax", "fire_spacing",
            "fires_per_step", "gate_candidates", "steps_per_block",
            "timing_freq", "timing_gains", "timing_dev_max", "block_ticks",
            "max_ticks_per_step", "ticks_per_step")


def _oqpsk(n, carrier_hz, seed, snr_db=22.0, dc_offset=25 - 10j):
    nsym = int(n * SYMRATE / FS) + 64
    return synth_psk(nsym, FS, symrate=SYMRATE, oqpsk=True,
                     carrier_hz=carrier_hz, amplitude=6000.0, snr_db=snr_db,
                     seed=seed, dc_offset=dc_offset)[0][:n]


def _streams(n: int) -> np.ndarray:
    xs = [_oqpsk(n, 60.0 + 20 * b, seed=b) for b in range(B - 1)]
    rng = np.random.default_rng(7)
    xs.append((1500 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
               ).astype(np.complex64))
    return np.stack(xs)


@pytest.mark.parametrize("block_len", [8192, 4096])
def test_oqpsk_derived_config_fields_bitwise(block_len):
    """The repo's OQPSK configuration (block_len 8192) and the JAX tests'
    oqpsk_cfg (block_len 4096)."""
    jc = JaxConfig(block_len=block_len, **OQ)
    pc = DemodConfig(block_len=block_len, **OQ)
    for field in _DERIVED:
        a, b = np.asarray(getattr(pc, field)), np.asarray(getattr(jc, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert pc.fires_per_step == 2 and pc.fire_spacing == np.pi


def test_port_oracle_matches_jax_oracle_bitwise():
    """The port's numpy oracle on OQPSK: every symbol and every state leaf
    of the JAX package's demod_stream_np, over 4 chained calls."""
    kw = dict(block_len=L, **OQ)
    x = _oqpsk(4 * L, 90.0, seed=5)
    sj = sp = None
    for i in range(4):
        a, sj = jax_scalar.demod_stream_np(JaxConfig(**kw), x[i * L:(i + 1) * L],
                                           sj)
        b, sp = port_scalar.demod_stream_np(DemodConfig(**kw),
                                            x[i * L:(i + 1) * L], sp)
        assert len(a) > 300 and np.array_equal(a, b)
        for k in sj:
            np.testing.assert_array_equal(np.asarray(sp[k]), np.asarray(sj[k]),
                                          err_msg=k)
    assert {int(sj["slot"])} <= {1, 2}


@pytest.fixture(scope="module")
def fx():
    jcfg = JaxConfig(block_len=L, **OQ)
    cfg = DemodConfig(block_len=L, **OQ)
    xf = iq_to_f32(_streams((WARM + N_BLOCKS) * L))      # (B, samples, 2)
    scan_fn = jax.jit(jax.vmap(make_block_demod(jcfg)))
    pal_fn = make_pallas_batch_demod(jcfg, B, interpret=True, group=4)
    banks = jax_banks(jcfg)
    blocks = []
    carry = jax_batch_carry(jcfg, B)
    for i in range(WARM):
        carry, _ = scan_fn(carry, jnp.asarray(xf[:, i * L:(i + 1) * L]))
    xf = xf[:, WARM * L:]
    for i in range(N_BLOCKS):
        xb = xf[:, i * L:(i + 1) * L]
        Ft, _ = polyphase_fir_block_tmajor(
            jnp.asarray(xb.transpose(1, 0, 2)),
            carry.fir_tail.transpose(1, 0, 2), banks)
        sc, so = scan_fn(carry, jnp.asarray(xb))
        pc, po = pal_fn(carry, jnp.asarray(xb))
        blocks.append(dict(
            x=xb, Ft=np.asarray(Ft), entry=jax_carry_to_numpy(carry),
            scan=(jax_carry_to_numpy(sc), {k: np.asarray(getattr(so, k))
                                           for k in _OUT}),
            pallas=(jax_carry_to_numpy(pc), {k: np.asarray(getattr(po, k))
                                             for k in _OUT})))
        carry = sc
    port = []
    for blk in blocks:
        c, o = block_demod_torch(cfg, carry_from_numpy(blk["entry"], "cpu"),
                                 torch.tensor(blk["Ft"]))
        port.append((carry_to_numpy(c),
                     {k: getattr(o, k).numpy() for k in _OUT}))
    return dict(cfg=cfg, jcfg=jcfg, blocks=blocks, port=port)


def _assert_decisions_and_values(got, ref, what):
    (gc, go), (rc, ro) = got, ref
    assert go["valid"].shape == (B, DemodConfig(block_len=L, **OQ)
                                 .steps_per_block + 1)
    np.testing.assert_array_equal(go["valid"], ro["valid"], err_msg=what)
    np.testing.assert_array_equal(go["locked_once"], ro["locked_once"],
                                  err_msg=what)
    m = ro["valid"].astype(bool)
    assert m.sum() > 4 * 300
    for k in ("sym_re", "sym_im"):
        np.testing.assert_allclose(go[k][m], ro[k][m], rtol=5e-4, atol=0.05,
                                   err_msg=f"{what} {k}")
    for k in CARRY_FIELDS:
        if k == "fir_tail":          # the FIR owns it, not the recurrence
            continue
        if rc[k].dtype.kind == "i":
            np.testing.assert_array_equal(gc[k], rc[k], err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(gc[k], rc[k], rtol=5e-4, atol=1e-3,
                                       err_msg=f"{what} {k}")


@pytest.mark.parametrize("ref", ["scan", "pallas"])
@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_plain_matches_jax(fx, ref, block):
    _assert_decisions_and_values(fx["port"][block], fx["blocks"][block][ref],
                                 f"{ref} block {block}")


def test_fixture_exercises_prefire_lock_and_sweep(fx):
    """Both boundary parities occur; where a symbol was split the pre-fire
    ran and produced row 0, elsewhere row 0 is zeros and invalid."""
    split = [blk["entry"]["slot"] == 2 for blk in fx["blocks"]]
    assert all(s.any() and not s.all() for s in split)
    for s, (_, o) in zip(split, fx["port"]):
        np.testing.assert_array_equal(o["valid"][:, 0], s.astype(np.int32))
        assert not o["sym_re"][~s, 0].any() and not o["sym_im"][~s, 0].any()
    entry = fx["blocks"][0]["entry"]
    c, _ = fx["port"][-1]
    assert not entry["locked_once"].any()      # unlocked on entry ...
    assert c["locked_once"][:B - 1].all()      # ... the three signals lock
    assert not c["locked_once"][B - 1]         # noise never locks
    assert (c["flags"] == 0).all()


def test_plain_chained_matches_jax(fx):
    """The port carries its own carry (inphase and slot included) across
    the blocks."""
    cfg = fx["cfg"]
    carry = carry_from_numpy(fx["blocks"][0]["entry"], "cpu")
    for blk in fx["blocks"]:
        carry, out = block_demod_torch(cfg, carry, torch.tensor(blk["Ft"]))
        got = (carry_to_numpy(carry), {k: getattr(out, k).numpy()
                                       for k in _OUT})
        _assert_decisions_and_values(got, blk["scan"], "chained")


@pytest.mark.parametrize("oracle", [jax_scalar, port_scalar],
                         ids=["jax_oracle", "port_oracle"])
@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_plain_matches_oracle_bitwise(fx, oracle, block):
    """Fed the identical F from the same entry state, the plain recurrence
    IS the numpy oracle: every symbol (the pre-fire's included) and every
    state leaf bitwise."""
    cfg, blk = fx["cfg"], fx["blocks"][block]
    pc, po = fx["port"][block]
    for b in range(B):
        st = numpy_carry_to_scalar_state(
            cfg, {k: v[b] for k, v in blk["entry"].items()})
        F = f32_to_iq(np.ascontiguousarray(blk["Ft"][:, :, b])).reshape(
            L, cfg.interp)
        syms, st = oracle.demod_stream_np(fx["jcfg"], f32_to_iq(blk["x"][b]),
                                          st, F=F)
        m = po["valid"][b].astype(bool)
        assert len(syms) == m.sum()
        np.testing.assert_array_equal(po["sym_re"][b][m], syms["re"])
        np.testing.assert_array_equal(po["sym_im"][b][m], syms["im"])
        np.testing.assert_array_equal(po["locked_once"][b][m],
                                      syms["locked_once"])
        for k in ("t_phase", "t_freq", "t_prev", "p_phase", "p_freq",
                  "p_err", "updown", "agc_gain", "inphase"):
            assert np.float32(st[k]) == pc[k][b], (b, k)
        assert np.complex64(st["agc_bias"]) == np.complex64(
            complex(pc["agc_bias_re"][b], pc["agc_bias_im"][b]))
        for k in ("locked", "locked_once", "slot"):
            assert int(st[k]) == int(pc[k][b]), (b, k)


def test_wrapper_on_cpu_runs_plain(fx):
    """Both kernel wrappers take the plain path for a CPU tensor, and count
    no launch."""
    cfg, blk = fx["cfg"], fx["blocks"][0]
    before = (block_demod.launches, block_demod_oqpsk.launches)
    pc, po = fx["port"][0]
    for fn in (block_demod, block_demod_oqpsk):
        c, o = fn(cfg, carry_from_numpy(blk["entry"], "cpu"),
                  torch.tensor(blk["Ft"]))
        for k in _OUT:
            np.testing.assert_array_equal(getattr(o, k).numpy(), po[k])
        for k, v in carry_to_numpy(c).items():
            if k != "fir_tail":
                np.testing.assert_array_equal(v, pc[k], err_msg=k)
    assert (block_demod.launches, block_demod_oqpsk.launches) == before
    with pytest.raises(ValueError, match="OQPSK config"):
        block_demod_oqpsk(DemodConfig(samplerate=FS, block_len=L),
                          carry_from_numpy(blk["entry"], "cpu"),
                          torch.tensor(blk["Ft"]))


def test_backend_matches_jax_scan(fx):
    """make_batch_demod (the port's own FIR, then the recurrence) chained
    over both blocks against the JAX scan: decisions bitwise, values within
    the contract plus the FIR's float32 rounding (~1e-5 relative)."""
    fn = make_batch_demod(fx["cfg"], B, "cpu")
    carry = carry_from_numpy(fx["blocks"][0]["entry"], "cpu")
    for i, blk in enumerate(fx["blocks"]):
        carry, out = fn(carry, torch.tensor(blk["x"]))
        got = (carry_to_numpy(carry), {k: getattr(out, k).numpy()
                                       for k in _OUT})
        _assert_decisions_and_values(got, blk["scan"], f"backend block {i}")
        np.testing.assert_allclose(got[0]["fir_tail"],
                                   blk["scan"][0]["fir_tail"], rtol=0, atol=0)


def test_deferred_prefire_flags_like_scan(fx):
    """A split symbol whose completion cannot fire within K ticks (a timing
    phase far behind the threshold) defers: the block is flagged
    FLAG_WINDOW_MISS for the oracle's replay, exactly where the JAX scan
    flags it, with the same rows after it."""
    blk = fx["blocks"][1]
    entry = {k: v.copy() for k, v in blk["entry"].items()}
    entry["slot"][:2] = 2
    entry["t_phase"][:2] = [-8.0, 3.0]
    scan_fn = jax.jit(jax.vmap(make_block_demod(fx["jcfg"])))
    jc = jax_batch_carry(fx["jcfg"], B)._replace(
        **{k: jnp.asarray(v) for k, v in entry.items()})
    sc, so = scan_fn(jc, jnp.asarray(blk["x"]))
    c, o = block_demod_torch(fx["cfg"], carry_from_numpy(entry, "cpu"),
                             torch.tensor(blk["Ft"]))
    got = carry_to_numpy(c)
    np.testing.assert_array_equal(got["flags"] & FLAG_WINDOW_MISS,
                                  [1, 0, 0, 0])
    np.testing.assert_array_equal(got["flags"], np.asarray(sc.flags))
    np.testing.assert_array_equal(o.valid[:, 0].numpy(),
                                  [0, 1, *(entry["slot"][2:] == 2)])
    for k in ("valid", "locked_once"):
        np.testing.assert_array_equal(getattr(o, k).numpy(),
                                      np.asarray(getattr(so, k)), err_msg=k)
    for k in ("slot", "locked", "locked_once", "tick"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(sc, k)),
                                      err_msg=k)


def _run(demod, x):
    return np.concatenate([demod.process(x), demod.finish()])


def test_stream_demodulator_matches_jax():
    """12 blocks: a chained span of 8, then singles, then a 777-sample tail
    through the oracle. Counts and lock history bitwise, values within the
    contract, telemetry within it."""
    x = _oqpsk(12 * L + 777, 80.0, seed=3, snr_db=25.0, dc_offset=30 + 20j)
    jd = JaxDemod(JaxConfig(block_len=L, **OQ))
    ref = _run(jd, x)
    d = StreamDemodulator(DemodConfig(block_len=L, **OQ), "cpu")
    got = _run(d, x)
    assert d.fallback_blocks == 0
    assert len(got) == len(ref) > 12 * L * SYMRATE / FS * 0.95
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    np.testing.assert_allclose(got["re"], ref["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], ref["im"], rtol=5e-4, atol=0.05)
    assert d.pll_locked and d.pll_locked == jd.pll_locked
    for get in ("carrier_freq_hz", "symbol_rate_hz"):
        assert getattr(d, get)() == pytest.approx(getattr(jd, get)(),
                                                  rel=5e-4, abs=1e-2), get


def test_flagged_block_replays_through_oracle_like_jax():
    """A set safety flag routes the single block to the numpy oracle, which
    both packages share; the younger in-flight blocks are re-dispatched from
    the oracle's carry (its slot and inphase included)."""
    x = _oqpsk(5 * L + 100, 80.0, seed=9, snr_db=25.0, dc_offset=30 + 20j)
    jd = JaxDemod(JaxConfig(block_len=L, **OQ))
    jd._carry = jd._carry._replace(flags=jd._carry.flags | FLAG_WINDOW_MISS)
    ref = _run(jd, x)
    d = StreamDemodulator(DemodConfig(block_len=L, **OQ), "cpu")
    d._carry.flags |= FLAG_WINDOW_MISS
    before = StreamDemodulator.replayed_blocks
    got = _run(d, x)
    assert d.fallback_blocks == jd.fallback_blocks == 1
    assert StreamDemodulator.replayed_blocks == before + 1
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got["locked_once"], ref["locked_once"])
    n_oracle = int(round(L * SYMRATE / FS)) - 8
    np.testing.assert_array_equal(got[:n_oracle], ref[:n_oracle])
    np.testing.assert_allclose(got["re"], ref["re"], rtol=5e-4, atol=0.05)
    np.testing.assert_allclose(got["im"], ref["im"], rtol=5e-4, atol=0.05)


@pytest.fixture(scope="module")
def oq_wav(tmp_path_factory):
    """A 16-bit 230.4 ksps OQPSK WAV and the port CLI's .s for it: 3 blocks
    and a tail. (The JAX CLI's FMA drift can move one gate tick after a few
    blocks, after which bytes differ by more than 1 — ROADMAP.md list C; on
    this fixture the two agree within 1.)"""
    d = tmp_path_factory.mktemp("oqcli")
    x = _oqpsk(3 * 8192 + 500, 200.0, seed=8, snr_db=20.0, dc_offset=0)
    wav, out = str(d / "oq.wav"), str(d / "oq.port.s")
    write_wav(wav, x, FS, 16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("METEOR_DEMOD_PLATFORM", "cpu")
        assert cli.main(["meteor_demod_tpu_torch", "-B", "-q", "-m", "oqpsk",
                         "-r", "80k", "-o", out, wav]) == 0
    return d, wav, np.fromfile(out, dtype=np.int8)


def test_cli_oqpsk_matches_jax_cli(oq_wav):
    d, wav, got = oq_wav
    ref_out = str(d / "oq.jax.s")
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-m", "meteor_demod_tpu", "-B",
                           "-q", "-m", "oqpsk", "-r", "80k", "-o", ref_out,
                           wav], capture_output=True, timeout=300, env=env,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr.decode()[-500:]
    ref = np.fromfile(ref_out, dtype=np.int8)
    # Same length: the same symbol count and the same lock gating.
    assert len(got) == len(ref) > 8000
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert float(np.mean(diff == 0)) >= 0.999
    assert 55 < np.mean(np.abs(got.astype(np.float32))) < 75


def test_cli_oqpsk_output_is_the_oracle_bitwise(oq_wav):
    """The CLI's .s bytes equal, bitwise, the numpy oracle run block by block
    on the port's FIR output, quantized and lock-gated by the writer."""
    _, wav, got = oq_wav
    with open(wav, "rb") as f:
        assert wav_parse(f) is not None
        x = np.concatenate(list(read_sample_blocks(f, 16)))
    cfg = DemodConfig(**OQ)
    Lc = cfg.block_len
    banks = torch.as_tensor(make_fir_banks(cfg))
    tail = torch.zeros((1, cfg.taps - 1, 2))
    st = port_scalar.initial_state(cfg)
    sink = io.BytesIO()
    writer = SymbolWriter(sink)
    for i in range(0, len(x), Lc):
        xb = x[i:i + Lc]
        F = None
        if len(xb) == Lc:
            Ft, tail = polyphase_fir_block(
                torch.from_numpy(iq_to_f32(xb))[None], tail, banks)
            F = f32_to_iq(Ft[:, :, 0].numpy()).reshape(Lc, cfg.interp)
        syms, st = port_scalar.demod_stream_np(cfg, xb, st, F=F)
        writer.feed(quantize_symbols(syms), syms["locked_once"])
    writer.flush_partial()
    np.testing.assert_array_equal(
        got, np.frombuffer(sink.getvalue(), dtype=np.int8))
