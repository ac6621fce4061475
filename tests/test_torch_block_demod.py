"""The port's QPSK recurrence (meteor_demod_tpu_torch/kernels/block_demod.py)
held against the JAX package on identical inputs.

Fixture: 4 streams (three QPSK with different carriers and DC offsets, one
noise-only so the unlocked sweep runs), block_len 1024, 2 chained blocks
after WARM blocks of JAX-scan warm-up, so that the carrier locks inside the
blocks under test. Each block's FIR output comes from the JAX package's
tick-major FIR, so the port's recurrence consumes exactly the ticks the JAX
scan and the Pallas kernel consume, and each block starts from the JAX
carry converted through carry_from_numpy.

Contracts (tests/test_pallas_kernel.py, tests/test_scan_vs_oracle.py):
- vs the JAX scan and the interpret-mode Pallas kernel: decisions (valid,
  locked_once, integer carry leaves) bitwise; symbols within rtol=5e-4,
  atol=0.05 and float carry within rtol=5e-4, atol=1e-3, because XLA may
  contract a multiply and an add into an FMA where the port rounds twice;
- vs the numpy oracle fed the same F: bitwise, values included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.demod import scalar as jax_scalar
from meteor_demod_tpu.demod.scan import make_block_demod
from meteor_demod_tpu.demod.state import batch_carry as jax_batch_carry
from meteor_demod_tpu.demod.state import carry_to_numpy as jax_carry_to_numpy
from meteor_demod_tpu.dsp.fir import (make_fir_banks as jax_banks,
                                      polyphase_fir_block_tmajor)
from meteor_demod_tpu.kernels.block_demod import make_pallas_batch_demod
from meteor_demod_tpu.sim import synth_psk

from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod import scalar as port_scalar
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import numpy_carry_to_scalar_state
from meteor_demod_tpu_torch.demod.state import (CARRY_FIELDS,
                                                carry_from_numpy,
                                                carry_to_numpy)
from meteor_demod_tpu_torch.dsp.fir import f32_to_iq, iq_to_f32
from meteor_demod_tpu_torch.kernels.block_demod import (block_demod,
                                                        block_demod_torch)

B = 4
N_BLOCKS = 2
WARM = 8          # ~2600 symbols: the lock EMA settles in blocks 8-9
L = 1024
_OUT = ("sym_re", "sym_im", "valid", "locked_once")


def _streams(n: int) -> np.ndarray:
    xs = [synth_psk(n // 3 + 64, 230400, carrier_hz=60.0 + 20 * b,
                    amplitude=6000.0, snr_db=22.0, seed=b,
                    dc_offset=25 - 10j)[0][:n] for b in range(B - 1)]
    rng = np.random.default_rng(7)
    xs.append((1500 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
               ).astype(np.complex64))
    return np.stack(xs)


@pytest.fixture(scope="module")
def fx():
    jcfg = JaxConfig(samplerate=230400, block_len=L)
    cfg = DemodConfig(samplerate=230400, block_len=L)
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
        c, o = block_demod_torch(cfg, carry_from_numpy(blk["entry"]),
                                 torch.tensor(blk["Ft"]))
        port.append((carry_to_numpy(c),
                     {k: getattr(o, k).numpy() for k in _OUT}))
    return dict(cfg=cfg, jcfg=jcfg, xf=xf, blocks=blocks, port=port)


def _assert_decisions_and_values(got, ref, what):
    (gc, go), (rc, ro) = got, ref
    np.testing.assert_array_equal(go["valid"], ro["valid"], err_msg=what)
    np.testing.assert_array_equal(go["locked_once"], ro["locked_once"],
                                  err_msg=what)
    m = ro["valid"].astype(bool)
    assert m.sum() > 4 * 250
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


def test_fixture_exercises_lock_and_sweep(fx):
    entry = fx["blocks"][0]["entry"]
    c, _ = fx["port"][-1]
    assert not entry["locked_once"].any()      # unlocked on entry ...
    assert c["locked_once"][:B - 1].all()      # ... the three signals lock
    assert not c["locked_once"][B - 1]         # noise never locks
    assert (c["flags"] == 0).all()


def test_plain_chained_matches_jax(fx):
    """The port carries its own carry across the blocks."""
    cfg = fx["cfg"]
    carry = carry_from_numpy(fx["blocks"][0]["entry"])
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
    IS the numpy oracle: every symbol and every state leaf bitwise."""
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


def test_carry_round_trip_bitwise(fx):
    for blk in fx["blocks"]:
        d = blk["scan"][0]
        back = carry_to_numpy(carry_from_numpy(d))
        assert list(back) == list(d)
        for k in d:
            assert back[k].dtype == d[k].dtype, k
            np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_wrapper_on_cpu_runs_plain(fx):
    """The kernel wrapper takes the plain path for a CPU tensor, and does
    not count it as a launch."""
    cfg, blk = fx["cfg"], fx["blocks"][0]
    before = block_demod.launches
    c, o = block_demod(cfg, carry_from_numpy(blk["entry"]),
                       torch.tensor(blk["Ft"]))
    assert block_demod.launches == before
    pc, po = fx["port"][0]
    for k in _OUT:
        np.testing.assert_array_equal(getattr(o, k).numpy(), po[k])
    for k, v in carry_to_numpy(c).items():
        if k != "fir_tail":
            np.testing.assert_array_equal(v, pc[k], err_msg=k)


def test_backend_matches_jax_scan(fx):
    """make_batch_demod (the port's own FIR, then the recurrence) chained
    over both blocks against the JAX scan: decisions bitwise, values within
    the contract plus the FIR's float32 rounding (~1e-5 relative)."""
    cfg = fx["cfg"]
    fn = make_batch_demod(cfg, B, "cpu")
    carry = carry_from_numpy(fx["blocks"][0]["entry"])
    for i, blk in enumerate(fx["blocks"]):
        carry, out = fn(carry, torch.tensor(blk["x"]))
        got = (carry_to_numpy(carry), {k: getattr(out, k).numpy()
                                       for k in _OUT})
        _assert_decisions_and_values(got, blk["scan"], f"backend block {i}")
        np.testing.assert_allclose(got[0]["fir_tail"],
                                   blk["scan"][0]["fir_tail"], rtol=0, atol=0)
