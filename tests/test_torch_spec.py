"""The port's spec layer (meteor_demod_tpu_torch: config, dsp, sim) held
bitwise against the JAX package, and the port's independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from meteor_demod_tpu import config as jax_config
from meteor_demod_tpu import sim as jax_sim
from meteor_demod_tpu.dsp import fir as jax_fir
from meteor_demod_tpu.dsp import loops as jax_loops
from meteor_demod_tpu.dsp import sincos as jax_sincos

from meteor_demod_tpu_torch import config as port_config
from meteor_demod_tpu_torch import sim as port_sim
from meteor_demod_tpu_torch.dsp import fir as port_fir
from meteor_demod_tpu_torch.dsp import loops as port_loops
from meteor_demod_tpu_torch.dsp import sincos as port_sincos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "qpsk": dict(samplerate=230400),
    "hifi": dict(samplerate=230400, rrc_order=64, interp=10),
    "pll_bw_0.5": dict(samplerate=230400, pll_bw=0.5),
    "pll_bw_2": dict(samplerate=230400, pll_bw=2.0),
}
DERIVED = ("taps", "osf", "pll_bw_eff", "pll_gains", "pll_fmax", "timing_freq",
           "timing_bw", "timing_gains", "timing_dev_max", "block_ticks",
           "fire_spacing", "ticks_per_fire", "fires_per_step", "ticks_per_step",
           "max_ticks_per_step", "gate_candidates", "steps_per_block")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_derived_config_fields_bitwise(name):
    jc = jax_config.DemodConfig(**CONFIGS[name])
    pc = port_config.DemodConfig(**CONFIGS[name])
    for field in DERIVED:
        assert _same(getattr(pc, field), getattr(jc, field)), field
    pc.validate()


@pytest.mark.parametrize("bad", [dict(samplerate=0), dict(symrate=-1.0),
                                 dict(samplerate=50000), dict(interp=0),
                                 dict(block_len=64)])
def test_validate_rejects_like_jax(bad):
    kw = dict(samplerate=230400, **{k: v for k, v in bad.items()
                                    if k != "samplerate"})
    kw["samplerate"] = bad.get("samplerate", 230400)
    with pytest.raises(ValueError) as je:
        jax_config.DemodConfig(**kw).validate()
    with pytest.raises(ValueError) as pe:
        port_config.DemodConfig(**kw).validate()
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_fir_banks_bitwise(name):
    jc = jax_config.DemodConfig(**CONFIGS[name])
    pc = port_config.DemodConfig(**CONFIGS[name])
    assert _same(port_fir.make_fir_banks(pc), jax_fir.make_fir_banks(jc))


def test_tanh_table_and_loop_gains_bitwise():
    assert _same(port_loops.TANH_TABLE, jax_loops.TANH_TABLE)
    for damp, bw in ((0.7071067811865475, 4.36e-5), (1.0, 1e-5)):
        assert _same(port_loops.loop_gains(damp, bw),
                     jax_loops.loop_gains(damp, bw))


def test_lut_tanh_bitwise():
    v = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.float32([-16.0, -15.999, 15.0, 15.5, -0.0])])
    table = torch.as_tensor(port_loops.TANH_TABLE)
    got = port_loops.lut_tanh(torch.from_numpy(v), table).numpy()
    assert _same(got, port_loops.lut_tanh_np(v))
    assert _same(got, np.asarray(jax_loops.lut_tanh(jnp.asarray(v))))


def _phase_codes() -> np.ndarray:
    """One float per 16-bit phase code, over two turns (so the wrap is
    exercised), plus the code boundaries themselves."""
    codes = np.arange(-65536, 65536, dtype=np.float64)
    scale = float(port_sincos._PHASE_SCALE)
    return np.concatenate([(codes + 0.5) / scale,
                           codes / scale]).astype(np.float32)


@pytest.mark.parametrize("fn", ["sin", "cos"])
def test_fast_sincos_all_phase_codes_bitwise(fn):
    fx = _phase_codes()
    codes = np.trunc(fx * port_sincos._PHASE_SCALE).astype(np.int64) & 0xFFFF
    assert len(np.unique(codes)) == 65536
    got = getattr(port_sincos, f"fast_{fn}")(torch.from_numpy(fx)).numpy()
    assert _same(got, getattr(port_sincos, f"fast_{fn}_np")(fx))
    assert _same(got, getattr(jax_sincos, f"fast_{fn}_np")(fx))
    assert _same(got, np.asarray(getattr(jax_sincos, f"fast_{fn}")(
        jnp.asarray(fx))))


def test_sim_bitwise():
    kw = dict(carrier_hz=300.0, amplitude=6000.0, snr_db=20.0, seed=3,
              dc_offset=12 - 5j)
    a, sa = port_sim.synth_psk(500, 230400, **kw)
    b, sb = jax_sim.synth_psk(500, 230400, **kw)
    assert _same(a, b) and _same(sa, sb)
    for bps in (8, 16, 32):
        assert port_sim.encode_iq(a, bps) == jax_sim.encode_iq(a, bps)


def test_port_imports_without_jax():
    """The port and its CLI import with jax and meteor_demod_tpu blocked,
    and every module of the port imports."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['meteor_demod_tpu'] = None\n"
        "import meteor_demod_tpu_torch, meteor_demod_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(meteor_demod_tpu_torch.__path__,\n"
        "                               'meteor_demod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib',\n"
        "       'meteor_demod_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
