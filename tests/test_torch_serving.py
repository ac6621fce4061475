"""The port's serving layer on the CPU: ServingFleet
(meteor_demod_tpu_torch/parallel/serving.py) against the JAX package's and
against plain FleetDemodulator groups; the serving host
(python -m meteor_demod_tpu_torch.serve_fleet) killed and resumed through a
subprocess; the card as every entry point's default device; and the new
modules' independence from JAX.

Mirrors tests/test_serving.py and tests/test_serve_fleet.py at a small size.
Against the JAX package: decisions bitwise, soft symbols within rtol=5e-4,
atol=0.05 (the tolerances of tests/test_torch_fleet.py).
"""

import dataclasses
import filecmp
import glob
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from meteor_demod_tpu.config import DemodConfig as JaxConfig
from meteor_demod_tpu.parallel.mesh import make_mesh
from meteor_demod_tpu.parallel.serving import ServingFleet as JaxServing
from meteor_demod_tpu.sim import synth_psk, write_raw, write_wav

from meteor_demod_tpu_torch import serve_fleet
from meteor_demod_tpu_torch.config import DemodConfig
from meteor_demod_tpu_torch.demod.backend import make_batch_demod
from meteor_demod_tpu_torch.demod.pipeline import (StreamDemodulator,
                                                   demod_array)
from meteor_demod_tpu_torch.demod.state import (batch_carry, carry_from_numpy,
                                                carry_to_numpy, init_carry)
from meteor_demod_tpu_torch.io.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
from meteor_demod_tpu_torch.io.wav import decode_iq
from meteor_demod_tpu_torch.parallel.mesh import FleetDemodulator
from meteor_demod_tpu_torch.parallel.serving import ServingFleet
from meteor_demod_tpu_torch.utils import select_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 1024
MODES = {
    "qpsk": dict(samplerate=230400),
    "oqpsk": dict(samplerate=240000, symrate=80000.0, oqpsk=True),
}


def _data(mode, n_streams, n_blocks):
    kw = MODES[mode]
    fs, symrate = kw["samplerate"], kw.get("symrate", 72000.0)
    n = n_blocks * L
    return np.stack([synth_psk(
        int(n * symrate / fs) + 64, fs, symrate=symrate,
        oqpsk=kw.get("oqpsk", False), carrier_hz=60.0 + 10.0 * i,
        amplitude=6000.0, snr_db=22.0, seed=600 + i)[0][:n]
        for i in range(n_streams)])


# ------------------------------------------- test_serving.py:42 and 88

@pytest.mark.parametrize("mode", list(MODES))
def test_serving_routes_in_caller_order(mode):
    """Each stream's rows come back in the caller's order, bitwise those of
    plain FleetDemodulator groups fed the same streams, under the initial
    assignment and under a permuted one; decisions match the JAX
    ServingFleet's."""
    cfg = DemodConfig(block_len=L, **MODES[mode])
    n_streams, group, n_blocks = 4, 2, 3
    data = _data(mode, n_streams, n_blocks)
    fleet = ServingFleet(cfg, n_streams, group_size=group, device="cpu")
    mixed = ServingFleet(cfg, n_streams, group_size=group, device="cpu")
    mixed._group_of = np.array([1, 0, 0, 1])
    mixed._lane_of = np.array([1, 0, 1, 0])
    assert fleet.assignment() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mixed.assignment() == [(1, 1), (0, 0), (0, 1), (1, 0)]
    refs = [FleetDemodulator(cfg, group, "cpu") for _ in range(2)]
    jfleet = JaxServing(JaxConfig(block_len=L, **MODES[mode]), n_streams,
                        group_size=group, mesh=make_mesh(jax.devices()[:1]),
                        backend="scan", park=False)
    rows = cfg.steps_per_block + (1 if cfg.oqpsk else 0)
    for b in range(n_blocks):
        blk = data[:, b * L:(b + 1) * L]
        got, got_mixed = fleet.process_blocks(blk), mixed.process_blocks(blk)
        want = [refs[g].process_blocks(blk[g * group:(g + 1) * group])
                for g in range(2)]
        jgot = jfleet.process_blocks(blk)
        assert got.valid.shape == (n_streams, rows)
        for f in dataclasses.fields(got):
            cat = np.concatenate([getattr(w, f.name) for w in want])
            np.testing.assert_array_equal(getattr(got, f.name), cat,
                                          err_msg=f"block {b} {f.name}")
            np.testing.assert_array_equal(getattr(got_mixed, f.name), cat,
                                          err_msg=f"block {b} {f.name}")
        for k in ("valid", "locked_once"):
            np.testing.assert_array_equal(getattr(got, k),
                                          np.asarray(getattr(jgot, k)))
        v = got.valid.astype(bool)
        for k in ("sym_re", "sym_im"):
            np.testing.assert_allclose(getattr(got, k)[v],
                                       np.asarray(getattr(jgot, k))[v],
                                       rtol=5e-4, atol=0.05)
    # The permuted fleet really ran stream 0 in group 1, lane 1.
    np.testing.assert_array_equal(
        carry_to_numpy(mixed.groups[1].carry)["t_phase"][1],
        carry_to_numpy(fleet.groups[0].carry)["t_phase"][0])


# ------------------------------------------------------ test_serving.py:212

def test_serving_rejects_bad_shapes():
    cfg = DemodConfig(samplerate=230400, block_len=L)
    with pytest.raises(ValueError, match="not divisible"):
        ServingFleet(cfg, 6, group_size=4, device="cpu")
    fleet = ServingFleet(cfg, 4, group_size=2, device="cpu",
                         chain_blocks=2)
    assert [f.chain_blocks for f in fleet.groups] == [2, 2]
    with pytest.raises(ValueError, match="expected 4 streams"):
        fleet.process_blocks(np.zeros((2, 2 * L), np.complex64))
    with pytest.raises(ValueError, match="expected"):
        fleet.process_blocks(np.zeros((4, L), np.complex64))
    with pytest.raises(TypeError):
        ServingFleet(cfg, 4, group_size=2, device="cpu", band=8)
    with pytest.raises(TypeError):
        FleetDemodulator(cfg, 4, "cpu", park=False)


# ------------------------------------------------------ the serving host

@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two 16-bit WAV passes that lock within a few blocks (carriers 80 and
    140 Hz); the first is shorter and ends inside a chain."""
    d = tmp_path_factory.mktemp("serve")
    paths = []
    for i, n in enumerate((int(8.5 * 2 * L), 12 * 2 * L)):
        x, _ = synth_psk(n // 3 + 64, 230400, carrier_hz=80.0 + 60.0 * i,
                         amplitude=6000.0, snr_db=22.0, seed=40 + i)
        paths.append(str(d / f"pass{i}.wav"))
        write_wav(paths[-1], x[:n], 230400, 16)
    return paths


def _host(wavs, out_dir, extra, timeout=240):
    """4 streams (two WAV files, a dead antenna and a synthesized pass) in
    one group, chains of 2 blocks of 1024, 12 chains of signal, to the
    longest. The host serves 13: a source learns that it has ended when a
    read comes back short, so one chain of the zero level follows the data
    (as in the JAX package's host)."""
    env = dict(os.environ, METEOR_DEMOD_PLATFORM="cpu", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "meteor_demod_tpu_torch.serve_fleet",
         "--inputs", *wavs, "--synth", "2", "--dead", "1", "--seconds",
         str(12 * 2 * L / 230400 + 1e-6), "--group-size", "4", "--block-len",
         str(L), "--chain", "2", "--status-every", "5", "--until",
         "longest", "--out-dir", out_dir] + extra,
        env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_serve_fleet_kill_resume_byte_identical(wavs, tmp_path):
    """A run stopped at chain 7 (after a periodic checkpoint at chain 5) and
    resumed from its checkpoint writes byte-identical .s files to the
    uninterrupted run: the fleet state, the writer rings in the side file,
    the .s truncation and the input seeks in chain units. A resume with the
    wrong --chain is refused before it touches an output."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    ckpt = str(tmp_path / "ck.npz")

    r = _host(wavs, a_dir, [])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "serving 4 streams on cpu" in r.stdout
    assert "13 chains served" in r.stdout and "chain 10: locked" in r.stdout
    assert "0 stream spans recovered" in r.stdout

    r = _host(wavs, b_dir, ["--checkpoint", ckpt, "--checkpoint-every", "5",
                            "--max-blocks", "7"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "checkpoint saved at chain 5" in r.stdout
    assert "checkpoint saved at chain 7" in r.stdout
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".writers.npz")

    sizes = {f: os.path.getsize(f) for f in glob.glob(b_dir + "/*.s")}
    r = _host(wavs, b_dir, ["--checkpoint", ckpt, "--resume", "--chain", "4"])
    assert r.returncode != 0
    assert "--chain" in (r.stderr + r.stdout)
    assert sizes == {f: os.path.getsize(f) for f in glob.glob(b_dir + "/*.s")}

    r = _host(wavs, b_dir, ["--checkpoint", ckpt, "--resume"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resumed at chain 7" in r.stdout and "13 chains served" in r.stdout

    a_files = sorted(glob.glob(a_dir + "/*.s"))
    assert len(a_files) == 4
    for a in a_files:
        b = os.path.join(b_dir, os.path.basename(a))
        assert filecmp.cmp(a, b, shallow=False), os.path.basename(a)
    # The two WAV passes locked: whole rings were written, and the short
    # pass stopped at its own end (its post-EOF chains are dropped). (The
    # dead antenna's noise can trip the lock detector late in the run, so
    # its size says nothing.)
    size = [os.path.getsize(f) for f in a_files]
    assert size[1] > size[0] > 4 * 1024


def test_serve_fleet_refuses_without_card_or_streams(tmp_path):
    """With no card and METEOR_DEMOD_PLATFORM unset the host exits non-zero
    instead of serving on the CPU; a stream count that does not fill its
    groups is refused."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("METEOR_DEMOD_PLATFORM", None)
    cmd = [sys.executable, "-m", "meteor_demod_tpu_torch.serve_fleet",
           "--synth", "3", "--seconds", "0.01", "--block-len", str(L),
           "--group-size", "2", "--out-dir", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=120, cwd=REPO)
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
    r = subprocess.run(cmd, env=dict(env, METEOR_DEMOD_PLATFORM="cpu"),
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode != 0 and "multiple of --group-size" in r.stderr
    assert not os.path.exists(tmp_path / "o")


def test_file_source_pads_partial_tail(tmp_path):
    """The host's file source, as the JAX package's: a final read that the
    file fills only in part is padded with the format's zero level, not
    dropped, and the source is done from then on; raw-ingest mode returns
    the file's integer pairs undecoded (128 the zero level of 8-bit)."""
    x, _ = synth_psk(200, 230400, carrier_hz=50.0, amplitude=90.0, seed=1)
    x = x[:600]
    wav, raw = str(tmp_path / "a.wav"), str(tmp_path / "a.raw")
    write_wav(wav, x * 60, 230400, 16)
    write_raw(raw, x, 8)
    src = serve_fleet._FileSource(wav, 256, 230400, 16)
    a = src.next_block()
    assert a.dtype == np.complex64 and a.shape == (256,) and not src.done
    b, c, d = (src.next_block() for _ in range(3))
    np.testing.assert_array_equal(
        np.concatenate([a, b, c])[:600],
        decode_iq(open(wav, "rb").read()[44:], 16))
    assert src.done and not c[600 - 512:].any() and not d.any()
    src.seek_blocks(1)
    assert not src.done
    np.testing.assert_array_equal(src.next_block(), b)
    src.seek_blocks(3)
    assert src.done
    src.close()
    with pytest.raises(SystemExit, match="samplerate"):
        serve_fleet._FileSource(wav, 256, 48000, 16)

    src = serve_fleet._FileSource(raw, 256, 230400, 8)
    src.raw_dtype, src.raw_pad = np.uint8, 128
    blocks = [src.next_block() for _ in range(3)]
    assert blocks[0].dtype == np.uint8 and blocks[0].shape == (256, 2)
    np.testing.assert_array_equal(
        np.concatenate(blocks)[:600].reshape(-1),
        np.frombuffer(open(raw, "rb").read(), np.uint8))
    assert src.done and (blocks[2][600 - 512:] == 128).all()
    src.close()


# ------------------------------------------- the card is the default device

def test_default_device_is_the_card(monkeypatch, tmp_path):
    """device=None means the card: where there is none and
    METEOR_DEMOD_PLATFORM is unset every entry point raises instead of
    running on the CPU; with the variable set to cpu they give the CPU."""
    cfg = DemodConfig(samplerate=230400, block_len=L)
    ckpt = str(tmp_path / "s.npz")
    save_checkpoint(ckpt, StreamDemodulator(cfg, "cpu"))
    leaves = carry_to_numpy(batch_carry(cfg, 2, "cpu"))
    entry_points = {
        "select_device": lambda: select_device(),
        "batch_carry": lambda: batch_carry(cfg, 2).t_phase.device,
        "init_carry": lambda: init_carry(cfg).t_phase.device,
        "carry_from_numpy": lambda: carry_from_numpy(leaves).slot.device,
        "make_batch_demod": lambda: make_batch_demod(cfg, 1)(
            batch_carry(cfg, 1), torch.zeros((1, L, 2), device=select_device())
        )[1].valid.device,
        "StreamDemodulator": lambda: StreamDemodulator(cfg).device,
        "demod_array": lambda: (demod_array(cfg, np.zeros(8, np.complex64)),
                                select_device())[1],
        "FleetDemodulator": lambda: FleetDemodulator(cfg, 4).device,
        "ServingFleet": lambda: ServingFleet(cfg, 4, group_size=2).device,
        "load_checkpoint": lambda: load_checkpoint(ckpt).device,
    }
    monkeypatch.delenv("METEOR_DEMOD_PLATFORM", raising=False)
    for name, call in entry_points.items():
        if torch.cuda.is_available():
            assert call().type == "cuda", name
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "cpu")
    for name, call in entry_points.items():
        assert call().type == "cpu", name
    assert select_device("cpu").type == "cpu"       # a given device is kept
    monkeypatch.setenv("METEOR_DEMOD_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="use cpu or cuda"):
        StreamDemodulator(cfg)


# ------------------------------------------------------------------ no JAX

def test_fleet_modules_run_without_jax(tmp_path):
    """The fleet, checkpoint and serving modules import and run with jax and
    meteor_demod_tpu blocked."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['meteor_demod_tpu'] = None\n"
        "import numpy as np\n"
        "from meteor_demod_tpu_torch import serve_fleet\n"
        "from meteor_demod_tpu_torch.config import DemodConfig\n"
        "from meteor_demod_tpu_torch.io import checkpoint\n"
        "from meteor_demod_tpu_torch.parallel import mesh, serialize, serving\n"
        "cfg = DemodConfig(samplerate=230400, block_len=1024)\n"
        "f = serving.ServingFleet(cfg, 2, group_size=1, device='cpu',\n"
        "                         packed_output=True)\n"
        "f.process_blocks(np.zeros((2, 1024), np.complex64))\n"
        f"checkpoint.save_serving_checkpoint({str(tmp_path / 'c.npz')!r}, f)\n"
        f"checkpoint.load_serving_checkpoint({str(tmp_path / 'c.npz')!r},\n"
        "                                   'cpu')\n"
        "bad = [m for m in sys.modules if m.startswith(('jax.', 'jaxlib',\n"
        "       'meteor_demod_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
